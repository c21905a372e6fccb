"""The (data, model) mesh on torch.distributed (port of
weathermodel_tpu/parallel/mesh.py: the data, expert, tensor and fully-sharded
data parallel layouts).

`world = n_data x n_model` ranks, one process each (parallel/multihost.py).
Rank r sits at (r // n_model, r % n_model), the row-major reshape that JAX's
`make_mesh` gives its devices. The data group joins the ranks of one model
index, the model group the ranks of one data index.

* Data parallelism over 'data': every rank builds the same global batch from
  the same loader and seed and keeps the rows of its data index
  (`shard_batch`); the train step divides by the global batch's normalizers
  and sums the gradients over the data group (train/steps.py). This is the
  JAX package's single-host semantics, in which a mesh run draws what a
  one-process run draws.
* Parameter storage follows JAX's sharding rules, mapped to the port's
  torch [out, in] layout (`combined_sharding_rules`; `shard_params` keeps a
  rank's block of each split parameter, before the optimizer is made, so
  Adam's moments are blocks too):
  - over 'model' (`--tensor-parallel`): the Megatron column/row split of
    the attention and FFN weights, and the expert dim of the MoE experts;
  - over 'data' (`--fsdp`, ZeRO-3): each parameter of at least
    FSDP_MIN_ELEMS entries along its largest other divisible axis.
* Compute: the experts run where they are stored (expert parallelism:
  models/moe.py runs each rank's experts and sums the ranks' outputs with
  `reduce_from_model`). Every other split is gathered whole for its op by
  `_GatherParam` inside the forward of the module that uses it (`gathered`:
  an encoder layer gathers its own, the train step the rest), so under
  `--remat` a layer's full weights live only during its forward and its
  recompute. Its backward sums the gradient over 'data' and keeps the
  rank's block (a reduce-scatter), and `all_reduce_grads` skips those
  parameters. The JAX package cannot partition its attention kernels
  either: GSPMD gathers their weights and replicates their compute over
  'model', as the port does.

Only `all_reduce` runs on device tensors (with `broadcast`, the collectives
gloo takes for CUDA tensors, and ranks that share one card use gloo); a
gather is an all_reduce of a zero-padded buffer and a reduce-scatter an
all_reduce and a slice. A group of one rank is None and its collectives are
the identity.

`copy_to_model` and `reduce_from_model` are the Megatron pair of autograd
functions: identity forward and a sum over the model group backward, and
the reverse. `torch.distributed.nn.functional.all_reduce` is not the
combine: its backward sums the gradient again, which on replicated
cotangents gives n_model times the gradient.
"""

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_data: int
    n_model: int
    rank: int = 0
    data_group: Optional[object] = None    # None: a group of one rank
    model_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The 2-D (data, model) mesh over the process group's ranks; by
    default every rank on 'data' (pure DP). Every rank must call it (it
    creates the groups)."""
    world = world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices")
    rank = dist.get_rank() if dist.is_initialized() else 0
    data_group = model_group = None
    # every rank creates every group, in one order
    if n_data > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == rank % n_model:
                data_group = g
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == rank // n_model:
                model_group = g
    return Mesh(n_data, n_model, rank, data_group, model_group)


# the mesh of the step being run (train/steps.py sets it around each
# forward), read by the layers that need batch-global statistics
_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def activate(mesh: Optional[Mesh]):
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = before


def active() -> Optional[Mesh]:
    return _ACTIVE


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of `t` over `group` (the identity for None)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def data_total(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data group, detached: a global normalizer."""
    if mesh is None or mesh.data_group is None:
        return t
    return all_reduce_(t.detach().clone(), mesh.data_group)


def data_sum_with_local_grad(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the data group, whose gradient flows to this
    rank's `t` only: the value is the all-reduced total exactly, and summing
    the ranks' gradients (train/steps.py) gives the gradient of the global
    quantity."""
    total = data_total(mesh, t)
    return total + (t - t.detach())


def data_rows(mesh: Optional[Mesh], b: int) -> slice:
    """Rows [i * b / n_data, (i + 1) * b / n_data) of a batch of b rows: this
    rank's data index i's shard (all of them without a mesh)."""
    if mesh is None:
        return slice(None)
    if b % mesh.n_data:
        raise ValueError(f"batch of {b} rows does not split over the mesh "
                         f"'data' axis ({mesh.n_data})")
    n = b // mesh.n_data
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def shard_batch(mesh: Optional[Mesh], x):
    """This rank's rows of the batch-major `x` (None stays None)."""
    return None if x is None else x[data_rows(mesh, x.shape[0])]


def param_sharding_rules(path: str, shape, mesh: Mesh) -> tuple:
    """The tensor-parallel layout of a parameter, keyed on its name, as a
    partition spec: a tuple with MODEL_AXIS at the split dims (JAX
    `param_sharding_rules`, parallel/mesh.py:98-132). With n_model == 1
    everything is replicated, ().
      self_attn.in_proj_* / linear1: split the output dim (torch [out, in]:
        dim 0)                                  -> (MODEL_AXIS, None)
      self_attn.out_proj / linear2 weights: split the input dim
                                                -> (None, MODEL_AXIS)
      expert_* (MoE): split the leading expert dim -> (MODEL_AXIS,)
      everything else: replicated."""
    if mesh.shape[MODEL_AXIS] == 1:
        return ()
    if "expert_" in path:
        if shape[0] % mesh.shape[MODEL_AXIS] != 0:
            # silent replication would quietly disable the expert
            # parallelism (and its memory scaling)
            raise ValueError(
                f"num_experts={shape[0]} not divisible by the mesh "
                f"'model' axis ({mesh.shape[MODEL_AXIS]}); pick "
                "--moe-experts as a multiple of --tensor-parallel")
        return (MODEL_AXIS,)
    column = "self_attn.in_proj_" in path or "linear1" in path
    if len(shape) == 2:
        if column:
            return (MODEL_AXIS, None)
        if ("self_attn" in path and "out_proj" in path) or "linear2" in path:
            return (None, MODEL_AXIS)
    if len(shape) == 1 and column:
        return (MODEL_AXIS,)
    return ()


# Params smaller than this stay replicated under FSDP: sharding LayerNorm
# scales/biases buys nothing and costs gather latency (JAX mesh.py:135-137).
FSDP_MIN_ELEMS = 2 ** 14


def _jax_dims(path: str, ndim: int) -> list:
    """The port's dim of each axis of the JAX leaf: a Linear's or conv's
    `weight` is the flax kernel with its axes reversed (torch [out, in]
    against flax [in, out], models/transfer.py); every other parameter
    (biases, norms, the MoE expert weights, the priors) keeps JAX's
    layout."""
    if ndim >= 2 and path.endswith("weight") and "expert_" not in path:
        return list(range(ndim))[::-1]
    return list(range(ndim))


def _full_spec(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def _fill_data_axis(path: str, spec, shape, mesh: Mesh,
                    min_elems: int) -> tuple:
    """Shard the largest still-unsharded divisible axis over 'data' (JAX
    `_fill_data_axis`, mesh.py:140-152). The axes are ranked in JAX's
    layout, ties kept in JAX's axis order by the stable sort, so a square
    weight transposed into the port's layout splits the dim JAX splits."""
    n = mesh.shape[DATA_AXIS]
    if n == 1 or int(np.prod(shape)) < min_elems:
        return tuple(spec)
    full = _full_spec(spec, len(shape))
    dims = _jax_dims(path, len(shape))
    for j in sorted(range(len(shape)), key=lambda j: -shape[dims[j]]):
        d = dims[j]
        if full[d] is None and shape[d] % n == 0:
            full[d] = DATA_AXIS
            return tuple(full)
    return tuple(spec)  # no divisible axis: unchanged


def fsdp_sharding_rules(path: str, shape, mesh: Mesh,
                        min_elems: int = FSDP_MIN_ELEMS) -> tuple:
    """The fully-sharded data-parallel (ZeRO-3) layout: every parameter of
    at least `min_elems` entries split along its largest divisible axis
    over 'data' (JAX `fsdp_sharding_rules`, mesh.py:155-164)."""
    return _fill_data_axis(path, (), shape, mesh, min_elems)


def combined_sharding_rules(path: str, shape, mesh: Mesh,
                            fsdp: bool = False) -> tuple:
    """The tensor-parallel rules first; with `fsdp` the largest other
    divisible axis over 'data' (2-D sharding; JAX
    `combined_sharding_rules`, mesh.py:167-176)."""
    tp = param_sharding_rules(path, shape, mesh)
    if not fsdp:
        return tp
    return _fill_data_axis(path, tp, shape, mesh, FSDP_MIN_ELEMS)


def _axis(mesh: Mesh, axis: str):
    """(size, this rank's index, group) of a mesh axis."""
    if axis == DATA_AXIS:
        return mesh.n_data, mesh.data_index, mesh.data_group
    return mesh.n_model, mesh.model_index, mesh.model_group


def is_split(spec) -> bool:
    return any(a is not None for a in spec)


def local_shape(shape, spec, mesh: Mesh) -> tuple:
    """The shape of a rank's shard of a tensor of `shape` under `spec`."""
    return tuple(n if a is None else n // _axis(mesh, a)[0]
                 for n, a in zip(shape, _full_spec(spec, len(shape))))


def local_slice(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the full tensor `t` under `spec`: along each
    split dim, the chunk of its index on that dim's axis."""
    for d, a in enumerate(_full_spec(spec, t.dim())):
        if a is not None:
            n, i, _ = _axis(mesh, a)
            t = t.narrow(d, i * (t.shape[d] // n), t.shape[d] // n)
    return t


def gather(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor of a rank's shard `t` under `spec`: for each split
    dim, 'data' first, an all_reduce over that axis's group of a
    zero-padded buffer holding the shard at its index (every entry is one
    rank's value plus zeros, so the gather is exact, but -0.0 comes back
    as 0.0)."""
    full = _full_spec(spec, t.dim())
    for axis in (DATA_AXIS, MODEL_AXIS):
        if axis not in full:
            continue
        d = full.index(axis)
        n, i, group = _axis(mesh, axis)
        if n == 1:
            continue
        shape = list(t.shape)
        shape[d] *= n
        buf = t.new_zeros(shape)
        buf.narrow(d, i * t.shape[d], t.shape[d]).copy_(t)
        t = all_reduce_(buf, group)
    return t


class _GatherParam(torch.autograd.Function):
    """A stored shard gathered whole for its op. The backward sums the
    full gradient over 'data' when the spec splits over 'data' (each data
    rank's is its own rows' part) and keeps this rank's block: a
    reduce-scatter as an all_reduce and a slice. Over 'model' it only
    slices: the model ranks compute the dense layers on the same rows, so
    their gradients are one and the same."""

    @staticmethod
    def forward(ctx, shard, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return gather(shard, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        if DATA_AXIS in ctx.spec and ctx.mesh.data_group is not None:
            g = all_reduce_(g.contiguous().clone(), ctx.mesh.data_group)
        return local_slice(g, ctx.spec, ctx.mesh).contiguous(), None, None


def _forward_spec(path: str, spec) -> tuple:
    """What a stored parameter is gathered over for its op: every split,
    but the expert dim of the expert weights over 'model', which expert
    parallelism computes on where it is stored (models/moe.py)."""
    if "expert_" in path:
        spec = tuple(None if a == MODEL_AXIS else a for a in spec)
    return tuple(spec) if is_split(spec) else ()


# a module that gathers its own stored shards in its forward (an encoder
# layer, models/blocks.py) sets this; `gathered` on an ancestor skips it
GATHERS_OWN = "gathers_own_shards"
# the attribute on a module that holds shards: {attribute: forward spec}
_SHARDS = "_shard_specs"


def _owners(module: torch.nn.Module):
    if getattr(module, _SHARDS, None):
        yield module
    for child in module.children():
        if not getattr(child, GATHERS_OWN, False):
            yield from _owners(child)


@contextlib.contextmanager
def gathered(module: torch.nn.Module):
    """Within the block, each stored shard of `module` and of its
    submodules (but those that gather their own) reads as the full
    parameter, gathered by `_GatherParam` on the active mesh; after it,
    the shards are back. Without shards, nothing happens."""
    owners = list(_owners(module))
    if not owners:
        yield
        return
    mesh = _ACTIVE
    if mesh is None:
        raise RuntimeError("a module holding parameter shards ran with no "
                           "mesh active (parallel.mesh.activate)")
    swapped = []
    try:
        for owner in owners:
            for attr, spec in getattr(owner, _SHARDS).items():
                shard = owner._parameters[attr]
                swapped.append((owner, attr, shard))
                owner._parameters[attr] = _GatherParam.apply(shard, spec,
                                                             mesh)
        yield
    finally:
        for owner, attr, shard in swapped:
            owner._parameters[attr] = shard


def shard_params(model: torch.nn.Module, mesh: Mesh,
                 fsdp: bool = False) -> dict:
    """Keep this rank's block of each parameter `combined_sharding_rules`
    splits, in place (JAX `shard_params`, mesh.py:179-196): the Megatron
    split of the dense weights and the expert split over 'model', with
    `fsdp` the largest other axis over 'data'. The optimizer is made after,
    so its state is the shards' too. A shard whose op does not run where it
    is stored is gathered for each forward (`gathered`). Returns {name:
    spec} of the split parameters (names of the full model)."""
    specs = {}
    for name, p in list(model.named_parameters()):
        spec = tuple(combined_sharding_rules(name, p.shape, mesh, fsdp=fsdp))
        if not is_split(spec):
            continue
        specs[name] = spec
        parent, _, attr = name.rpartition(".")
        owner = model.get_submodule(parent)
        setattr(owner, attr, torch.nn.Parameter(
            local_slice(p.detach(), spec, mesh).clone()))
        gspec = _forward_spec(name, spec)
        if gspec:
            owner.__dict__.setdefault(_SHARDS, {})[attr] = gspec
    return specs


def data_reduced(model: torch.nn.Module) -> set:
    """The ids of the parameters whose gradient `_GatherParam` already
    summed over 'data'."""
    return {id(owner._parameters[attr])
            for owner in model.modules()
            for attr, spec in getattr(owner, _SHARDS, {}).items()
            if DATA_AXIS in spec}


def gather_params(state: dict, specs: dict, mesh: Mesh) -> dict:
    """`state` (a state dict) with each entry of `specs` gathered whole:
    the inverse of `shard_params`, on every rank (a collective)."""
    return {k: gather(v, specs[k], mesh) if k in specs else v
            for k, v in state.items()}


def slice_params(state: dict, specs: dict, mesh: Mesh) -> dict:
    """`state` with each entry of `specs` cut to this rank's block (a full
    state dict loaded into a sharded model)."""
    return {k: local_slice(v, specs[k], mesh).clone() if k in specs else v
            for k, v in state.items()}


def _optimizer_map(model, specs: dict, fn):
    index = {i: specs[name]
             for i, (name, _) in enumerate(model.named_parameters())
             if name in specs}

    def apply(opt_state: dict) -> dict:
        state = {}
        for i, entry in opt_state["state"].items():
            spec = index.get(int(i))
            if spec is not None:
                entry = {k: fn(v, spec) if isinstance(v, torch.Tensor)
                         and v.dim() else v for k, v in entry.items()}
            state[i] = entry
        return dict(opt_state, state=state)

    return apply


def gather_optimizer_state(opt_state: dict, model, specs: dict, mesh: Mesh):
    """An optimizer state dict with the per-parameter tensors (Adam's
    moments) of the split parameters gathered whole."""
    return _optimizer_map(model, specs,
                          lambda v, spec: gather(v, spec, mesh))(opt_state)


def slice_optimizer_state(opt_state: dict, model, specs: dict, mesh: Mesh):
    """The inverse of `gather_optimizer_state`."""
    return _optimizer_map(
        model, specs,
        lambda v, spec: local_slice(v, spec, mesh).clone())(opt_state)


def stored_elements(model: torch.nn.Module, optimizer=None) -> dict:
    """The entries this rank stores: its parameters and the optimizer's
    per-parameter tensors (Adam's two moments)."""
    params = sum(p.numel() for p in model.parameters())
    state = 0
    if optimizer is not None:
        state = sum(v.numel() for entry in optimizer.state.values()
                    for v in entry.values()
                    if isinstance(v, torch.Tensor) and v.dim())
    return {"params": params, "optimizer": state}


def expected_elements(shapes: dict, specs: dict, mesh: Mesh) -> int:
    """The parameter entries a rank holds by the rules: each parameter of
    the full model ({name: shape}) at its block's shape under its spec."""
    return sum(int(np.prod(local_shape(shape, specs.get(name, ()), mesh)))
               for name, shape in shapes.items())


def all_reduce_grads(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum the gradients of `model`'s parameters over the data group, as
    one flat buffer (a parameter without a gradient counts as zeros),
    skipping the shards `_GatherParam` already summed."""
    if mesh.data_group is None:
        return
    skip = data_reduced(model)
    params = [p for p in model.parameters() if id(p) not in skip]
    if not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce_(flat, mesh.data_group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


def _sum_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return all_reduce_(x.contiguous().clone(), mesh.model_group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_model(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum_model(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward; backward the sum of the cotangent over the model
    group (each rank's is the part of its own experts' rows)."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the model group forward; identity backward (the
    cotangent of the sum is the same on every rank)."""
    return _ReduceFromModel.apply(x, mesh)


def all_reduce_flag(flag: bool, device) -> bool:
    """True if any rank of the default group has `flag` set: the agreement
    on a stop at a step boundary, so that no rank enters a collective
    alone."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t)
    return bool(t.item() > 0)
