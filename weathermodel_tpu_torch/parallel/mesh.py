"""The (data, model) mesh on torch.distributed (port of
weathermodel_tpu/parallel/mesh.py:1-214 for the data and expert parallel
layouts).

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
* Expert parallelism over 'model': the MoE expert weights split their expert
  dim over the model group (`param_sharding_rules`' `expert_*` rule,
  `shard_params`); models/moe.py runs each rank's experts on its own rows and
  sums the ranks' outputs (`reduce_from_model`).
* Dense parameters stay replicated over 'model'. `param_sharding_rules` also
  gives the Megatron column/row split of the attention and FFN weights (in
  the port's torch [out, in] layout), but the JAX package cannot partition
  its attention kernels either and replicates their compute; the port keeps
  their storage whole too (ROADMAP.md queue A item 14).

Only `all_reduce` runs on device tensors (with `broadcast`, the collectives
gloo takes for CUDA tensors, and ranks that share one card use gloo); a
gather is an all_reduce of a zero-padded buffer. A group of one rank is None and
its collectives are the identity.

`copy_to_model` and `reduce_from_model` are the Megatron pair of autograd
functions: identity forward and a sum over the model group backward, and
the reverse. `torch.distributed.nn.functional.all_reduce` is not the
combine: its backward sums the gradient again, which on replicated
cotangents gives n_model times the gradient.
"""

import contextlib
import dataclasses
from typing import Optional

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
      everything else: replicated.
    The port applies the expert rule only (`shard_params`)."""
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


def _expert_slice(mesh: Mesh, n: int) -> slice:
    e_loc = n // mesh.n_model
    return slice(mesh.model_index * e_loc, (mesh.model_index + 1) * e_loc)


def sharded_names(model: torch.nn.Module, mesh: Mesh) -> list:
    """The parameters `shard_params` splits: those the rules give the expert
    split (names of the full model)."""
    return [name for name, p in model.named_parameters()
            if param_sharding_rules(name, p.shape, mesh) == (MODEL_AXIS,)
            and "expert_" in name]


def shard_params(model: torch.nn.Module, mesh: Mesh) -> list:
    """Keep this rank's slice of each expert parameter (its model index's
    E / n_model experts), in place; the optimizer is made after, so its
    state is local too. Returns the split parameters' names."""
    names = sharded_names(model, mesh)
    for name in names:
        parent, _, attr = name.rpartition(".")
        module = model.get_submodule(parent)
        p = getattr(module, attr)
        local = p.detach()[_expert_slice(mesh, p.shape[0])].clone()
        setattr(module, attr, torch.nn.Parameter(local))
    return names


def gather_expert(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full [E, ...] tensor of a rank's expert slice [E / n_model, ...]:
    an all_reduce over the model group of a zero-padded buffer."""
    if mesh.n_model == 1:
        return t
    e_loc = t.shape[0]
    full = t.new_zeros(e_loc * mesh.n_model, *t.shape[1:])
    full[mesh.model_index * e_loc:(mesh.model_index + 1) * e_loc] = t
    return all_reduce_(full, mesh.model_group)


def gather_params(state: dict, names, mesh: Mesh) -> dict:
    """`state` (a state dict) with each entry of `names` gathered whole:
    the inverse of `shard_params`, on every rank of a model group."""
    names = set(names)
    return {k: gather_expert(v, mesh) if k in names else v
            for k, v in state.items()}


def slice_params(state: dict, names, mesh: Mesh) -> dict:
    """`state` with each entry of `names` cut to this rank's expert slice
    (a full state dict loaded into a sharded model)."""
    names = set(names)
    return {k: v[_expert_slice(mesh, v.shape[0])] if k in names else v
            for k, v in state.items()}


def _optimizer_map(model, names, fn):
    index = {name: i for i, (name, _) in enumerate(model.named_parameters())}
    targets = {index[name] for name in names}

    def apply(opt_state: dict) -> dict:
        state = {}
        for i, entry in opt_state["state"].items():
            if int(i) in targets:
                entry = {k: fn(v) if isinstance(v, torch.Tensor) and v.dim()
                         else v for k, v in entry.items()}
            state[i] = entry
        return dict(opt_state, state=state)

    return apply


def gather_optimizer_state(opt_state: dict, model, names, mesh: Mesh):
    """An optimizer state dict with the per-parameter tensors (Adam's
    moments) of the split parameters gathered whole."""
    return _optimizer_map(model, names,
                          lambda v: gather_expert(v, mesh))(opt_state)


def slice_optimizer_state(opt_state: dict, model, names, mesh: Mesh):
    """The inverse of `gather_optimizer_state`."""
    return _optimizer_map(
        model, names,
        lambda v: v[_expert_slice(mesh, v.shape[0])])(opt_state)


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum the gradients of `params` over the data group, as one flat
    buffer (a parameter without a gradient counts as zeros)."""
    if mesh.data_group is None:
        return
    params = list(params)
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
