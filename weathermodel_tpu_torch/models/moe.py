"""Mixture-of-Experts FFN (port of weathermodel_tpu/models/moe.py).

A drop-in replacement for the dense FFN half of the encoder layer: router ->
top-k -> dispatch -> per-expert linear1 -> ReLU -> dropout -> linear2 ->
combine -> gate-weighted sum over the k choices. The residual and post-LN
tail stay in the caller (models/blocks.py).

* Router: an fp32 Linear(H, E) on x.float(), softmax, top-k; for k > 1 the k
  gates are renormalised to sum to 1, for k == 1 the raw probability is the
  gate (moe.py:421-435).
* `dispatch="ragged"`, the default (moe.py:228-252,554-601): one stable
  argsort of all B*T*k token-major assignments puts rows contiguous by
  expert (`ragged_routing`); the per-expert counts come from a searchsorted
  on the sorted ids, so no size is read on the host. Every assignment is
  computed: no capacity, no dropped token. The expert matmuls are the
  grouped matmul (ops/gmm.py, kernels B4 and B4t); the row permutation and
  its inverse are gathers whose backward is the other gather
  (`PermuteRows`); the per-row expert bias is a one-hot [S, E] . [E, F]
  matmul, as in the JAX package.
* The capacity layouts group one batch row to a dispatch group, each with
  `expert_capacity(T, E, k, capacity_factor)` slots an expert; tokens past
  an expert's capacity are dropped (their gate weight is 0), earlier tokens
  and higher-gate slots first (moe.py:414-419). `dispatch="sort"`
  (moe.py:187-225,341-360,603-676): a stable argsort of each row's
  assignments gives every (token, slot) its position in its expert and the
  two directions of the token <-> expert-slot bijection (`sort_routing`),
  laid out expert-major [E, B, cap] (`globalize_routing`), so dispatch and
  combine are gathers whose backward is the inverse gather (`GatherRows`);
  the experts are two batched matmuls [E, B*cap, H] x [E, H, F], and the
  bias, ReLU and dropout one autograd Function that saves only its output
  (`BiasReluDropout`). `dispatch="scatter"` (moe.py:459-470,612-618,
  672-684): a running count gives the positions, each row scatters into
  [E, cap+1, H] (dropped tokens into the spare slot `cap`, which is cut
  off), the experts are batched matmuls over [B, E, cap, H], and the
  combine a gather. Sort and scatter compute the same function.
* `remat` (moe.py:688-691): the expert computation (dispatch, experts,
  combine) runs under `torch.utils.checkpoint` and is recomputed in the
  backward instead of saving its activations. Its dropout seed is drawn
  outside the region, so the recomputed forward draws the same mask.
* `quant_mode` (moe.py:517-548, serving only): "calibrate" records in the
  buffers `expert_in_amax` [E, H] and `expert_hidden_amax` [E, F] the
  running per-expert per-channel absmax of the two expert matmuls' inputs
  (ragged: every routed assignment, `segment_amax`; sort: the dispatched
  rows); "int8_static" (sort only) runs both expert matmuls through
  ops/quant.py's `int8_expert_einsum` with those scales, an expert that saw
  no calibration token taking each channel's max across experts. The
  buffers are not part of the state dict.
* Aux loss, returned beside the output (not kept in module state): the
  Switch balance E * sum_e(f_e * P_e) with f_e the fraction of assignments
  to expert e over k (pre-capacity counts in every layout) and P_e the mean
  router probability, plus Z_LOSS_SCALE * mean(logsumexp(logits)^2)
  (moe.py:478-486).

The parameters keep the JAX package's names and layout: `router` (a Linear,
torch [E, H] weight), `expert_w1` [E, H, F], `expert_b1` [E, F], `expert_w2`
[E, F, H], `expert_b2` [E, H].

Under a (data, model) mesh (parallel/mesh.py):
* Expert parallelism (`_ep_ragged_experts`, moe.py:267-338, and its
  branch :565-580): with a 'model' axis above 1 in the mesh the step runs
  under (`parallel.mesh.active()`, read once in the forward, so a remat
  recompute sees the forward's), each rank holds the e_loc = E / n_model
  experts [off, off + e_loc), off = model index x e_loc (parallel/mesh.py's
  `shard_params`), and runs the grouped matmul's window forms B4s/B4ts
  (`GroupedMatmul` with the group offset) over its own rows: the rows of
  other ranks' experts come out as zeros, and so does their one-hot bias.
  `reduce_from_model` sums the ranks' outputs (the EP combine) and
  `copy_to_model`, around the sorted rows, sums their partial row gradients
  in the backward (JAX's shard_map transpose inserts that sum). The layout differs from JAX's in one thing: each data
  rank sorts its own tokens by expert and its experts' counts cover its rows
  only, where JAX sorts the global batch and chunks the sorted rows over
  'data' (that would need every token gathered). Each row's products are
  the same; only the order of sums over rows differs. Dropout keeps the data
  rank's stream (the step folds the data index into the generator); rows of
  different model ranks are disjoint, so it needs no model index, where JAX
  folds both. The capacity layouts split the same way (JAX leaves them to
  GSPMD on the `P('model')` expert weights, mesh.py:113-122): `sort` runs
  the rank's experts on its window [off, off + e_loc) of the expert-major
  slots (the two `bmm`s over [e_loc, B*cap, H]), `scatter` scatters only
  the tokens of its experts; each combines the window's tokens (the others
  zero) and `reduce_from_model` sums the ranks, `copy_to_model` the input's
  partial gradients. Their hidden dropout draws the one-process buffer's
  mask whole and keeps the rank's window of it (`window_dropout`), so a
  1 x N mesh drops what one process drops.
* The aux loss is the global batch's (a one-process run's) whenever the
  'data' axis is above 1: the expert counts, the router probabilities' sums
  and the squared logsumexp's sum are summed over the data group, each with
  its gradient on the rank's own rows only, so that the step's sum of the
  ranks' gradients is the gradient of the global aux.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from weathermodel_tpu_torch.ops.dropout import (
    apply_keep,
    draw_seed,
    dropout,
    rounded_scale,
)
from weathermodel_tpu_torch.ops.gmm import (
    GroupedMatmul,
    gmm_op,
    gmm_reference,
)
from weathermodel_tpu_torch.parallel import mesh as mesh_lib
from weathermodel_tpu_torch.ops.quant import (
    calibrated,
    int8_expert_einsum,
    record_amax,
)

# Router z-loss weight relative to the balance loss (moe.py:79-81)
Z_LOSS_SCALE = 1e-3
GMM_IMPLS = ("kernel", "plain")
DISPATCHES = ("sort", "ragged", "scatter")
QUANT_MODES = ("none", "calibrate", "int8_static")
QUANT_BUFFERS = ("expert_in_amax", "expert_hidden_amax")


def expert_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-group expert capacity of the sort and scatter layouts,
    padded to a multiple of 8 (moe.py:84-90)."""
    c = int(capacity_factor * top_k * tokens_per_group / num_experts)
    c = max(c, top_k)
    return -(-c // 8) * 8


class PermuteRows(torch.autograd.Function):
    """y = x[order] for a permutation `order` with inverse `inv`; the
    backward is the inverse gather dx = g[inv] (moe.py:128-146), not the
    index-put that autograd gives `x[order]`."""

    @staticmethod
    def forward(ctx, x, order, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, order)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return g.index_select(0, inv), None, None


def _masked_rows(x, idx, mask):
    rows = x.index_select(0, idx)
    return torch.where(mask[:, None], rows,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class GatherRows(torch.autograd.Function):
    """y[m] = mask[m] ? x[idx[m]] : 0 for x [N, H], whose backward is the
    inverse gather dx[n] = inv_mask[n] ? g[inv_idx[n]] : 0 (moe.py:93-125):
    the dispatch between kept (token, slot) assignments and filled expert
    slots is a bijection, so the caller hands over its inverse."""

    @staticmethod
    def forward(ctx, x, idx, mask, inv_idx, inv_mask):
        ctx.save_for_backward(inv_idx, inv_mask)
        return _masked_rows(x, idx, mask)

    @staticmethod
    def backward(ctx, g):
        inv_idx, inv_mask = ctx.saved_tensors
        return _masked_rows(g, inv_idx, inv_mask), None, None, None, None


class BiasReluDropout(torch.autograd.Function):
    """relu(pre + bias[:, None]) then dropout (at `rate` > 0, from `seed`;
    `window` as `window_dropout`'s) as one Function that saves only its
    output y (moe.py:149-185): the ReLU and dropout-survivor masks coincide
    with y > 0 and the dropout scale is a constant, so the backward is one
    elementwise pass and the bias's sum. pre [E, M, F] in the compute
    dtype, bias [E, F] fp32. Valid for every dropout impl of the port:
    each keeps a value as x * 1/(1 - rate)."""

    @staticmethod
    def forward(ctx, pre, bias, rate, seed, window=None):
        y = torch.relu(pre + bias[:, None].to(pre.dtype))
        if rate > 0.0:
            y = window_dropout(y, rate, seed, window, 0)
        ctx.save_for_backward(y)
        ctx.rate = rate
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        scale = rounded_scale(ctx.rate, g.dtype) if ctx.rate > 0.0 else 1.0
        dpre = torch.where(y > 0, g * scale,
                           torch.zeros((), dtype=g.dtype, device=g.device))
        db = dpre.sum(dim=tuple(range(1, dpre.dim() - 1))).float()
        return dpre, db, None, None, None


def window_dropout(h, rate: float, seed: int, window, dim: int):
    """`dropout(h, rate, seed)`; with `window` = (off, e), h is the slice
    [off, off + h.shape[dim]) along the expert dim `dim` of a buffer of e
    experts: that buffer's mask is drawn whole and sliced, so a rank holding
    a window of the experts keeps the entries one process keeps."""
    if window is None or rate <= 0.0:
        return dropout(h, rate, seed)
    off, e = window
    shape = list(h.shape)
    shape[dim] = e
    keep = dropout(h.new_ones(shape), rate, seed).narrow(
        dim, off, h.shape[dim]) != 0
    return apply_keep(h, keep, rate)


def ragged_routing(flat_idx, num_experts: int):
    """flat_idx [B, T*k] expert ids (token-major) -> (order, inv, n_e,
    sorted_e), as `_ragged_routing` (moe.py:228-252): `order` [S] sorts the
    S = B*T*k assignments by expert, stably (ties in token-major order);
    `inv` [S] is its inverse; `n_e` [E] the per-expert counts; `sorted_e`
    [S] the expert of each sorted row. All on flat_idx's device, with no
    host sync."""
    flat = flat_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    experts = torch.arange(num_experts, dtype=flat.dtype, device=flat.device)
    start = torch.searchsorted(sorted_e, experts, side="left")
    n_e = torch.diff(start, append=start.new_full((1,), flat.numel()))
    inv = torch.argsort(order)
    return order, inv, n_e, sorted_e


def sort_routing(flat_idx, num_experts: int, cap: int):
    """Per-row capacity routing by a stable argsort, as `_sort_routing`
    (moe.py:187-225). flat_idx [B, Tk] -> (pos, keep, slot, tok, filled,
    n_e):
      pos    [B, Tk] position of each (token, slot) inside its expert
      keep   [B, Tk] pos < cap
      slot   [B, Tk] expert-slot id e*cap + min(pos, cap-1)
      tok    [B, E*cap] token filling each slot (meaningless if empty)
      filled [B, E*cap] slot actually filled
      n_e    [B, E] pre-capacity per-expert counts"""
    b, tk = flat_idx.shape
    e = num_experts
    order = torch.argsort(flat_idx, dim=1, stable=True)
    sorted_e = flat_idx.gather(1, order)
    experts = torch.arange(e, dtype=flat_idx.dtype, device=flat_idx.device)
    start = torch.searchsorted(sorted_e, experts.expand(b, e).contiguous(),
                               side="left")
    n_e = torch.diff(start, dim=1, append=start.new_full((b, 1), tk))
    pos_sorted = (torch.arange(tk, dtype=start.dtype,
                               device=start.device)[None]
                  - start.gather(1, sorted_e))
    inv = torch.argsort(order, dim=1)
    pos = pos_sorted.gather(1, inv)
    keep = pos < cap
    slot = flat_idx * cap + pos.clamp(max=cap - 1)
    c_ar = torch.arange(cap, dtype=start.dtype, device=start.device)
    slot_pos = start[:, :, None] + c_ar[None, None, :]          # [B, E, cap]
    filled = c_ar[None, None, :] < n_e.clamp(max=cap)[:, :, None]
    tok = order.gather(1, slot_pos.clamp(0, tk - 1).reshape(b, e * cap))
    return pos, keep, slot, tok, filled.reshape(b, e * cap), n_e


def globalize_routing(flat_idx, pos, keep, tok, filled, num_experts: int,
                      cap: int):
    """The sort layout's index maps over the whole batch, expert-major
    ([E, B, cap] slots, [B, Tk] tokens; moe.py:341-360): (gtok, gfill)
    build the experts' input [E, B*cap, H] from the B*Tk token rows in one
    gather, (gslot, gkeep) bring each token's slot back. All flat."""
    b, tk = flat_idx.shape
    e = num_experts
    boff = torch.arange(b, dtype=tok.dtype, device=tok.device) * tk
    gtok = (tok.reshape(b, e, cap) + boff[:, None, None]).transpose(0, 1)
    gfill = filled.reshape(b, e, cap).transpose(0, 1)
    brow = torch.arange(b, dtype=tok.dtype, device=tok.device)[:, None]
    gslot = (flat_idx * b + brow) * cap + pos.clamp(max=cap - 1)
    return (gtok.reshape(-1), gfill.reshape(-1), gslot.reshape(-1),
            keep.reshape(-1))


def scatter_routing(flat_idx, num_experts: int, cap: int):
    """The scatter layout's positions from a running count over each row
    (moe.py:459-472): (pos [B, Tk] with dropped assignments at the spare
    slot `cap`, keep [B, Tk], the pre-capacity counts [B, E])."""
    onehot = F.one_hot(flat_idx, num_experts)                  # [B, Tk, E]
    pos = (torch.cumsum(onehot, dim=1) - onehot).gather(
        2, flat_idx[..., None])[..., 0]
    keep = pos < cap
    return torch.where(keep, pos, cap), keep, onehot.sum(dim=1)


def segment_amax(x, seg, num_experts: int):
    """Per-expert per-channel absmax [E, C] in fp32 of the rows of x [S, C]
    whose expert is seg [S] (moe.py:255-264): the dropless calibration
    statistic. An expert with no row gets 0."""
    c = x.shape[1]
    out = torch.zeros(num_experts, c, dtype=torch.float32, device=x.device)
    return out.scatter_reduce(0, seg[:, None].expand(-1, c),
                              x.abs().float(), "amax", include_self=True)


def _global_aux(mesh, counts, probs, z, k: int):
    """The Switch balance plus the z-loss over the global batch of a mesh
    whose 'data' axis is above 1: `counts` [E] this rank's assignments per
    expert, `probs` [b, T, E] and `z` [b, T] its rows'. Each sum is the data
    group's, with its gradient on this rank's rows only."""
    e = probs.shape[-1]
    stats = torch.cat([counts.float(), probs.sum(dim=(0, 1)),
                       z.square().sum()[None]])
    stats = mesh_lib.data_sum_with_local_grad(mesh, stats)
    tokens = probs.shape[0] * probs.shape[1] * mesh.n_data
    density = stats[:e] / tokens
    balance = e * torch.sum(density / k * (stats[e:2 * e] / tokens))
    return balance + Z_LOSS_SCALE * (stats[2 * e] / tokens)


def expert_window(mesh, e: int, w1) -> tuple:
    """(off, e_loc): the experts [off, off + e_loc) this rank of `mesh`
    holds and runs, off = model index x e_loc, with the checks that the
    expert weights `w1` [e_loc, ...] are its shards."""
    m = int(mesh.shape["model"])
    e_loc = e // m
    if e_loc * m != e:
        raise ValueError(f"num_experts={e} not divisible by the mesh "
                         f"'model' axis ({m})")
    if w1.shape[0] != e_loc:
        raise ValueError(f"expert weights hold {w1.shape[0]} experts, the "
                         f"mesh gives a rank {e_loc}: shard them with "
                         "parallel.mesh.shard_params")
    return mesh.model_index * e_loc, e_loc


def _ep_ragged_experts(mesh, xs, sorted_e, n_e, w1, b1, w2, b2, rate, seed,
                       dtype, grouped):
    """The ragged dispatch's expert FFN on this rank's experts [off, off +
    e_loc) (`_ep_ragged_experts`, moe.py:267-338): xs [S, H], this rank's
    rows sorted by expert with the per-expert counts n_e [E], and the local
    expert weights [e_loc, ...]; `grouped(lhs, rhs, n_e, off)` is the
    grouped matmul over the window. Returns the sum over the model group,
    [S, H]: every row's output exactly once."""
    off, e_loc = expert_window(mesh, n_e.shape[0], w1)
    xs = mesh_lib.copy_to_model(xs, mesh)
    le = sorted_e - off
    onehot = (le[:, None] == torch.arange(
        e_loc, device=xs.device)).to(dtype)          # zero rows elsewhere
    hdn = grouped(xs, w1.to(dtype), n_e, off)
    hdn = torch.relu(hdn + onehot @ b1.to(dtype))
    hdn = dropout(hdn, rate, seed)
    out = grouped(hdn, w2.to(dtype), n_e, off)
    out = out + onehot @ b2.to(dtype)
    return mesh_lib.reduce_from_model(out, mesh)      # the EP combine


class MoEFFN(nn.Module):
    """Top-k routed expert FFN: [B, T, H] -> ([B, T, H] in x's dtype, fp32
    aux loss).

    `gmm_impl` "kernel" runs the ragged dispatch's expert matmuls through
    `GroupedMatmul` (kernels B4/B4t on the card, their plain versions on
    the CPU); "plain" runs the plain versions on any device (the reference
    the kernel path is checked against on the card). The capacity layouts
    run batched matmuls, as the JAX einsums do; `capacity_factor` sizes
    them and the ragged dispatch ignores it."""

    def __init__(self, hidden_dim: int, ffn_dim: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dispatch: str = "ragged", remat: bool = False,
                 gmm_impl: str = "kernel", quant_mode: str = "none"):
        super().__init__()
        if not 0 < top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts="
                             f"{num_experts}]")
        if dispatch not in DISPATCHES:
            raise ValueError(f"dispatch must be 'sort', 'ragged' or "
                             f"'scatter', got {dispatch!r}")
        if gmm_impl not in GMM_IMPLS:
            raise ValueError(f"gmm_impl must be one of {GMM_IMPLS}, got "
                             f"{gmm_impl!r}")
        if quant_mode not in QUANT_MODES:
            raise ValueError(f"quant_mode must be 'none', 'calibrate' or "
                             f"'int8_static', got {quant_mode!r}")
        if quant_mode == "int8_static" and dispatch != "sort":
            raise ValueError("MoE int8_static requires dispatch='sort' (the "
                             "int8 expert einsum is wired to the capacity "
                             "layout)")
        if quant_mode == "calibrate" and dispatch == "scatter":
            raise ValueError("MoE calibrate requires dispatch='sort' or "
                             "'ragged' (ragged calibrates on dropless "
                             "statistics: every routed assignment)")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dispatch, self.remat = (capacity_factor,
                                                           dispatch, remat)
        self.gmm_impl, self.quant_mode = gmm_impl, quant_mode
        e, h, f = num_experts, hidden_dim, ffn_dim
        self.router = nn.Linear(h, e)
        self.expert_w1 = nn.Parameter(torch.empty(e, h, f))
        self.expert_b1 = nn.Parameter(torch.empty(e, f))
        self.expert_w2 = nn.Parameter(torch.empty(e, f, h))
        self.expert_b2 = nn.Parameter(torch.empty(e, h))
        if quant_mode != "none":
            for name in QUANT_BUFFERS:
                self.register_buffer(name, torch.empty(0), persistent=False)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The JAX package's init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
        the router and, per expert, for each weight and bias (fan_in H for
        linear1, F for linear2)."""
        for w in (self.router.weight, self.router.bias, self.expert_w1,
                  self.expert_b1):
            bound = 1.0 / self.expert_w1.shape[1] ** 0.5
            nn.init.uniform_(w, -bound, bound, generator=generator)
        for w in (self.expert_w2, self.expert_b2):
            bound = 1.0 / self.expert_w2.shape[1] ** 0.5
            nn.init.uniform_(w, -bound, bound, generator=generator)

    def route(self, x):
        """(logits, probs, gate, idx): the fp32 router's logits and softmax
        [B, T, E], and the top-k gates and expert ids [B, T, k]."""
        logits = F.linear(x.float(), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)
        gate, idx = torch.topk(probs, self.top_k, dim=-1)
        if self.top_k > 1:
            gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return logits, probs, gate, idx

    def _gmm(self, lhs, rhs, n_e, group_offset=None):
        """B4 (B4s over the window from `group_offset`), or its plain
        version with gmm_impl "plain". With gradients off the full form is
        the op `torch.ops.wm.gmm` (ops/gmm.py), the same launch, which
        `torch.export` keeps as one node."""
        if self.gmm_impl == "plain":
            return gmm_reference(lhs, rhs, n_e, group_offset=group_offset)
        if group_offset is None and not torch.is_grad_enabled():
            return gmm_op(lhs, rhs, n_e)
        return GroupedMatmul.apply(lhs, rhs, n_e, group_offset)

    def forward(self, x, dropout_rate: float = 0.0, generator=None):
        b, t, _ = x.shape
        e, k = self.num_experts, self.top_k
        if self.quant_mode == "int8_static" and dropout_rate > 0.0:
            raise ValueError("quant_mode='int8_static' is a serving/eval "
                             "path; train in bf16/fp32 and quantize at "
                             "serve time")
        logits, probs, gate, idx = self.route(x)
        flat_idx = idx.reshape(b, t * k)
        cap = expert_capacity(t, e, k, self.capacity_factor)
        keep = None
        if self.dispatch == "sort":
            pos, keep, _, tok, filled, n_e = sort_routing(flat_idx, e, cap)
            routing = globalize_routing(flat_idx, pos, keep, tok, filled, e,
                                        cap)
            density = n_e.float().mean(dim=0) / t
            counts = n_e
        elif self.dispatch == "ragged":
            routing = ragged_routing(flat_idx, e)
            density = routing[2].float() / (b * t)
            counts = routing[2][None]
        else:
            pos, keep, counts = scatter_routing(flat_idx, e, cap)
            routing = (flat_idx, pos)
            density = counts.float().mean(dim=0) / t

        z = torch.logsumexp(logits, dim=-1)
        mesh = mesh_lib.active()
        if mesh is None or mesh.n_data == 1:
            balance = e * torch.sum(density / k * probs.mean(dim=(0, 1)))
            aux = balance + Z_LOSS_SCALE * z.square().mean()
        else:
            aux = _global_aux(mesh, counts.sum(dim=0), probs, z, k)

        # the seed is drawn outside the remat region: its recomputed
        # forward draws the same mask
        seed = draw_seed(generator) if dropout_rate > 0.0 else 0
        w_gate = gate.reshape(b, t * k)
        if keep is not None:
            w_gate = w_gate * keep
        w_gate = w_gate.to(x.dtype)
        # calibration is an offline one-process pass: always the unsharded
        # branch (moe.py:565-580)
        ep = mesh if (mesh is not None and mesh.n_model > 1 and e > 1
                      and self.quant_mode != "calibrate") else None
        # the weights as read now (under a mesh, gathered over 'data' for
        # this forward), so that a remat recompute uses the same tensors
        weights = (self.expert_w1, self.expert_b1, self.expert_w2,
                   self.expert_b2)
        if self.remat and torch.is_grad_enabled():
            out = checkpoint(self._experts, x, w_gate, routing, cap,
                             dropout_rate, seed, ep, weights,
                             use_reentrant=False)
        else:
            out = self._experts(x, w_gate, routing, cap, dropout_rate, seed,
                                ep, weights)
        return out, aux

    def _experts(self, x, w_gate, routing, cap, rate, seed, ep, weights):
        """Dispatch, the experts, combine and the gate-weighted sum: the
        region `remat` recomputes."""
        b, t, h = x.shape
        k = self.top_k
        xk = x.unsqueeze(2).expand(b, t, k, h).reshape(b * t * k, h)
        if self.dispatch == "ragged":
            got = self._ragged(xk, routing, rate, seed, ep, weights)
        elif self.dispatch == "sort":
            got = self._sort(xk, routing, b, cap, rate, seed, ep, weights)
        else:
            got = self._scatter(xk.reshape(b, t * k, h), routing, cap, rate,
                                seed, ep, weights)
        return (got.reshape(b, t, k, h)
                * w_gate.reshape(b, t, k)[..., None]).sum(dim=2)

    def _ragged(self, xk, routing, rate, seed, ep, weights):
        order, inv, n_e, sorted_e = routing
        e, dtype = self.num_experts, xk.dtype
        w1, b1, w2, b2 = weights
        calibrate = self.quant_mode == "calibrate"
        xs = PermuteRows.apply(xk, order, inv)
        if ep is not None:
            out = _ep_ragged_experts(ep, xs, sorted_e, n_e, w1, b1, w2, b2,
                                     rate, seed, dtype, self._gmm)
            return PermuteRows.apply(out, inv, order)
        if calibrate:
            record_amax(self, "expert_in_amax", segment_amax(xs, sorted_e, e))
        onehot = (sorted_e[:, None] == torch.arange(
            e, device=xk.device)).to(dtype)                           # [S, E]
        hdn = self._gmm(xs, w1.to(dtype), n_e)
        hdn = torch.relu(hdn + onehot @ b1.to(dtype))
        hdn = dropout(hdn, rate, seed)
        if calibrate:
            record_amax(self, "expert_hidden_amax",
                        segment_amax(hdn, sorted_e, e))
        out = self._gmm(hdn, w2.to(dtype), n_e)
        out = out + onehot @ b2.to(dtype)                             # [S, H]
        return PermuteRows.apply(out, inv, order)

    def _sort(self, xk, routing, b, cap, rate, seed, ep, weights):
        gtok, gfill, gslot, gkeep = routing
        e, h, dtype = self.num_experts, xk.shape[1], xk.dtype
        w1, b1, w2, b2 = weights
        off, e_here, window = 0, e, None
        if ep is not None:
            # this rank's experts [off, off + e_loc): the window of the
            # expert-major slots, and the tokens whose slot lies in it
            off, e_here = expert_window(ep, e, w1)
            window = (off, e)
            n = b * cap
            gtok = gtok[off * n:(off + e_here) * n]
            gfill = gfill[off * n:(off + e_here) * n]
            gkeep = gkeep & (gslot >= off * n) & (gslot < (off + e_here) * n)
            gslot = (gslot - off * n).clamp(0, e_here * n - 1)
            xk = mesh_lib.copy_to_model(xk, ep)
        expert_in = GatherRows.apply(xk, gtok, gfill, gslot,
                                     gkeep).reshape(e_here, b * cap, h)
        b2 = b2[:, None].to(dtype)
        if self.quant_mode == "int8_static":
            qa1, qa2 = (calibrated(self, name) for name in QUANT_BUFFERS)
            # an expert that saw no calibration token: each channel's max
            # across experts, rather than saturating everything routed to it
            qa1 = torch.where(qa1 > 0, qa1, qa1.amax(dim=0, keepdim=True))
            qa2 = torch.where(qa2 > 0, qa2, qa2.amax(dim=0, keepdim=True))
            hdn = int8_expert_einsum(expert_in, w1, qa1, dtype)
            hdn = torch.relu(hdn + b1[:, None].to(dtype))
            out = int8_expert_einsum(hdn, w2, qa2, dtype) + b2
        else:
            calibrate = self.quant_mode == "calibrate"
            if calibrate:
                record_amax(self, "expert_in_amax",
                            expert_in.abs().float().amax(dim=1))
            hdn = torch.bmm(expert_in, w1.to(dtype))
            hdn = BiasReluDropout.apply(hdn, b1, rate, seed, window)
            if calibrate:
                record_amax(self, "expert_hidden_amax",
                            hdn.abs().float().amax(dim=1))
            out = torch.bmm(hdn, w2.to(dtype)) + b2              # [E, M, H]
        out = GatherRows.apply(out.reshape(-1, h), gslot, gkeep, gtok, gfill)
        return out if ep is None else mesh_lib.reduce_from_model(out, ep)

    def _scatter(self, xk, routing, cap, rate, seed, ep, weights):
        flat_idx, pos = routing
        b, tk, h = xk.shape
        e, dtype = self.num_experts, xk.dtype
        w1, b1, w2, b2 = weights
        off, e_here, window = 0, e, None
        if ep is not None:
            off, e_here = expert_window(ep, e, w1)
            window = (off, e)
            xk = mesh_lib.copy_to_model(xk, ep)
        local = flat_idx - off
        here = (local >= 0) & (local < e_here)
        # a token of another rank's expert goes to the spare slot `cap` of
        # expert 0, which is cut off, as a dropped token does
        local = torch.where(here, local, 0)
        rows = torch.arange(b, device=xk.device)[:, None].expand(b, tk)
        buf = xk.new_zeros(b, e_here, cap + 1, h)
        expert_in = buf.index_put((rows, local, torch.where(here, pos, cap)),
                                  xk)[:, :, :cap]
        hdn = torch.einsum("bech,ehf->becf", expert_in, w1.to(dtype))
        hdn = torch.relu(hdn + b1[None, :, None].to(dtype))
        hdn = window_dropout(hdn, rate, seed, window, 1)
        out = torch.einsum("becf,efh->bech", hdn, w2.to(dtype))
        out = out + b2[None, :, None].to(dtype)          # [B, E, cap, H]
        got = out[rows, local, pos.clamp(max=cap - 1)]
        if ep is None:
            return got
        got = torch.where(here[..., None], got,
                          torch.zeros((), dtype=dtype, device=got.device))
        return mesh_lib.reduce_from_model(got, ep)
