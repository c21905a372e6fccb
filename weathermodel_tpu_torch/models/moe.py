"""Mixture-of-Experts FFN, the dropless ragged dispatch (port of
weathermodel_tpu/models/moe.py).

A drop-in replacement for the dense FFN half of the encoder layer: router ->
top-k -> rows sorted by expert -> per-expert linear1 -> ReLU -> dropout ->
linear2 -> back to token order -> gate-weighted sum over the k choices. The
residual and post-LN tail stay in the caller (models/blocks.py).

* Router: an fp32 Linear(H, E) on x.float(), softmax, top-k; for k > 1 the k
  gates are renormalised to sum to 1, for k == 1 the raw probability is the
  gate (moe.py:421-435).
* Ragged dispatch (moe.py:228-252,554-601): one stable argsort of all B*T*k
  token-major assignments puts rows contiguous by expert (`ragged_routing`);
  the per-expert counts come from a searchsorted on the sorted ids, so no
  size is read on the host. Every assignment is computed: no capacity, no
  dropped token. The expert matmuls are the grouped matmul (ops/gmm.py,
  kernels B4 and B4t); the row permutation and its inverse are gathers
  whose backward is the other gather (`PermuteRows`); the per-row expert
  bias is a one-hot [S, E] . [E, F] matmul, as in the JAX package.
* Aux loss, returned beside the output (not kept in module state): the
  Switch balance E * sum_e(f_e * P_e) with f_e the fraction of assignments
  to expert e over k and P_e the mean router probability, plus
  Z_LOSS_SCALE * mean(logsumexp(logits)^2) (moe.py:478-486).

The parameters keep the JAX package's names and layout: `router` (a Linear,
torch [E, H] weight), `expert_w1` [E, H, F], `expert_b1` [E, F], `expert_w2`
[E, F, H], `expert_b2` [E, H]. Only `dispatch="ragged"` (the default of
ModelConfig and `wm-pretrain`) is ported; the capacity layouts ("sort",
"scatter") and `remat` raise, naming ROADMAP.md queue A item 12.
"""

import torch
from torch import nn

from weathermodel_tpu_torch.ops.dropout import draw_seed, dropout
from weathermodel_tpu_torch.ops.gmm import GroupedMatmul, gmm_reference

# Router z-loss weight relative to the balance loss (moe.py:79-81)
Z_LOSS_SCALE = 1e-3
GMM_IMPLS = ("kernel", "plain")


def expert_capacity(tokens_per_group: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Static per-group expert capacity, padded to a multiple of 8
    (moe.py:84-90). The ragged dispatch has no capacity; the capacity
    layouts that use it are not ported yet."""
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


class MoEFFN(nn.Module):
    """Top-k routed expert FFN with the ragged dispatch: [B, T, H] ->
    ([B, T, H] in x's dtype, fp32 aux loss).

    `gmm_impl` "kernel" runs the expert matmuls through `GroupedMatmul`
    (kernels B4/B4t on the card, their plain versions on the CPU); "plain"
    runs the plain versions on any device (the reference the kernel path is
    checked against on the card). `capacity_factor` is taken and ignored,
    as the JAX module's ragged dispatch ignores it: nothing is dropped."""

    def __init__(self, hidden_dim: int, ffn_dim: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 dispatch: str = "ragged", remat: bool = False,
                 gmm_impl: str = "kernel"):
        super().__init__()
        if not 0 < top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, num_experts="
                             f"{num_experts}]")
        if dispatch != "ragged":
            if dispatch not in ("sort", "scatter"):
                raise ValueError(f"dispatch must be 'sort', 'ragged' or "
                                 f"'scatter', got {dispatch!r}")
            raise NotImplementedError(
                f"MoE dispatch={dispatch!r} (the capacity layout) is not "
                "ported yet; see ROADMAP.md queue A item 12")
        if remat:
            raise NotImplementedError(
                "moe_remat is not ported yet; see ROADMAP.md queue A item 12")
        if gmm_impl not in GMM_IMPLS:
            raise ValueError(f"gmm_impl must be one of {GMM_IMPLS}, got "
                             f"{gmm_impl!r}")
        self.num_experts, self.top_k = num_experts, top_k
        self.gmm_impl = gmm_impl
        e, h, f = num_experts, hidden_dim, ffn_dim
        self.router = nn.Linear(h, e)
        self.expert_w1 = nn.Parameter(torch.empty(e, h, f))
        self.expert_b1 = nn.Parameter(torch.empty(e, f))
        self.expert_w2 = nn.Parameter(torch.empty(e, f, h))
        self.expert_b2 = nn.Parameter(torch.empty(e, h))
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
        logits = nn.functional.linear(x.float(), self.router.weight,
                                      self.router.bias)
        probs = torch.softmax(logits, dim=-1)
        gate, idx = torch.topk(probs, self.top_k, dim=-1)
        if self.top_k > 1:
            gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return logits, probs, gate, idx

    def _gmm(self, lhs, rhs, n_e):
        if self.gmm_impl == "plain":
            return gmm_reference(lhs, rhs, n_e)
        return GroupedMatmul.apply(lhs, rhs, n_e)

    def forward(self, x, dropout_rate: float = 0.0, generator=None):
        b, t, h = x.shape
        e, k, dtype = self.num_experts, self.top_k, x.dtype
        logits, probs, gate, idx = self.route(x)
        order, inv, n_e, sorted_e = ragged_routing(idx.reshape(b, t * k), e)

        density = n_e.float() / (b * t)
        balance = e * torch.sum(density / k * probs.mean(dim=(0, 1)))
        z = torch.logsumexp(logits, dim=-1)
        aux = balance + Z_LOSS_SCALE * z.square().mean()

        s = b * t * k
        xk = x.unsqueeze(2).expand(b, t, k, h).reshape(s, h)
        xs = PermuteRows.apply(xk, order, inv)
        onehot = (sorted_e[:, None] == torch.arange(
            e, device=x.device)).to(dtype)                          # [S, E]
        hdn = self._gmm(xs, self.expert_w1.to(dtype), n_e)
        hdn = torch.relu(hdn + onehot @ self.expert_b1.to(dtype))
        if dropout_rate > 0.0:
            hdn = dropout(hdn, dropout_rate, draw_seed(generator))
        out = self._gmm(hdn, self.expert_w2.to(dtype), n_e)
        out = out + onehot @ self.expert_b2.to(dtype)                # [S, H]
        got = PermuteRows.apply(out, inv, order).reshape(b, t, k, h)
        return (got * gate.to(dtype)[..., None]).sum(dim=2), aux
