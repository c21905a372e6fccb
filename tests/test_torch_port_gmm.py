"""The port's grouped matmul (ops/gmm.py: B4 `gmm`, B4t `tgmm` and the
autograd Function `GroupedMatmul`; their plain versions run on the CPU)
against the JAX package's `gmm` (ops/pallas_gmm.py, the Pallas kernels in
interpret mode via tests/conftest.py) and `jax.vjp` through its custom VJP,
on tests/test_pallas_gmm.py's group layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.ops.pallas_gmm import gmm as jax_gmm
from weathermodel_tpu_torch.ops.gmm import (
    GroupedMatmul,
    gmm,
    group_offsets,
    tgmm,
)

# (S, group sizes), as tests/test_pallas_gmm.py:36-44: boundaries inside
# tiles, empty first/last group, empty middle group with S % bm != 0, one
# group over all tiles, tiny groups sharing one tile
GS_CASES = [
    (256, [100, 60, 96]),
    (256, [0, 256, 0]),
    (300, [128, 0, 44, 128]),
    (640, [640]),
    (130, [1, 1, 1, 127]),
]


def _case(seed, s, k, n, gs):
    rng = np.random.default_rng(seed)
    assert sum(gs) == s
    return (rng.normal(size=(s, k)).astype(np.float32),
            rng.normal(size=(len(gs), k, n)).astype(np.float32),
            rng.normal(size=(s, n)).astype(np.float32),
            np.asarray(gs, np.int32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,gs", GS_CASES)
def test_gmm_forward_matches_jax(s, gs):
    lhs, rhs, _, g = _case(0, s, 16, 24, gs)
    want = np.asarray(jax.jit(jax_gmm)(jnp.asarray(lhs), jnp.asarray(rhs),
                                       jnp.asarray(g)))
    got = gmm(*_torch(lhs, rhs, g))
    assert got.dtype == torch.float32 and got.shape == (s, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,gs", GS_CASES)
def test_grouped_matmul_gradients_match_jax_vjp(s, gs):
    """d_lhs (gmm against rhs^T) and d_rhs (tgmm) of `GroupedMatmul`
    against jax.vjp through the JAX gmm's custom VJP, at 1e-4."""
    lhs, rhs, dy, g = _case(1, s, 8, 12, gs)

    @jax.jit
    def forward_and_vjp(a, b, cot):
        y, vjp = jax.vjp(lambda a_, b_: jax_gmm(a_, b_, jnp.asarray(g)), a, b)
        return (y, *vjp(cot))

    y, d_lhs, d_rhs = forward_and_vjp(jnp.asarray(lhs), jnp.asarray(rhs),
                                      jnp.asarray(dy))
    lhs_t, rhs_t, dy_t, g_t = _torch(lhs, rhs, dy, g)
    lhs_t.requires_grad_()
    rhs_t.requires_grad_()
    y_t = GroupedMatmul.apply(lhs_t, rhs_t, g_t)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(y_t, (lhs_t, rhs_t), dy_t)
    for a, b in zip(got, (d_lhs, d_rhs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(tgmm(*_torch(lhs, dy, g)).numpy(),
                               np.asarray(d_rhs), rtol=1e-4, atol=1e-4)


def test_empty_group_weight_gradient_is_exactly_zero():
    lhs, rhs, dy, g = _case(2, 256, 8, 12, [0, 256, 0])
    d_rhs = tgmm(*_torch(lhs, dy, g))
    assert torch.count_nonzero(d_rhs[0]) == 0
    assert torch.count_nonzero(d_rhs[2]) == 0
    assert torch.count_nonzero(d_rhs[1]) > 0
    # and d_lhs through rhs^T is gmm on a transposed copy
    rhs_t = torch.from_numpy(rhs)
    torch.testing.assert_close(
        gmm(torch.from_numpy(dy), rhs_t, torch.from_numpy(g), trans_rhs=True),
        gmm(torch.from_numpy(dy), rhs_t.transpose(1, 2).contiguous(),
            torch.from_numpy(g)), rtol=0, atol=0)


def test_bf16_rounds_once_after_fp32_sums():
    """bf16 in, bf16 out: the fp32 sum of the exact products, rounded once
    (what the JAX gmm's preferred_element_type=f32 dot then astype gives)."""
    lhs, rhs, dy, g = _case(3, 300, 16, 24, [128, 0, 44, 128])
    lhs_b, rhs_b, dy_b = (torch.from_numpy(a).bfloat16()
                          for a in (lhs, rhs, dy))
    want = np.asarray(jax_gmm(jnp.asarray(lhs_b.float().numpy(), jnp.bfloat16),
                              jnp.asarray(rhs_b.float().numpy(), jnp.bfloat16),
                              jnp.asarray(g)).astype(jnp.float32))
    got = gmm(lhs_b, rhs_b, torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp (2^-8 relative) where the two fp32 sums round apart
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=1e-6)
    assert tgmm(lhs_b, dy_b, torch.from_numpy(g)).dtype == torch.bfloat16


def test_group_offsets_and_argument_checks():
    assert group_offsets(torch.tensor([3, 0, 5])).tolist() == [0, 3, 3, 8]
    assert group_offsets(torch.tensor([3, 0, 5])).dtype == torch.int32
    lhs, rhs, dy, g = _torch(*_case(4, 10, 4, 6, [4, 6]))
    with pytest.raises(ValueError, match="K"):
        gmm(lhs, rhs, g, trans_rhs=True)
    with pytest.raises(ValueError, match="group_sizes"):
        gmm(lhs, rhs, g[:1])
    with pytest.raises(ValueError, match="group_sizes"):
        tgmm(lhs, dy, g.float())
    with pytest.raises(ValueError, match="dy"):
        tgmm(lhs, dy[:5], g)
