"""B6b's plain version in bf16 (`fused_ffn_ln_bwd_reference`) against
`jax.vjp` of the JAX package's `pallas_ffn.fused_ffn_ln`, its backward the
Pallas kernel `_ffn_bwd_kernel` in the interpreter, dropout 0.

The kernel's bf16 bodies (the row body and the weight-gradient products on
the grouped matmul's body) are held to this plain version on the card, so
the plain version must round where the TPU kernel does: df and dz rounded
to bf16 before the products, every product summed in fp32, dW1 and dW2
rounded once. The JAX side is compiled with XLA's excess precision off
(as tests/test_torch_port_attention_bwd.py does), so that each bf16
operation of the interpreted kernel rounds as written."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.ops import pallas_ffn
from weathermodel_tpu_torch.ops.fused_ffn_ln import fused_ffn_ln_bwd_reference
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

EXACT_BF16 = {"xla_allow_excess_precision": False}
# both sides round dz, df and the outputs at the same points and sum in
# fp32 in other orders: an entry near a rounding boundary moves by one bf16
# ulp, and at most this share of the entries differ
DIFFER_SHARE = 1e-2
# db1 and db2: the port sums dz and df after their rounding to bf16, the TPU
# kernel before it (a known difference, ROADMAP C). Each term then differs
# by at most 2^-9 of itself; over M rows of mixed signs the sums differ by
# about 2^-9 of their own size, and the bar leaves a factor of 4
DB_SHARE = 2.0 ** -7
# (B, T, H, F): T not a multiple of the TPU kernel's 128-row padding, H and
# F at the model sizes' ratio F = 4 H; the last at WeatherBERT-mini's widths
SHAPES = [(2, 20, 48, 192), (3, 37, 32, 128), (1, 60, 96, 384)]
GRADS = ("dx", "dw1", "db1", "dw2", "db2", "dln_scale", "dln_bias")


def _ulp(want):
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _arrays(b, t, h, f, seed):
    """x, W1, W2 and the cotangent as bf16 values (the same on both sides),
    b1, b2 and the LN parameters fp32, as the JAX layer passes them."""
    rng = np.random.default_rng(seed)
    bf16 = [rng.normal(size=(b, t, h)), rng.normal(size=(h, f)) / h ** 0.5,
            rng.normal(size=(f, h)) / f ** 0.5, rng.normal(size=(b, t, h))]
    bf16 = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for a in bf16]
    fp32 = [rng.normal(size=f) * 0.1, rng.normal(size=h) * 0.1,
            1 + 0.1 * rng.normal(size=h), 0.1 * rng.normal(size=h)]
    fp32 = [torch.from_numpy(a.astype(np.float32)) for a in fp32]
    x, w1, w2, do = bf16
    b1, b2, ls, lb = fp32
    return x, w1, b1, w2, b2, ls, lb, do


def _jax(a):
    dtype = jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32
    return jnp.asarray(a.float().numpy(), dtype)


def _np(a):
    if isinstance(a, jax.Array):
        return np.asarray(a.astype(jnp.float32))
    return a.float().numpy()


@pytest.mark.parametrize("b,t,h,f", SHAPES)
def test_bf16_ffn_bwd_plain_version_rounds_as_the_pallas_kernel(b, t, h, f):
    """dx, dW1 and dW2 within one bf16 ulp of the largest entry and at most
    1% of the entries differing; dln_scale and dln_bias (fp32 sums of the
    same terms) and db1, db2 (see DB_SHARE) against the fp32 bars named."""
    args = _arrays(b, t, h, f, seed=b * t + h)
    *primals, do = args

    def run(primals, do):
        _, vjp = jax.vjp(pallas_ffn.fused_ffn_ln, *primals)
        return vjp(do)

    jargs = [_jax(a) for a in primals]
    want = jax.jit(run).lower(jargs, _jax(do)).compile(
        compiler_options=EXACT_BF16)(jargs, _jax(do))
    got = fused_ffn_ln_bwd_reference(*args, 0.0, (0, 0))
    for name, g, w, a in zip(GRADS, got, want, (args[0], *primals[1:])):
        assert g.dtype == a.dtype and w.dtype == jnp.dtype(_jax(a).dtype), \
            name
        g, w = _np(g), _np(w)
        err = np.abs(g - w).max()
        if name in ("dx", "dw1", "dw2"):
            assert err <= _ulp(w), (name, err, _ulp(w))
            assert (g != w).mean() <= DIFFER_SHARE, (name, (g != w).mean())
        elif name in ("db1", "db2"):
            assert err <= DB_SHARE * np.abs(w).max(), (name, err)
        else:  # fp32 sums of fp32 terms, in another order
            assert err <= 1e-5 * np.abs(w).max(), (name, err)
