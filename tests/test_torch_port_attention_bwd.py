"""The attention's plain versions on separate operands in bf16 against the
JAX package's Pallas kernels in the interpreter: B3b
(`flash_attention_bwd_reference`) against `jax.vjp` of `flash_attention`, B2
(through `FusedQKVAttention`'s plain path) against `jax.vjp` of
`flash_attention_fused`, and B3f (`flash_attention_fwd_reference`) against
`flash_attention`'s forward, dropout 0; and the layout rule of the bf16
bodies (B3f's forward, B2's and B3b's backward), which the wrappers apply to
CUDA tensors before any launch.

XLA on the CPU keeps a bf16 product in fp32 where it can fuse it into its
consumer (its `xla_allow_excess_precision`, on by default), so the
interpreter would compute dk = ds^T . (q * scale) with q * scale unrounded,
and about 40% of dk would differ by one ulp from the kernel's source, where
q * scale is a bf16 value (as on the TPU). The JAX side here is compiled with
that option off, so that every bf16 operation rounds as written."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.ops.pallas_attention import (
    flash_attention,
    flash_attention_fused,
)
from weathermodel_tpu_torch.ops import fused_qkv_attention as fqa
from weathermodel_tpu_torch.ops.flash_attention import (
    check_bf16_body_layout,
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

# bf16, a plain version against the Pallas kernel: both round at the same
# points, so all but a few entries agree bitwise; where fp32 sums in another
# order flip a rounding, an entry moves by about one bf16 ulp. The bar of
# test_bf16_eval_form_rounds_as_the_pallas_kernel
# (tests/test_torch_port_attention.py).
DIFFER_SHARE = 1e-2
# the shapes of tests/test_torch_port_attention_train.py's small cases and
# WeatherFormer-small's geometry (T=365, H=200, 10 heads of 20)
SHAPES = [(3, 13, 24, 2), (2, 37, 36, 3), (1, 365, 200, 10)]
EXACT_BF16 = {"xla_allow_excess_precision": False}


def _ulp(want):
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _assert_within_ulp(name, got, want, share=DIFFER_SHARE):
    """got, want fp32 numpy: max|got - want| at most one bf16 ulp of
    max|want|, and at most `share` of the entries differ."""
    err = np.abs(got - want).max()
    assert err <= _ulp(want), (name, err, _ulp(want))
    differ = (got != want).mean()
    assert differ <= share, (name, differ)


def _bf16(*arrays):
    """torch bf16 tensors and the same values as JAX bf16 arrays (exact)."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return ts, [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in ts]


def _np(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.detach().float().numpy()


def _jax_vjp(f, primals, cotangent):
    """jax.vjp of f at `primals` applied to `cotangent`, compiled with
    EXACT_BF16, and the outputs of each Pallas kernel the backward ran (its
    jaxpr evaluated equation by equation inside the compiled function)."""
    def run(primals, cotangent):
        _, vjp = jax.vjp(f, *primals)
        closed = jax.make_jaxpr(vjp)(cotangent)
        env = dict(zip(closed.jaxpr.constvars, closed.consts))
        env[closed.jaxpr.invars[0]] = cotangent

        def read(v):  # a literal carries its value
            return v.val if hasattr(v, "val") else env[v]

        kernels = []
        for eqn in closed.jaxpr.eqns:
            out = eqn.primitive.bind(*map(read, eqn.invars), **eqn.params)
            out = out if eqn.primitive.multiple_results else [out]
            if eqn.primitive.name == "pallas_call":
                kernels.append(out)
            env.update(zip(eqn.outvars, out))
        return [read(v) for v in closed.jaxpr.outvars], kernels

    compiled = jax.jit(run).lower(primals, cotangent).compile(
        compiler_options=EXACT_BF16)
    return compiled(primals, cotangent)


@pytest.mark.parametrize("b,t,h,nh", SHAPES)
def test_bf16_flash_bwd_plain_version_rounds_as_the_pallas_kernel(b, t, h,
                                                                   nh):
    """B3b's plain version: dq, dk and dv at `_bwd_head_math`'s rounding
    points (qs = rnd(q rnd(scale)), wd and ds rounded, every sum in fp32),
    against `_bwd_kernel` through `flash_attention`'s custom VJP."""
    rng = np.random.default_rng(b * t + h)
    arrays = [rng.normal(size=(b, t, h)).astype(np.float32) for _ in range(4)]
    (q, k, v, do), (qj, kj, vj, doj) = _bf16(*arrays)
    want, _ = _jax_vjp(
        lambda q, k, v: flash_attention(q, k, v, num_heads=nh), (qj, kj, vj),
        doj)
    got = flash_attention_bwd_reference(q, k, v, do, nh, 0.0, 0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        _assert_within_ulp(name, _np(g), _np(w))


@pytest.mark.parametrize("b,t,h,nh", SHAPES)
def test_bf16_flash_fwd_plain_version_rounds_as_the_pallas_kernel(b, t, h,
                                                                   nh):
    """B3f's plain version: o at `_fwd_body`'s rounding points (qs =
    rnd(q rnd(scale)), p = rnd(e recip), the p . v sums in fp32, o rounded
    once), against `_fwd_kernel` through `flash_attention`, at the bar
    above."""
    rng = np.random.default_rng(b * t + h + 1)
    arrays = [rng.normal(size=(b, t, h)).astype(np.float32) for _ in range(3)]
    (q, k, v), js = _bf16(*arrays)
    want = jax.jit(lambda q, k, v: flash_attention(q, k, v, num_heads=nh)) \
        .lower(*js).compile(compiler_options=EXACT_BF16)(*js)
    got = flash_attention_fwd_reference(q, k, v, nh, 0.0, 0)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _assert_within_ulp("o", _np(got), _np(want))


@pytest.mark.parametrize("b,t,h,nh", SHAPES)
def test_bf16_fused_bwd_plain_version_rounds_as_the_pallas_kernel(
        b, t, h, nh, monkeypatch):
    """B2's plain version through `FusedQKVAttention`'s plain path: the dqkv
    its backward computes against the output of `_bwd_kernel_qkv` inside
    `jax.vjp` of `flash_attention_fused`, at the bar above. Then dx, dW and
    db, which both sides compute from dqkv by products summed in fp32 over
    3H or B x T terms: at most one bf16 ulp of the largest, their share of
    differing entries not bounded (a rare one-ulp flip of a dqkv entry moves
    every sum it enters: up to 13% of db at these shapes)."""
    rng = np.random.default_rng(b * t + h)
    x = rng.normal(size=(b, t, h)).astype(np.float32)
    w = (rng.normal(size=(h, 3 * h)) / h ** 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    do = rng.normal(size=(b, t, h)).astype(np.float32)
    (xt, wt, bt, dot), (xj, wj, bj, doj) = _bf16(x, w.T.copy(), bias, do)
    want, kernels = _jax_vjp(
        lambda x, w, bb: flash_attention_fused(x, w, bb, num_heads=nh),
        (xj, wj.T, bj), doj)
    (dqkv_want,) = kernels[0]  # the backward's one Pallas kernel

    seen = []

    def recorded(*args):
        seen.append(fqa.fused_qkv_attention_bwd_reference(*args))
        return seen[-1]

    monkeypatch.setattr(fqa, "fused_qkv_attention_bwd", recorded)
    leaves = [a.requires_grad_() for a in (xt, wt, bt)]
    fqa.FusedQKVAttention.apply(*leaves, nh, 0.0, 0).backward(dot)
    assert len(seen) == 1 and seen[0].dtype == torch.bfloat16
    _assert_within_ulp("dqkv", _np(seen[0]), _np(dqkv_want)[:b, :t])
    for name, g, w in zip(("dx", "dW", "db"), (xt.grad, wt.grad.T, bt.grad),
                          want):
        _assert_within_ulp(name, _np(g), _np(w), share=1.0)


@pytest.mark.parametrize("h,stride,shift,dtype,match", [
    (576, 1728, 0, torch.bfloat16, None), (200, 200, 0, torch.bfloat16, None),
    (48, 148, 0, torch.bfloat16, None),
    (36, 108, 0, torch.bfloat16, "multiple of 8"),
    (48, 144, 2, torch.bfloat16, "8-byte aligned"),
    (48, 150, 0, torch.bfloat16, "8-byte aligned"),
    (48, 144, 1, torch.bfloat16, "8-byte aligned"),
    (36, 108, 1, torch.float32, None), (48, 150, 0, torch.float32, None)])
def test_bwd_layout_rule(h, stride, shift, dtype, match):
    """The bf16 bodies' rule (H a multiple of 8, every operand's rows 8-byte
    aligned: bases and a row stride a multiple of 4), which B3f's, B2's and
    B3b's wrappers apply to CUDA tensors before any launch; float32 runs the
    scalar kernels and is not held to it."""
    buf = torch.zeros(2 * stride + shift, dtype=dtype)
    q = buf[shift:shift + h]
    do = torch.zeros(h, dtype=dtype)
    if match is None:
        check_bf16_body_layout("flash_attention_bwd", h, stride, q, do)
    else:
        with pytest.raises(ValueError, match=match):
            check_bf16_body_layout("flash_attention_bwd", h, stride, q, do)
