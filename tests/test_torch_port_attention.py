"""Fused QKV attention: the port against the JAX package's Pallas kernel
(`flash_attention_fused`, interpret mode on the CPU), in fp32 and in bf16
(the eval form's rounding points, fault C3) and at T = 1024 (fault C4), and
on the card the CUDA kernel against its plain PyTorch version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.ops.pallas_attention import (
    flash_attention_fused,
    flash_attention_fused_outproj,
)
from weathermodel_tpu_torch.ops.attention import (
    MAX_CONTEXT,
    check_context,
    resolve_attention_impl,
)
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    check_wgmma_layout,
    fused_qkv_attention,
    fused_qkv_attention_outproj,
    fused_qkv_attention_reference,
    fused_qkv_attention_train_reference,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

# bf16, the port's plain version against the Pallas kernel: both round at
# the same points, so all but a few entries agree bitwise; where fp32 sums in
# another order flip a rounding, an entry moves by about one bf16 ulp. The
# bar of the probes' tests (tests/test_torch_port_headpack.py).
DIFFER_SHARE = 1e-2


def _inputs(b, t, h, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h)).astype(np.float32)
    # JAX layout [H, 3H]; scale 1/sqrt(H) keeps q.k at the size the model's
    # init gives (0.2 at H=24, as in tests/test_pallas_fused_qkv.py)
    w = (rng.normal(size=(h, 3 * h)) / h ** 0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    return x, w, bias


# the shapes of tests/test_pallas_fused_qkv.py, plus WeatherBERT-large's
# full geometry (T=365, H=576, 16 heads of 36)
@pytest.mark.parametrize("b,t,h,nh", [(3, 13, 24, 2), (2, 128, 16, 4),
                                      (5, 37, 36, 3), (2, 365, 576, 16)])
def test_matches_jax_pallas_kernel(b, t, h, nh):
    x, w, bias = _inputs(b, t, h)
    want = np.asarray(flash_attention_fused(x, w, bias, num_heads=nh))
    got = fused_qkv_attention(torch.from_numpy(x),
                              torch.from_numpy(w.T.copy()),
                              torch.from_numpy(bias), nh)
    # the JAX package's own bar for this kernel vs plain attention
    # (tests/test_pallas_fused_qkv.py): fp32, sums in another order
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_rejects_bad_shapes():
    x = torch.zeros(2, 5, 24)
    with pytest.raises(ValueError, match="not divisible"):
        fused_qkv_attention(x, torch.zeros(72, 24), torch.zeros(72), 5)
    with pytest.raises(ValueError, match="w_qkv must be"):
        fused_qkv_attention(x, torch.zeros(24, 72), torch.zeros(72), 2)


def test_resolve_attention_impl():
    assert resolve_attention_impl("auto", "mini", mode="eval") == "fused_qkv"
    assert resolve_attention_impl("auto", "large") == "fused_qkv"
    assert resolve_attention_impl("torch", "large") == "torch"
    # mini/small training: the attention on separate q, k, v (B3)
    assert resolve_attention_impl("auto", "small", mode="train") == "flash"
    with pytest.raises(ValueError):
        resolve_attention_impl("pallas_qkv")


def test_bf16_max_context():
    """The kernels' one limit on T (csrc/attention_common.cuh's kMaxContext):
    1536 at every head dim, in both dtypes, past the bf16 body's resident
    K^T and V^T (512 at hd 36) and the scalar bodies' shared-memory rows
    (453), whose rows then stream from a device workspace."""
    assert MAX_CONTEXT == 1536
    check_context("fused_qkv_attention", MAX_CONTEXT)
    with pytest.raises(ValueError, match="T up to 1536, got T=1537"):
        check_context("fused_qkv_attention", MAX_CONTEXT + 1)


@pytest.mark.parametrize("t,h,nh,shift,match", [
    (365, 576, 16, 0, None), (512, 576, 16, 0, None),
    (513, 576, 16, 0, None), (1536, 576, 16, 0, None),
    (1537, 576, 16, 0, "T up to 1536,"), (1728, 48, 4, 0, "T up to 1536,"),
    (24, 36, 3, 0, "multiple of 8"), (24, 48, 4, 1, "16-byte aligned")])
def test_wgmma_layout_rule(t, h, nh, shift, match):
    """The bf16 body's rule (H a multiple of 8, x and w_qkv 16-byte aligned)
    and the limit on T every kernel has, which the forward wrappers apply to
    CUDA tensors before any launch; float32 is not held to the first."""
    buf = torch.zeros(t * h + shift, dtype=torch.bfloat16)
    x = buf[shift:].view(1, t, h)
    w = torch.zeros(3 * h, h, dtype=torch.bfloat16)

    def rules(x, w):
        check_context("fused_qkv_attention", x.shape[1])
        check_wgmma_layout("fused_qkv_attention", x, w, nh)

    if match is None:
        rules(x, w)
    else:
        with pytest.raises(ValueError, match=match):
            rules(x, w)
    if match is None or "T up to" not in match:
        rules(x.float(), w.float())


def _bf16(*arrays):
    """torch bf16 tensors and the same values as JAX bf16 arrays (exact)."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return ts, [jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in ts]


def _assert_within_ulp(got, want):
    """got, want fp32 numpy: max|got - want| at most one bf16 ulp of
    max|want|, and at most DIFFER_SHARE of the entries differ."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want).max()
    assert err <= ulp, (err, ulp)
    share = (got != want).mean()
    assert share <= DIFFER_SHARE, share


def test_bf16_eval_form_rounds_as_the_pallas_kernel():
    """Fault C3: in bf16 the eval form scales q before the scores (qs =
    rnd(q rnd(scale))) and rounds p = rnd(e recip), as `_fwd_body` does for
    every form, at WeatherBERT-large's geometry (T=365, H=576, 16 heads of
    36); dividing the fp32 scores instead made about half the outputs
    differ."""
    x, w, bias = _inputs(1, 365, 576, seed=3)
    (xt, wt, bt), (xj, wj, bj) = _bf16(x, w.T.copy(), bias)
    want = flash_attention_fused(xj, wj.T, bj, num_heads=16)
    got = fused_qkv_attention(xt, wt, bt, 16)
    _assert_within_ulp(got.float().numpy(),
                       np.asarray(want.astype(jnp.float32)))


def test_bf16_outproj_plain_version_rounds_as_the_pallas_kernel():
    """Fault C3 in kernel B5's first phase (the eval form): its plain
    version against `flash_attention_fused_outproj` (impl pallas_qkv_op) in
    bf16, at a narrow width."""
    x, w, bias = _inputs(2, 96, 48, seed=4)
    rng = np.random.default_rng(5)
    wo = (rng.normal(size=(48, 48)) / 48 ** 0.5).astype(np.float32)
    bo = (rng.normal(size=(48,)) * 0.1).astype(np.float32)
    (xt, wt, bt, wot, bot), (xj, wj, bj, woj, boj) = _bf16(
        x, w.T.copy(), bias, wo.T.copy(), bo)
    want = flash_attention_fused_outproj(xj, wj.T, bj, woj.T, boj,
                                         num_heads=4)
    got = fused_qkv_attention_outproj(xt, wt, bt, wot, bot, 4)
    _assert_within_ulp(got.float().numpy(),
                       np.asarray(want.astype(jnp.float32)))


def test_long_context_t1024():
    """Fault C4: the eval form's and the training form's (dropout 0) plain
    versions at T = 1024, which the JAX kernel takes
    (tests/test_pallas_attention.py's test_long_context_t1024), at a narrow
    width (4 heads of 12), with that test's tolerance."""
    x, w, bias = _inputs(1, 1024, 48, seed=7)
    want = np.asarray(flash_attention_fused(x, w, bias, num_heads=4))
    args = (torch.from_numpy(x), torch.from_numpy(w.T.copy()),
            torch.from_numpy(bias), 4)
    for got in (fused_qkv_attention(*args),
                fused_qkv_attention_train_reference(*args, 0.0, 0)[0]):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-3)
