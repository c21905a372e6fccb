"""Fused QKV attention: the port against the JAX package's Pallas kernel
(`flash_attention_fused`, interpret mode on the CPU), and on the card the
CUDA kernel against its plain PyTorch version."""

import numpy as np
import pytest
import torch

from weathermodel_tpu.ops.pallas_attention import flash_attention_fused
from weathermodel_tpu_torch.ops.attention import resolve_attention_impl
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    bf16_max_context,
    check_wgmma_layout,
    fused_qkv_attention,
    fused_qkv_attention_reference,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401


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
    """The bf16 body's longest T at each head dim, from its shared-memory plan
    (csrc/attention_hopper.cuh: K^T, V^T and the q fragments of every 64-row
    tile beside a two-stage ring); the float32 body's is 453 at hd 36."""
    assert [bf16_max_context(hd) for hd in (12, 20, 28, 36)] == \
        [1728, 896, 768, 512]


@pytest.mark.parametrize("t,h,nh,shift,match", [
    (365, 576, 16, 0, None), (512, 576, 16, 0, None),
    (513, 576, 16, 0, "T up to 512 "), (1728, 48, 4, 0, None),
    (1729, 48, 4, 0, "T up to 1728 "), (24, 36, 3, 0, "multiple of 8"),
    (24, 48, 4, 1, "16-byte aligned")])
def test_wgmma_layout_rule(t, h, nh, shift, match):
    """The bf16 body's rule (H a multiple of 8, x and w_qkv 16-byte aligned,
    T up to `bf16_max_context`), which the three forward wrappers apply to
    CUDA tensors before any launch; float32 is not held to it."""
    buf = torch.zeros(t * h + shift, dtype=torch.bfloat16)
    x = buf[shift:].view(1, t, h)
    w = torch.zeros(3 * h, h, dtype=torch.bfloat16)
    if match is None:
        check_wgmma_layout("fused_qkv_attention", x, w, nh)
    else:
        with pytest.raises(ValueError, match=match):
            check_wgmma_layout("fused_qkv_attention", x, w, nh)
    check_wgmma_layout("fused_qkv_attention", x.float(), w.float(), nh)
