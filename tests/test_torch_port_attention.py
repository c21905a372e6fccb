"""Fused QKV attention: the port against the JAX package's Pallas kernel
(`flash_attention_fused`, interpret mode on the CPU), and on the card the
CUDA kernel against its plain PyTorch version."""

import numpy as np
import pytest
import torch

from weathermodel_tpu.ops.pallas_attention import flash_attention_fused
from weathermodel_tpu_torch.ops.attention import resolve_attention_impl
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_reference,
)


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resolve_attention_impl("auto", "small", mode="train")
    with pytest.raises(ValueError):
        resolve_attention_impl("pallas_qkv")
