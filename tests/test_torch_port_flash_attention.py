"""The attention on separate q, k, v in the port (kernels B3f/B3b): the
autograd Function's plain path against `jax.vjp` through the JAX package's
`flash_attention` (Pallas interpret mode on the CPU, as tests/conftest.py
sets it), B3b's plain version against autograd through B3f's, and the
shared keep-mask with the fused kernel's training form."""

import jax
import numpy as np
import pytest
import torch

from weathermodel_tpu.ops.pallas_attention import flash_attention
from weathermodel_tpu_torch.ops.attention import resolve_attention_impl
from weathermodel_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
)
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    fused_qkv_attention_train_reference,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401


def _inputs(b, t, h, seed=0):
    """q, k, v and do [B, T, H]; q and k at the size the model's init gives
    their product (as tests/test_torch_port_attention.py)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, t, h)).astype(np.float32)
                   for _ in range(4))
    return q / h ** 0.25, k / h ** 0.25, v, do


def _port(q, k, v, do, nh, rate=0.0, seed=0):
    """o, dq, dk, dv through FlashAttention (its plain path on the CPU)."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FlashAttention.apply(qt, kt, vt, nh, rate, seed)
    o.backward(torch.from_numpy(do))
    return (o.detach().numpy(), *(a.grad.numpy() for a in (qt, kt, vt)))


# the shapes of tests/test_torch_port_attention_train.py's small cases, and
# WeatherFormer-small's full geometry (T=365, H=200, 10 heads of 20)
@pytest.mark.parametrize("b,t,h,nh", [(3, 13, 24, 2), (2, 37, 36, 3),
                                      (1, 365, 200, 10)])
def test_matches_jax_pallas_vjp(b, t, h, nh):
    q, k, v, do = _inputs(b, t, h)
    o_jax, vjp = jax.vjp(
        lambda q, k, v: flash_attention(q, k, v, num_heads=nh), q, k, v)
    want = (o_jax, *vjp(do))
    got = _port(q, k, v, do, nh)
    # fp32, sums in another order: the bar of B1/B2 against the JAX package
    for name, a, e in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, np.asarray(e), atol=5e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_reference_is_autograd_of_fwd_reference(rate):
    """B3b's plain version regenerates B3f's keep-mask from the seed: it
    equals autograd through B3f's plain version; another seed is another
    mask."""
    q, k, v, do = _inputs(2, 29, 48, seed=1)
    seed = 123456789
    got = _port(q, k, v, do, 4, rate, seed)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = flash_attention_fwd_reference(qt, kt, vt, 4, rate, seed)
    o.backward(torch.from_numpy(do))
    want = (o.detach().numpy(), *(a.grad.numpy() for a in (qt, kt, vt)))
    for name, a, e in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, e, atol=1e-5, rtol=1e-5, err_msg=name)
    if rate:
        args = (*(torch.from_numpy(a) for a in (q, k, v, do)), 4, rate)
        assert not torch.allclose(
            flash_attention_bwd_reference(*args, seed)[0],
            flash_attention_bwd_reference(*args, seed + 1)[0])


def test_packed_slices_are_the_fused_training_form():
    """B3f on the column slices of B1's packed qkv is B1's training form
    with the same seed (one keep-mask), in both dtypes; the wrapper takes
    the slices on a CPU tensor as they are."""
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor(rng.normal(size=(2, 21, 48)), dtype=dtype)
        w = torch.tensor(rng.normal(size=(144, 48)) / 7, dtype=dtype)
        b = torch.tensor(rng.normal(size=(144,)) * 0.1, dtype=dtype)
        o, qkv = fused_qkv_attention_train_reference(x, w, b, 4, 0.1, 5)
        q, k, v = qkv.chunk(3, dim=-1)
        assert torch.equal(flash_attention_fwd_reference(q, k, v, 4, 0.1, 5),
                           o)
        do = torch.tensor(rng.normal(size=(2, 21, 48)), dtype=dtype)
        for a, e in zip(flash_attention_bwd(q, k, v, do, 4, 0.1, 5),
                        flash_attention_bwd_reference(
                            *(t.contiguous() for t in (q, k, v)), do, 4, 0.1,
                            5)):
            assert torch.equal(a, e)


def test_rejects_bad_shapes_and_auto_picks_flash_for_small_training():
    q = torch.zeros(2, 5, 24)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention_fwd_reference(q, q, torch.zeros(2, 5, 12), 2, 0.0, 0)
    with pytest.raises(ValueError, match="not divisible"):
        flash_attention_fwd_reference(q, q, q, 5, 0.0, 0)
    # the JAX rule (weathermodel_tpu/ops/attention.py:54-56): "pallas" there
    assert resolve_attention_impl("auto", "small") == "flash"
    assert resolve_attention_impl("auto", "mini", mode="train") == "flash"
    assert resolve_attention_impl("auto", "small", mode="eval") == "fused_qkv"
