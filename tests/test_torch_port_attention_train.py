"""The fused QKV attention's training form and backward in the port: the
autograd Function's plain path against `jax.vjp` through the JAX package's
`flash_attention_fused` (Pallas interpret mode on the CPU, as
tests/test_pallas_fused_qkv.py runs it), and the dropout keep-mask's
properties."""

import jax
import numpy as np
import pytest
import torch

from weathermodel_tpu.ops.pallas_attention import flash_attention_fused
from weathermodel_tpu_torch.ops.attention import (
    attention_keep_mask,
    dropout_params,
    torch_attention,
)
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    FusedQKVAttention,
    fused_qkv_attention_bwd_reference,
    fused_qkv_attention_reference,
    fused_qkv_attention_train_reference,
)


def _inputs(b, t, h, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h)).astype(np.float32)
    w = (rng.normal(size=(h, 3 * h)) / h ** 0.5).astype(np.float32)  # [H, 3H]
    bias = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    do = rng.normal(size=(b, t, h)).astype(np.float32)
    return x, w, bias, do


def _port_grads(x, w, bias, do, nh, rate=0.0, seed=0):
    """o, dx, dW (JAX layout [H, 3H]) and db through FusedQKVAttention."""
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    o = FusedQKVAttention.apply(xt, wt, bt, nh, rate, seed)
    o.backward(torch.from_numpy(do))
    return (o.detach().numpy(), xt.grad.numpy(), wt.grad.numpy().T,
            bt.grad.numpy())


# the shapes of tests/test_pallas_fused_qkv.py, plus WeatherBERT-large's
# full geometry (T=365, H=576, 16 heads of 36)
@pytest.mark.parametrize("b,t,h,nh", [(3, 13, 24, 2), (2, 37, 36, 3),
                                      (1, 365, 576, 16)])
def test_matches_jax_pallas_vjp(b, t, h, nh):
    x, w, bias, do = _inputs(b, t, h)
    o_jax, vjp = jax.vjp(
        lambda x, w, bias: flash_attention_fused(x, w, bias, num_heads=nh),
        x, w, bias)
    want = (o_jax, *vjp(do))
    got = _port_grads(x, w, bias, do, nh)
    # fp32, sums in another order: the JAX package's bar for this kernel
    for name, a, e in zip(("o", "dx", "dW", "db"), got, want):
        np.testing.assert_allclose(a, np.asarray(e), atol=5e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bwd_reference_is_autograd_of_train_reference(rate):
    """B2's plain version regenerates the forward's keep-mask from the seed:
    it equals autograd through the training forward's plain version."""
    x, w, bias, do = _inputs(2, 29, 48, seed=1)
    seed = 987654321
    got = _port_grads(x, w, bias, do, 4, rate, seed)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    o, _ = fused_qkv_attention_train_reference(xt, wt, bt, 4, rate, seed)
    o.backward(torch.from_numpy(do))
    want = (o.detach().numpy(), xt.grad.numpy(), wt.grad.numpy().T,
            bt.grad.numpy())
    for name, a, e in zip(("o", "dx", "dW", "db"), got, want):
        np.testing.assert_allclose(a, e, atol=1e-5, rtol=1e-5, err_msg=name)
    if rate:
        # another seed in the backward is another mask: other gradients
        _, qkv = fused_qkv_attention_train_reference(
            xt.detach(), wt.detach(), bt.detach(), 4, rate, seed)
        g = torch.from_numpy(do)
        assert not torch.allclose(
            fused_qkv_attention_bwd_reference(qkv, g, 4, rate, seed),
            fused_qkv_attention_bwd_reference(qkv, g, 4, rate, seed + 1))


def test_keep_mask_rate_and_seeds():
    b, nh, t, rate = 4, 16, 97, 0.1
    keep = attention_keep_mask(7, b, nh, t, rate, "cpu")
    assert keep.shape == (b, nh, t, t) and keep.dtype == torch.bool
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * sigma
    assert torch.equal(keep, attention_keep_mask(7, b, nh, t, rate, "cpu"))
    other = attention_keep_mask(8, b, nh, t, rate, "cpu")
    # independent masks agree on p^2 + (1-p)^2 of the entries
    agree = (keep == other).float().mean().item()
    assert abs(agree - (rate ** 2 + (1 - rate) ** 2)) < 0.01
    # a row is the same whatever batch it is drawn in (chunking is exact)
    big = attention_keep_mask(7, 300, 1, 8, rate, "cpu")
    assert torch.equal(big[:4, 0], attention_keep_mask(7, 4, 1, 8, rate,
                                                       "cpu")[:, 0])
    assert dropout_params(0.1)[1] == int(0.9 * 4294967296.0)
    with pytest.raises(ValueError):
        attention_keep_mask(2 ** 32, 1, 1, 4, rate, "cpu")


def test_dropout_zeroes_the_masked_weights():
    """With v = identity the forward's output rows are the dropped weights:
    zero exactly where the keep-mask is False, w / (1 - p) elsewhere."""
    t, rate, seed = 6, 0.3, 11
    h = t  # one head of width t
    x = torch.eye(t)[None]
    w = torch.zeros(3 * h, h)
    w[2 * h:] = torch.eye(h)  # q = k = 0 (uniform weights), v = x
    o, _ = fused_qkv_attention_train_reference(x, w, torch.zeros(3 * h), 1,
                                               rate, seed)
    keep = attention_keep_mask(seed, 1, 1, t, rate, "cpu")[0, 0]
    expected = torch.where(keep, torch.full((t, t), 1 / t / (1 - rate)),
                           torch.zeros(()))
    torch.testing.assert_close(o[0], expected)
    # the plain attention path drops with the same rule
    q = k = torch.zeros(1, t, h)
    torch.testing.assert_close(torch_attention(q, k, x, 1, rate, seed)[0],
                               expected)


def test_train_form_without_dropout_is_the_eval_form():
    x, w, bias, _ = _inputs(2, 37, 36)
    args = (torch.from_numpy(x), torch.from_numpy(w.T.copy()),
            torch.from_numpy(bias), 3)
    o, qkv = fused_qkv_attention_train_reference(*args, 0.0, 0)
    assert qkv.shape == (2, 37, 108)
    torch.testing.assert_close(o, fused_qkv_attention_reference(*args),
                               atol=1e-6, rtol=1e-5)
