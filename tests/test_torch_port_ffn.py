"""The port's fused FFN ops against the JAX package's Pallas FFN kernels (run
in interpret mode, tests/conftest.py): `fused_ffn_ln` (B6f/B6b) against
`pallas_ffn.fused_ffn_ln` and `fused_ffn` (B7) against
`pallas_ffn2.fused_ffn`, output and every gradient; the encoder layer and
WeatherBERT-mini with `ffn_impl` "fused_ffn_ln"/"fused_ffn" against the JAX
"pallas"/"pallas2"; a short Adam trajectory against JAX "pallas"; and, in
the port alone, the FFN sites' hash keep-mask and the backwards with dropout
on. On the CPU the wrappers run their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models.blocks import (
    TransformerEncoderLayer as JaxEncoderLayer,
)
from weathermodel_tpu.ops import pallas_ffn, pallas_ffn2
from weathermodel_tpu.train.steps import Batch as JaxBatch
from weathermodel_tpu.train.steps import _objective_losses
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli.pretrain import PORTED_MODELS, make_model
from weathermodel_tpu_torch.models.blocks import (
    FFN_IMPLS,
    TransformerEncoderLayer,
)
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.ops.dropout import ffn_keep_mask
from weathermodel_tpu_torch.ops.fused_ffn import FusedFFN, fused_ffn_reference
from weathermodel_tpu_torch.ops.fused_ffn_ln import (
    FusedFFNLN,
    check_wgmma_layout,
    fp32_vectors,
    fused_ffn_ln_reference,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.steps import (
    Batch,
    batch_to_device,
    make_train_step,
)
from weathermodel_tpu_torch.utils.config import model_config_for_size

T = 16
# port ffn_impl -> the JAX layer's
JAX_FFN = {"torch": "xla", "fused_ffn_ln": "pallas", "fused_ffn": "pallas2"}
GRAD_NAMES = ("x", "w1", "b1", "w2", "b2", "ln_scale", "ln_bias")


def _ffn_arrays(lead, h, f, seed):
    """x [*lead, h], W1 [h, f], b1, W2 [f, h], b2, LN scale and bias, and a
    cotangent, as tests/test_pallas_ffn.py scales them."""
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(*lead, h)), rng.normal(size=(h, f)) * 0.1,
            rng.normal(size=f) * 0.1, rng.normal(size=(f, h)) * 0.1,
            rng.normal(size=h) * 0.1, 1 + 0.1 * rng.normal(size=h),
            0.1 * rng.normal(size=h), rng.normal(size=(*lead, h)))
    return [a.astype(np.float32) for a in arrs]


def _port_grads(fn, arrays, cotangent):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*leaves)
    out.backward(torch.from_numpy(cotangent))
    return out.detach().numpy(), [a.grad.numpy() for a in leaves]


# tests/test_pallas_ffn.py's shapes (B, T, H, F): its default and a T that
# its kernel pads to 128
@pytest.mark.parametrize("b,t,h,f", [(4, 20, 48, 192), (3, 37, 32, 128)])
def test_fused_ffn_ln_matches_jax(b, t, h, f):
    """fp32, rate 0: out at tests/test_pallas_ffn.py's forward bar (2e-5,
    1e-4) and all seven gradients against jax.vjp at its gradient bar (5e-4,
    5e-3)."""
    *args, g = _ffn_arrays((b, t), h, f, seed=b)
    want, vjp = jax.vjp(pallas_ffn.fused_ffn_ln,
                        *(jnp.asarray(a) for a in args))
    want_grads = vjp(jnp.asarray(g))
    got, got_grads = _port_grads(
        lambda *a: FusedFFNLN.apply(*a, 0.0, (0, 0)), args, g)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-4)
    for name, a, w in zip(GRAD_NAMES, got_grads, want_grads):
        np.testing.assert_allclose(a, np.asarray(w), atol=5e-4, rtol=5e-3,
                                   err_msg=name)


@pytest.mark.parametrize("m", [96, 300])
def test_fused_ffn_matches_jax(m):
    """fp32, rate 0: f and the five gradients against jax.vjp through
    pallas_ffn2.fused_ffn (M = 300 is not a multiple of its 256-row block),
    at tests/test_pallas_ffn2.py's bars (2e-5 forward, 5e-4 gradients)."""
    x, w1, b1, w2, b2, _, _, g = _ffn_arrays((m,), 64, 256, seed=m)
    args = (x, w1, b1, w2, b2)
    want, vjp = jax.vjp(
        lambda *a: pallas_ffn2.fused_ffn(*a, jnp.zeros((), jnp.int32), 0.0),
        *(jnp.asarray(a) for a in args))
    want_grads = vjp(jnp.asarray(g))
    got, got_grads = _port_grads(lambda *a: FusedFFN.apply(*a, 0.0, (0, 0)),
                                 args, g)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    for name, a, w in zip(GRAD_NAMES, got_grads, want_grads):
        np.testing.assert_allclose(a, np.asarray(w), atol=5e-4, rtol=5e-4,
                                   err_msg=name)


def _layer_state_dict(params):
    """A JAX encoder layer's params as the port layer's state dict (through
    the model converter, wrapped as layer 0 of a model)."""
    stub = {"kernel": np.zeros((1, 1), np.float32),
            "bias": np.zeros(1, np.float32)}
    sd = state_dict_from_jax_params({"core": {
        "in_proj": stub, "encoder": {"layer_0": params["params"]}}})
    prefix = "transformer_encoder.layers.0."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _assert_bf16_close(got, want):
    """The model tests' bf16 bar: the frameworks' bf16 matmuls and
    reductions sum in other orders, so values near a rounding boundary land
    one bf16 ulp apart: max|diff| <= 5e-2 RMS and RMS(diff) <= 1e-2 RMS."""
    rms = np.sqrt(np.mean(want ** 2))
    diff = got - want
    assert np.abs(diff).max() <= 5e-2 * rms
    assert np.sqrt(np.mean(diff ** 2)) <= 1e-2 * rms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ffn_impl", ["fused_ffn_ln", "fused_ffn"])
def test_encoder_layer_matches_jax(ffn_impl, dtype):
    """One post-LN layer (plain attention on both sides), eval: fp32 at 2e-5,
    bf16 at the model tests' (max, RMS) bars."""
    h, nh, f = 48, 4, 192
    x = np.random.default_rng(1).normal(size=(3, T, h)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    layer = JaxEncoderLayer(h, nh, f, attention_impl="xla", dtype=jdt,
                            ffn_impl=JAX_FFN[ffn_impl])
    params = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x)))
    want = np.asarray(layer.apply(params, jnp.asarray(x, jdt)),
                      np.float32)
    port = TransformerEncoderLayer(h, nh, f, "torch", ffn_impl)
    port.load_state_dict(_layer_state_dict(params))
    with torch.inference_mode():
        got, aux = port(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert aux is None
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    else:
        _assert_bf16_close(got, want)


def _inputs(b=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, T, 31)).astype(np.float32),
            rng.uniform(-90, 90, size=(b, 2)).astype(np.float32),
            (1985.0 + np.arange(T, dtype=np.float32) / 52.0
             + rng.integers(0, 15, size=(b, 1))).astype(np.float32),
            np.full((b, 1), 7.0, np.float32), rng.random((b, T, 31)) < 0.15)


@pytest.fixture(scope="module")
def mini_params():
    cfg = jax_config_for_size("mini", max_len=T)
    params = JaxWeatherBERT(cfg).init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in _inputs(1)))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ffn_impl", ["fused_ffn_ln", "fused_ffn"])
def test_weatherbert_mini_matches_jax(mini_params, ffn_impl, dtype):
    """WeatherBERT-mini eval forward, plain attention: fp32 at 2e-5 against
    the JAX model with the matching ffn_impl, bf16 at the (max, RMS) bars."""
    inputs = _inputs()
    jcfg = jax_config_for_size("mini", max_len=T, compute_dtype=dtype)
    want = np.asarray(JaxWeatherBERT(
        jcfg, attention_impl="xla", ffn_impl=JAX_FFN[ffn_impl]).apply(
        mini_params, *(jnp.asarray(a) for a in inputs)))
    cfg = model_config_for_size("mini", max_len=T, compute_dtype=dtype)
    model = make_model("weatherbert", cfg, "torch", ffn_impl).eval()
    model.load_state_dict(state_dict_from_jax_params(mini_params))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in inputs)).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    else:
        _assert_bf16_close(got, want)


def test_short_trajectory_matches_jax_pallas_ffn(mini_params):
    """8 Adam steps at mini, fp32, injected masks, dropout off: the port's
    fused_ffn_ln (and plain attention) against JAX ffn_impl="pallas", at
    the bars of tests/test_torch_port_train_step.py (step 0 loss rtol 1e-5,
    its gradients 1e-5/1e-4; the trajectory rtol 1e-2)."""
    n, b, lr = 8, 4, 1e-3
    rng = np.random.default_rng(3)
    weather = rng.normal(size=(n, b, T, 31)).astype(np.float32)
    masks = rng.random((n, b, T, 31)) < 0.15
    _, coords, year, interval, _ = _inputs(b, seed=4)
    model = JaxWeatherBERT(jax_config_for_size("mini", max_len=T),
                           attention_impl="xla", ffn_impl="pallas")
    tx = optax.adam(lr)

    @jax.jit
    def jax_step(params, opt_state, w, m):
        def loss_fn(p):
            batch = JaxBatch(w, jnp.asarray(coords), jnp.asarray(year),
                             jnp.asarray(interval))
            return _objective_losses(model, "masked_mse", p, batch, m, 1.0,
                                     deterministic=True, rngs=None,
                                     sample_key=None)["total_loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    port = make_model("weatherbert", model_config_for_size("mini", max_len=T),
                      "torch", "fused_ffn_ln")
    port.load_state_dict(state_dict_from_jax_params(mini_params))
    step = make_train_step(port, make_optimizer(port), "weatherbert")
    params, opt_state = mini_params, tx.init(mini_params)
    jax_losses, port_losses = [], []
    for i in range(n):
        params, opt_state, loss, grads = jax_step(
            params, opt_state, jnp.asarray(weather[i]), jnp.asarray(masks[i]))
        jax_losses.append(float(loss))
        out = step(batch_to_device(Batch(weather[i], coords, year, interval),
                                   "cpu"),
                   torch.Generator().manual_seed(0), lr, 1,
                   mask=torch.from_numpy(masks[i]), dropout_rate=0.0)
        port_losses.append(float(out["total_loss"]))
        if i == 0:
            want = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
            for k, p in port.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                           atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=1e-5)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-2)
    assert port_losses[-1] < port_losses[0]


def test_state_dict_keys_do_not_depend_on_ffn_impl():
    cfg = model_config_for_size("mini", max_len=T)
    for name in PORTED_MODELS:
        keys = [list(make_model(name, cfg, "torch", impl).state_dict())
                for impl in FFN_IMPLS]
        assert all(k == keys[0] for k in keys), name


def test_ffn_keep_mask_rate_and_determinism():
    """Keep rate within 5 binomial standard deviations of 1 - p over 10^6
    draws, per row and per column not degenerate; a pure function of
    (seed, row, col), whatever the chunking."""
    rate = 0.1
    keep = ffn_keep_mask(123, 4000, 250, rate, "cpu")
    n = keep.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) <= 5 * sigma
    for axis in (0, 1):
        per = keep.float().mean(dim=axis)
        assert per.min() > 0.7 and per.max() < 1.0
    assert torch.equal(keep[:7], ffn_keep_mask(123, 7, 250, rate, "cpu"))
    other = ffn_keep_mask(124, 4000, 250, rate, "cpu")
    assert abs((keep == other).float().mean().item()
               - (0.9 ** 2 + 0.1 ** 2)) < 0.01
    assert ffn_keep_mask(0, 3, 5, 0.0, "cpu").all()
    with pytest.raises(ValueError):
        ffn_keep_mask(2 ** 32, 1, 1, rate, "cpu")


@pytest.mark.parametrize("op", ["fused_ffn", "fused_ffn_ln"])
def test_backward_with_dropout_is_autograd_of_the_plain_version(op):
    """fp32, rate 0.1: B7's plain backward, which reads the masks back from
    the zeros of f and h, and B6b's plain version, which regenerates them
    from the seeds, equal autograd through the plain forward with the same
    hash masks."""
    x, w1, b1, w2, b2, ls, lb, g = _ffn_arrays((120,), 48, 192, seed=5)
    seeds = (9, 10)
    if op == "fused_ffn":
        args = (x, w1, b1, w2, b2)
        fn = lambda *a: FusedFFN.apply(*a, 0.1, seeds)  # noqa: E731
        ref = lambda *a: fused_ffn_reference(*a, 0.1, seeds)[0]  # noqa: E731
    else:
        args = (x, w1, b1, w2, b2, ls, lb)
        fn = lambda *a: FusedFFNLN.apply(*a, 0.1, seeds)  # noqa: E731
        ref = lambda *a: fused_ffn_ln_reference(*a, 0.1, seeds)  # noqa: E731
    got, got_grads = _port_grads(fn, args, g)
    want, want_grads = _port_grads(ref, args, g)
    np.testing.assert_array_equal(got, want)
    dropped = (got == 0).mean() if op == "fused_ffn" else None
    if dropped is not None:
        assert 0.05 < dropped < 0.15
    for name, a, w in zip(GRAD_NAMES, got_grads, want_grads):
        np.testing.assert_allclose(a, w, atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("h,f,shift,match", [
    (52, 192, 0, "multiples of 8"),     # H not a multiple of 8
    (48, 100, 0, "multiples of 8"),     # F not a multiple of 8
    (48, 192, 1, "16-byte aligned"),    # x 2 bytes off a 16-byte boundary
    (576, 2304, 0, None),               # WeatherBERT-large: taken
    (200, 800, 0, None),                # small: taken
])
def test_wgmma_layout_rule(h, f, shift, match):
    """The bf16 forward body's layout rule (H and F multiples of 8, 16-byte
    aligned x and weights, as TMA needs), which the wrappers apply to CUDA
    tensors before any launch; float32 takes any width."""
    buf = torch.zeros(4 * h + shift, dtype=torch.bfloat16)
    x = buf[shift:].view(4, h)
    w1 = torch.zeros(h, f, dtype=torch.bfloat16)
    w2 = torch.zeros(f, h, dtype=torch.bfloat16)
    if match is None:
        check_wgmma_layout("fused_ffn", x, w1, w2)
    else:
        with pytest.raises(ValueError, match=match):
            check_wgmma_layout("fused_ffn", x, w1, w2)
    check_wgmma_layout("fused_ffn", x.float(), w1.float(), w2.float())


@pytest.mark.parametrize("offset", [0, 1, 2])
def test_kernel_vectors_are_8_byte_aligned_fp32(offset):
    """The wrappers hand the kernels their biases and LN parameters as
    contiguous fp32 at an 8-byte boundary (the bf16 body reads them in
    pairs): a view at an odd offset is copied, values unchanged; an aligned
    fp32 vector is passed as it is."""
    buf = torch.arange(10, dtype=torch.float32)
    v = buf[offset:offset + 6]
    got, = fp32_vectors(v)
    assert got.dtype == torch.float32 and got.data_ptr() % 8 == 0
    assert torch.equal(got, v)
    assert (got.data_ptr() == v.data_ptr()) == (v.data_ptr() % 8 == 0)
    half, = fp32_vectors(v.bfloat16())
    assert half.dtype == torch.float32 and half.data_ptr() % 8 == 0
