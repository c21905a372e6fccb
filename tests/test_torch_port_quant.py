"""Int8 (W8A8) serving of the port against the JAX package on the CPU:
ops/quant.py's four ops bit for bit (equal int8 codes, bitwise-equal
outputs, fp32 and bf16, K up to 2304), the dense encoder layer in int8,
int8_static (attention out-projection off and on) and calibrate with the
JAX `quant` collection carried across (models/transfer.py), the
calibration of serve.calibrate_quant_scales, and the int8_static
predictor's hot reload.

The ops are exact: the same int8 codes from the same inputs, an exact int32
sum, and the same single fp32 roundings. A layer or a model is not: its
float part upstream of a quantizer (attention, LayerNorm, the FFN's first
matmul) differs from JAX by about 1e-6, and that moves an input that lies
within 1e-6 of a code's rounding boundary (x / scale = n + 1/2) to the
other code. A flipped code moves the product it feeds by one step of its
scale, (amax / 127) x |w|, so those comparisons hold the output to
INT8_TOL: an RMS of the difference at 1e-4 of the output's RMS and a
largest difference at 1e-2 of it, where the float path agrees to 2e-5 and
a wrong scale or code table would miss by 1e-2 and more."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models.blocks import (
    TransformerEncoderLayer as JaxLayer,
)
from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.ops import pallas_gmm
from weathermodel_tpu.ops import quant as jax_quant
from weathermodel_tpu.serve import (
    calibrate_quant_scales as jax_calibrate_quant_scales,
)
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models.blocks import TransformerEncoderLayer
from weathermodel_tpu_torch.models.transfer import (
    load_quant_scales,
    quant_scales_from_jax,
    state_dict_from_jax_params,
)
from weathermodel_tpu_torch.ops import quant
from weathermodel_tpu_torch.serve import (
    calibrate_quant_scales,
    load_weather_predictor,
    reload_predictor_params,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from test_torch_port_jax_params import (
    encoder_layer_state_dict,
    jax_params_from_state,
    seeded_encoder_layer,
)
from weathermodel_tpu_torch.utils.config import model_config_for_size

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# whole layers and models in int8 (module docstring): (RMS, max) of
# |port - JAX| over the RMS of JAX's output
INT8_TOL = (1e-4, 1e-2)
H, NH, F, T = 48, 4, 192, 24


@pytest.fixture
def attn_out_quant():
    """Turn the attention out-projection's int8_static on in both packages
    for one test, and off again after it."""
    quant.set_attn_out_quant(True)
    jax_quant.set_attn_out_quant(True)
    yield
    quant.set_attn_out_quant(False)
    jax_quant.set_attn_out_quant(False)


def _pair(a, dtype):
    """(torch tensor, jax array) of the numpy array `a` in `dtype`."""
    t_dtype, j_dtype = DTYPES[dtype]
    return (torch.from_numpy(a).to(t_dtype),
            jnp.asarray(a, jnp.float32).astype(j_dtype))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if isinstance(a, jax.Array) else a.float().numpy()


def _assert_bitwise(got, want, what):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=what)
    assert _np(got).dtype == _np(want).dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [48, 2304])
def test_int8_ops_match_jax_bitwise(dtype, k):
    """quantize_int8 (codes and scales along either axis), int8_dense,
    int8_dense_static (per-channel and scalar amax) and int8_expert_einsum
    on the same numpy inputs, against the jitted JAX ops (the serving
    path's form). At K = 2304 an int32 sum reaches ~3.7e7, past fp32's
    2^24: only an exact accumulator matches."""
    rng = np.random.default_rng(k)
    m, o, e = 40, 64, 3
    x_np = rng.normal(size=(2, m // 2, k)).astype(np.float32)
    x_np[0, 0] = 0.0  # a zero row (a padded bucket row)
    w_np = (rng.normal(size=(k, o)) / np.sqrt(k)).astype(np.float32)
    b_np = rng.normal(size=o).astype(np.float32)
    amax_np = (np.abs(x_np).max(axis=(0, 1)) * 0.8).astype(np.float32)
    ex_np = rng.normal(size=(e, m, k)).astype(np.float32)
    ex_np[1, 5:] = 0.0  # capacity padding rows
    ew_np = (rng.normal(size=(e, k, o)) / np.sqrt(k)).astype(np.float32)
    eamax_np = (np.abs(ex_np).max(axis=1) * 0.9).astype(np.float32)
    eamax_np[2] = 0.0  # an amax of 0 takes the 1e-8 floor
    x, jx = _pair(x_np, dtype)
    ex, jex = _pair(ex_np, dtype)
    w, b = torch.from_numpy(w_np.T.copy()), torch.from_numpy(b_np)
    ew = torch.from_numpy(ew_np)

    for axis in (0, -1):
        q, s = quant.quantize_int8(x, axis)
        jq, js = jax.jit(jax_quant.quantize_int8, static_argnums=1)(jx, axis)
        _assert_bitwise(q, jq, f"codes, axis {axis}")
        _assert_bitwise(s, js, f"scales, axis {axis}")
    _assert_bitwise(
        quant.int8_dense(x, w, b),
        jax.jit(jax_quant.int8_dense)(jx, w_np, b_np), "int8_dense")
    for amax in (amax_np, np.float32(amax_np.max())):
        _assert_bitwise(
            quant.int8_dense_static(x, w, torch.tensor(amax), b),
            jax.jit(jax_quant.int8_dense_static)(jx, w_np, amax, b_np),
            f"int8_dense_static, amax {np.shape(amax)}")
    _assert_bitwise(
        quant.int8_expert_einsum(ex, ew, torch.from_numpy(eamax_np)),
        jax.jit(jax_quant.int8_expert_einsum)(jex, ew_np, eamax_np),
        "int8_expert_einsum")


def test_int8_codes_of_the_static_activation_pass():
    """The calibrated activation pass's codes, clip(round(x / s)), against
    JAX's expression: half to even at the .5 boundaries (x = (n + 1/2) s
    exactly), saturation past the calibrated range."""
    amax = np.float32(127.0)  # scale 1: x itself is x / s
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 300.0, -300.0]],
                 np.float32)
    scale = np.maximum(amax, 1e-8).astype(np.float32) / 127.0
    want = np.clip(np.round(jnp.asarray(x) / scale), -127, 127)
    got = quant._codes(torch.from_numpy(x), quant._static_scale(
        torch.tensor(amax)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[0, :6], [0, 2, 2, 0, -2, 126])


def test_int_mm_on_the_card_takes_only_its_shapes():
    """The card's int8 GEMM takes more than 16 rows and K and N multiples
    of 8; the check names the shape (no fallback to a float matmul)."""
    a = torch.zeros(16, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\[16, 32\] x \[32, 8\]"):
        quant._check_int_mm(a, torch.zeros(32, 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="multiples of 8"):
        quant._check_int_mm(torch.zeros(17, 36, dtype=torch.int8),
                            torch.zeros(36, 8, dtype=torch.int8))
    quant._check_int_mm(torch.zeros(17, 32, dtype=torch.int8),
                        torch.zeros(32, 8, dtype=torch.int8))
    assert torch.equal(quant.int_mm(torch.ones(2, 3, dtype=torch.int8),
                                    torch.ones(3, 2, dtype=torch.int8)),
                       torch.full((2, 2), 3, dtype=torch.int32))


def _layer_pair(ffn_impl, seed=0):
    """A JAX dense encoder layer's params and the port's layer with them:
    the port's seeded init as the flax tree (test_torch_port_jax_params.py)."""
    jlayer = JaxLayer(H, NH, F, dropout_rate=0.0, attention_impl="xla",
                      ffn_impl=ffn_impl)
    x = np.random.default_rng(seed).normal(size=(3, T, H)).astype(np.float32)
    layer = seeded_encoder_layer(
        TransformerEncoderLayer(H, NH, F, "torch", ffn_impl), seed)
    params = jax_params_from_state(
        lambda: JaxLayer(H, NH, F, dropout_rate=0.0,
                         attention_impl="xla").init(
            jax.random.PRNGKey(seed), jnp.asarray(x)),
        encoder_layer_state_dict, layer.state_dict())["params"]
    return jlayer, params, layer, x


def _holder(layer):
    """A module whose `transformer_encoder.layers.0` is `layer`: the names
    the scale buffers carry in a model."""
    holder = torch.nn.Module()
    holder.transformer_encoder = torch.nn.Module()
    holder.transformer_encoder.layers = torch.nn.ModuleList([layer])
    return holder


def _rel_err(got, want):
    diff, rms = got - want, np.sqrt(np.mean(np.square(want)))
    return (np.sqrt(np.mean(np.square(diff))) / rms,
            np.abs(diff).max() / rms)


def _jax_layer_stats(params, x):
    jlayer = JaxLayer(H, NH, F, dropout_rate=0.0, attention_impl="xla",
                      ffn_impl="calibrate")
    _, mut = jax.jit(lambda p, xx: jlayer.apply(
        {"params": p}, xx, None, True, mutable=["quant_stats"]))(
        params, jnp.asarray(x))
    return jax.device_get(mut["quant_stats"])


@pytest.mark.parametrize("ffn_impl,attn_out", [
    ("calibrate", False), ("calibrate", True), ("int8", False),
    ("int8_static", False), ("int8_static", True)])
def test_dense_layer_matches_jax(request, ffn_impl, attn_out):
    """calibrate: each statistic within the fp32 bar (2e-5), and the
    out-projection's only with the switch on; int8 and int8_static (JAX's
    calibrated scales carried across): the layer's output within INT8_TOL,
    and a quantized path that is active (its output is not the float
    layer's)."""
    if attn_out:
        request.getfixturevalue("attn_out_quant")
    jlayer, params, layer, x = _layer_pair(ffn_impl)
    stats = _jax_layer_stats(params, x)
    assert ("self_attn" in stats) == attn_out
    if ffn_impl == "int8_static":
        load_quant_scales(_holder(layer), quant_scales_from_jax(
            {"core": {"encoder": {"layer_0": stats}}}))
    with torch.no_grad():
        got = layer(torch.from_numpy(x))[0].numpy()
    if ffn_impl == "calibrate":
        flat = quant_scales_from_jax(
            {"core": {"encoder": {"layer_0": stats}}})
        mine = {k: v for k, v in _holder(layer).named_buffers()
                if v.numel()}
        assert set(mine) == set(flat)
        for name, want in flat.items():
            np.testing.assert_allclose(mine[name].numpy(), want.numpy(),
                                       atol=2e-5, rtol=1e-5, err_msg=name)
        return
    variables = {"params": params}
    if ffn_impl == "int8_static":
        variables["quant"] = stats
    want = np.asarray(jax.jit(lambda v, xx: jlayer.apply(v, xx, None, True))(
        variables, jnp.asarray(x)))
    float_out = np.asarray(jax.jit(lambda p, xx: JaxLayer(
        H, NH, F, dropout_rate=0.0, attention_impl="xla").apply(
        {"params": p}, xx, None, True))(params, jnp.asarray(x)))
    err = _rel_err(got, want)
    assert err[0] <= INT8_TOL[0] and err[1] <= INT8_TOL[1], err
    assert _rel_err(want, float_out)[0] > 10 * INT8_TOL[0]  # quantized


def test_int8_layer_guards(attn_out_quant):
    """int8 refuses dropout; int8_static without scales, and the out-
    projection's int8_static under B5 (fused_qkv_op), raise."""
    _, _, layer, x = _layer_pair("int8")
    with pytest.raises(ValueError, match="serving/eval"):
        layer(torch.from_numpy(x), 0.1, torch.Generator())
    static = TransformerEncoderLayer(H, NH, F, "torch", "int8_static")
    with pytest.raises(ValueError, match="no calibrated scale"):
        static(torch.from_numpy(x))
    b5 = TransformerEncoderLayer(H, NH, F, "fused_qkv_op", "int8_static")
    with pytest.raises(ValueError, match="fused_qkv_op"):
        with torch.no_grad():
            b5(torch.from_numpy(x))


def _model_batch(n=4, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, T, 31)).astype(np.float32),
            rng.uniform(-60, 60, size=(n, 2)).astype(np.float32),
            np.full((n, T), 1999.0, np.float32),
            np.full((n, 1), 7.0, np.float32),
            rng.random((n, T, 31)) < 0.2)


@pytest.mark.parametrize("experts", [0, 4])
def test_calibrate_quant_scales_matches_jax(attn_out_quant, monkeypatch,
                                           experts):
    """serve.calibrate_quant_scales on WeatherBERT-mini (dense, and E=4
    through the dropless ragged dispatch) over two batches: the same
    scale names as JAX's `quant` collection, each within the fp32 bar.
    JAX's grouped matmul runs its plain form (`lax.ragged_dot`): the
    statistics are held here, the kernel in tests/test_torch_port_moe.py."""
    monkeypatch.setattr(pallas_gmm, "_INTERPRET", False)
    cfg = model_config_for_size("mini", max_len=T, num_experts=experts,
                                moe_dispatch="sort")
    jcfg = jax_config_for_size("mini", max_len=T, num_experts=experts,
                               moe_dispatch="sort")
    batches = [_model_batch(), _model_batch(3, 10)]
    # the port's seeded init as a flax tree (test_torch_port_jax_params.py)
    seeded = make_model("weatherbert", cfg, "torch")
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    params = jax_params_from_state(
        lambda: JaxWeatherBERT(jcfg, attention_impl="xla").init(
            jax.random.PRNGKey(0), *batches[0]),
        state_dict_from_jax_params, seeded.state_dict())
    want = quant_scales_from_jax(jax_calibrate_quant_scales(
        "weatherbert", jcfg, params, batches, attention_impl="xla"))
    got = calibrate_quant_scales(
        "weatherbert", cfg, state_dict_from_jax_params(params), batches,
        attention_impl="torch", device="cpu")
    assert set(got) == set(want) and any("attn_out" in k for k in got)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=1e-5, err_msg=name)


def test_int8_static_predictor_keeps_its_scales_across_reload(tmp_path):
    """load_weather_predictor(quantize="int8_static") calibrates, serves
    within the JAX package's drift budget of the float predictor (5% of its
    mean |output|), and a hot reload keeps the served calibration."""
    model = make_model("weatherbert", model_config_for_size(
        "mini", max_len=T), "torch")
    model.reset_parameters(torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), tmp_path / "mini.pth")
    batch = _model_batch(6)
    kw = dict(model_size="mini", max_len=T, buckets=(8,),
              compute_dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="calibration_batches"):
        load_weather_predictor(str(tmp_path / "mini.pth"),
                               quantize="int8_static", **kw)
    with pytest.raises(ValueError, match="quantize"):
        load_weather_predictor(str(tmp_path / "mini.pth"), quantize="int4",
                               **kw)
    fp = load_weather_predictor(str(tmp_path / "mini.pth"), **kw)(*batch)
    pred = load_weather_predictor(str(tmp_path / "mini.pth"),
                                  quantize="int8_static",
                                  calibration_batches=[batch], **kw)
    out = pred(*batch)
    assert np.abs(out - fp).mean() / np.abs(fp).mean() < 0.05
    assert not np.allclose(out, fp)
    reload_predictor_params(pred, str(tmp_path / "mini.pth"))
    np.testing.assert_array_equal(pred(*batch), out)
