"""The MoE path of the port against the JAX package: `MoEFFN` with the
ragged dispatch (routing, output, aux loss, gradients), a WeatherBERT-mini
with E=4 top-2 experts (forward, converter, a 20-step trajectory with the
aux loss in the objective), and `wm-pretrain-torch` / `wm-serve-torch` with
`--moe-experts`. The JAX grouped matmul runs its Pallas kernels in
interpret mode (tests/conftest.py); the port's runs its plain versions."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models.moe import MoEFFN as JaxMoEFFN
from weathermodel_tpu.models.moe import _ragged_routing
from weathermodel_tpu.models.moe import (
    expert_capacity as jax_expert_capacity,
)
from weathermodel_tpu.serve import WeatherPredictor as JaxPredictor
from weathermodel_tpu.train.steps import Batch as JaxBatch
from weathermodel_tpu.train.steps import _objective_losses
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli import pretrain, serve
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
from weathermodel_tpu_torch.models.moe import (
    MoEFFN,
    expert_capacity,
    ragged_routing,
)
from weathermodel_tpu_torch.models.transfer import (
    has_moe_layers,
    state_dict_from_jax_params,
)
from weathermodel_tpu_torch.serve import load_weather_predictor
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from test_torch_port_jax_params import (
    jax_params_from_state,
    moe_ffn_state_dict,
)
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.steps import (
    Batch,
    batch_to_device,
    make_train_step,
)
from weathermodel_tpu_torch.utils.config import model_config_for_size

T, E, K = 24, 4, 2
MOE = dict(num_experts=E, moe_top_k=K)


def _ffn_params(ffn: MoEFFN, p):
    """Load a JAX MoEFFN param dict into the port's module."""
    ffn.load_state_dict({
        "router.weight": torch.tensor(np.asarray(p["router"]["kernel"]).T),
        "router.bias": torch.tensor(np.asarray(p["router"]["bias"])),
        **{name: torch.tensor(np.asarray(p[name]))
           for name in ("expert_w1", "expert_b1", "expert_w2",
                        "expert_b2")}})


def test_moe_ffn_matches_jax_ragged():
    """fp32, dropout off: identical routing (top-k ids, the sort order, the
    per-expert counts), the output within 2e-5, the aux loss within 1e-6 and
    every gradient of out . dy + aux within 1e-4."""
    b, t, h, f = 3, 20, 12, 48
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, t, h)).astype(np.float32)
    dy = rng.normal(size=(b, t, h)).astype(np.float32)
    jmoe = JaxMoEFFN(h, f, E, top_k=K, dropout_rate=0.0, dispatch="ragged")
    seeded = MoEFFN(h, f, E, top_k=K)
    seeded.reset_parameters(torch.Generator().manual_seed(1))
    # the port's init as the flax tree (test_torch_port_jax_params.py)
    params = jax_params_from_state(
        lambda: jmoe.init(jax.random.PRNGKey(1), jnp.asarray(x)),
        moe_ffn_state_dict, seeded.state_dict())["params"]

    def jax_loss(p, xx):
        out, mvars = jmoe.apply({"params": p}, xx, deterministic=True,
                                mutable=["moe", "intermediates"],
                                capture_intermediates=True)
        aux = mvars["moe"]["aux_loss"]
        return jnp.sum(out * dy) + aux, (out, aux, mvars["intermediates"])

    (_, (want, want_aux, inter)), (gp, gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    logits = inter["router"]["__call__"][0]
    _, want_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    want_routing = _ragged_routing(want_idx.reshape(b, t * K), E)

    port = MoEFFN(h, f, E, top_k=K)
    _ffn_params(port, params)
    xt = torch.from_numpy(x).requires_grad_()
    got_logits, _, _, idx = port.route(xt)
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    for a, w in zip(ragged_routing(idx.reshape(b, t * K), E), want_routing):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    out, aux = port(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6,
                               rtol=0)
    ((out * torch.from_numpy(dy)).sum() + aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(port.router.weight.grad.numpy().T,
                               np.asarray(gp["router"]["kernel"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(port.router.bias.grad.numpy(),
                               np.asarray(gp["router"]["bias"]), atol=1e-4,
                               rtol=1e-4)
    for name in ("expert_w1", "expert_b1", "expert_w2", "expert_b2"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(),
                                   np.asarray(gp[name]), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_moe_options_not_ported_raise():
    with pytest.raises(ValueError, match="top_k"):
        MoEFFN(8, 16, 2, top_k=3)


def test_expert_capacity_matches_jax():
    for t, e, k, cf in [(365, 8, 2, 1.25), (365, 8, 1, 1.0), (24, 4, 2, 0.5),
                        (7, 16, 2, 1.25), (100, 3, 3, 2.0)]:
        assert expert_capacity(t, e, k, cf) == jax_expert_capacity(t, e, k,
                                                                   cf)


def _inputs(b=3, t=T, seed=0):
    rng = np.random.default_rng(seed)
    weather = rng.normal(size=(b, t, 31)).astype(np.float32)
    coords = rng.uniform(-90, 90, size=(b, 2)).astype(np.float32)
    year = (1985.0 + np.arange(t, dtype=np.float32) / 52.0
            + rng.integers(0, 15, size=(b, 1))).astype(np.float32)
    interval = np.full((b, 1), 7.0, np.float32)
    mask = rng.random((b, t, 31)) < 0.15
    return weather, coords, year, interval, mask


_PARAMS = {}


def _jax_params(max_len=T, seed=0):
    """A WeatherBERT-mini MoE's port init from `seed` as a flax tree
    (cached): the tree's structure from flax's init (traced, not run), the
    values through the inverse of `state_dict_from_jax_params`
    (test_torch_port_jax_params.py)."""
    if (max_len, seed) not in _PARAMS:
        cfg = jax_config_for_size("mini", max_len=max_len, **MOE)
        model = make_model("weatherbert", model_config_for_size(
            "mini", max_len=max_len, **MOE), "torch")
        model.reset_parameters(torch.Generator().manual_seed(seed))
        _PARAMS[max_len, seed] = jax_params_from_state(
            lambda: JaxWeatherBERT(cfg).init(
                jax.random.PRNGKey(seed),
                *(jnp.asarray(a) for a in _inputs(1, max_len))),
            state_dict_from_jax_params, model.state_dict())
    return _PARAMS[max_len, seed]


def _port_forward(params, impl, dtype, inputs):
    cfg = model_config_for_size("mini", max_len=T, compute_dtype=dtype, **MOE)
    model = make_model("weatherbert", cfg, impl).eval()
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.inference_mode():
        return model(*(torch.from_numpy(a) for a in inputs)).numpy()


def _jax_forward(params, impl, dtype, inputs):
    cfg = jax_config_for_size("mini", max_len=T, compute_dtype=dtype, **MOE)
    return np.asarray(jax.jit(JaxWeatherBERT(cfg, attention_impl=impl).apply)(
        params, *(jnp.asarray(a) for a in inputs)))


# PR 1's bars: 2e-5 against "xla", 5e-5 against "pallas_qkv"
@pytest.mark.parametrize("port_impl,jax_impl,atol", [
    ("torch", "xla", 2e-5), ("fused_qkv", "pallas_qkv", 5e-5)])
def test_weatherbert_moe_forward_matches_jax_fp32(port_impl, jax_impl, atol):
    params, inputs = _jax_params(), _inputs()
    want = _jax_forward(params, jax_impl, "float32", inputs)
    got = _port_forward(params, port_impl, "float32", inputs)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


def test_weatherbert_moe_forward_matches_jax_bf16():
    """bf16 at PR 1's RMS bars (max|diff| <= 5e-2 RMS, RMS(diff) <= 1e-2
    RMS): both sides round at the same points (the MoE norm2 with fp32
    statistics as flax's LayerNorm), but the frameworks' bf16 sums run in
    other orders."""
    params, inputs = _jax_params(), _inputs()
    want = _jax_forward(params, "xla", "bfloat16", inputs)
    got = _port_forward(params, "torch", "bfloat16", inputs)
    rms = np.sqrt(np.mean(want ** 2))
    diff = got - want
    assert np.abs(diff).max() <= 5e-2 * rms
    assert np.sqrt(np.mean(diff ** 2)) <= 1e-2 * rms


def _port_key(path):
    """The port state-dict key of a flax param path, and whether the leaf
    is a kernel stored transposed."""
    names = [p.key for p in path if hasattr(p, "key")][1:]  # drop "params"
    leaf = names[-1]
    suffix = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    if names[0] == "core" and names[1] == "encoder":
        mods = [names[2].replace("layer_", "transformer_encoder.layers.")]
        mods += [{"qkv_proj": "in_proj_"}.get(m, m + ".") for m in names[3:-1]]
        key = ".".join(mods[:1]) + "." + "".join(mods[1:])
    else:
        key = ".".join(names[1:-1] if names[0] == "core" else names[:-1]) \
            + "."
    return key + suffix, leaf == "kernel"


def test_converter_round_trip_with_moe_params_is_bit_exact():
    params = _jax_params()
    sd = state_dict_from_jax_params(params)
    model = make_model("weatherbert", model_config_for_size(
        "mini", max_len=T, **MOE), "torch")
    assert set(sd) == set(model.state_dict()) and has_moe_layers(sd)
    model.load_state_dict(sd)
    back = model.state_dict()
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        key, transposed = _port_key(path)
        got = back[key].numpy()
        assert np.array_equal(got.T if transposed else got, leaf), key
        seen.add(key)
    assert seen == set(back)
    assert back["transformer_encoder.layers.1.moe.expert_w1"].shape == (
        E, 48, 192)


B, N_STEPS, LR = 8, 20, 1e-3


def test_20_step_moe_trajectory_matches_jax():
    """20 Adam steps from the same weights on the same batches and injected
    masks, fp32, dropout off, with moe_aux_weight 0.01 times the aux loss in
    the objective on both sides (the JAX step in training mode with a
    dropout rate of 0): PR 2's bars."""
    rng = np.random.default_rng(6)
    weather = rng.normal(size=(N_STEPS, B, T, 31)).astype(np.float32)
    coords = rng.uniform(-90, 90, size=(B, 2)).astype(np.float32)
    year = (1990.0 + np.arange(T, dtype=np.float32) * 7 / 365
            + rng.integers(0, 10, (B, 1))).astype(np.float32)
    interval = np.full((B, 1), 7.0, np.float32)
    masks = rng.random((N_STEPS, B, T, 31)) < 0.15
    params = _jax_params()

    cfg = jax_config_for_size("mini", max_len=T, dropout_rate=0.0, **MOE)
    jmodel = JaxWeatherBERT(cfg, attention_impl="xla")
    tx = optax.adam(LR)

    @jax.jit
    def jstep(p, opt_state, w, m):
        batch = JaxBatch(w, jnp.asarray(coords), jnp.asarray(year),
                         jnp.asarray(interval))

        def loss_fn(q):
            out = _objective_losses(jmodel, "masked_mse", q, batch, m, 1.0,
                                    deterministic=False,
                                    rngs={"dropout": jax.random.PRNGKey(0)},
                                    sample_key=None)
            return out["total_loss"], out["moe_aux"]

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, aux, grads

    opt_state = tx.init(params)
    jax_losses, jax_aux, p = [], [], params
    for i in range(N_STEPS):
        p, opt_state, loss, aux, grads = jstep(
            p, opt_state, jnp.asarray(weather[i]), jnp.asarray(masks[i]))
        jax_losses.append(float(loss))
        jax_aux.append(float(aux))
        if i == 0:
            jax_grads = state_dict_from_jax_params(
                jax.tree.map(np.asarray, grads))

    model = make_model("weatherbert", model_config_for_size(
        "mini", max_len=T, **MOE), "torch")
    model.load_state_dict(state_dict_from_jax_params(params))
    step = make_train_step(model, make_optimizer(model), "weatherbert")
    gen = torch.Generator().manual_seed(0)
    losses, auxes = [], []
    for i in range(N_STEPS):
        out = step(batch_to_device(Batch(weather[i], coords, year, interval),
                                   "cpu"), gen, LR, 1,
                   mask=torch.from_numpy(masks[i]), dropout_rate=0.0)
        losses.append(float(out["total_loss"]))
        auxes.append(float(out["moe_aux"]))
        if i == 0:
            np.testing.assert_allclose(losses[0], jax_losses[0], rtol=1e-5)
            np.testing.assert_allclose(auxes[0], jax_aux[0], rtol=1e-5)
            for k, prm in model.named_parameters():
                np.testing.assert_allclose(prm.grad.numpy(),
                                           jax_grads[k].numpy(), atol=1e-5,
                                           rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-2)
    np.testing.assert_allclose(auxes, jax_aux, rtol=1e-2)
    assert losses[-1] < losses[0]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    write_synthetic_dataset(str(root), n_chunks=8, n_samples=24, seq_len=T,
                            seed=0)
    return str(root)


def test_pretrain_cli_moe_writes_the_jax_record(store, tmp_path):
    """`wm-pretrain-torch --moe-experts 4` at mini on the CPU trains (the
    aux loss in the training total, `moe_aux` in both scopes) and records,
    per scope, the metrics the JAX step returns for a MoE model: the JAX
    trainer records each (weathermodel_tpu/train/trainer.py:468-470), and
    `jax.eval_shape` gives their keys without running the model. The rest of
    the record does not depend on the experts; test_torch_port_pretrain_cli
    holds it to `wm-pretrain`'s. The best .pth holds the experts, and
    `wm-serve-torch` serves it only with --moe-experts."""
    port_dir = tmp_path / "port"
    pretrain.run(pretrain.build_parser().parse_args([
        "--model", "weatherbert", "--model-size", "mini", "--batch-size", "8",
        "--n-epochs", "1", "--n-warmup-epochs", "0", "--masking-prob", "0.15",
        "--data-dir", store, "--compute-dtype", "float32", "--moe-experts",
        "4", "--moe-top-k", "2", "--workdir", str(port_dir), "--device",
        "cpu", "--grad-accum", "2", "--moe-capacity-factor", "2"]))
    with open(port_dir / "weatherbert_output.json") as f:
        record = json.load(f)
    jmodel = JaxWeatherBERT(jax_config_for_size("mini", max_len=T, **MOE),
                            attention_impl="xla")
    w, c, y, i, m = (jnp.asarray(a) for a in _inputs(2))
    for scope, deterministic in (("train", False), ("val", True)):
        keys = jax.eval_shape(lambda p, d=deterministic: _objective_losses(
            jmodel, "masked_mse", p, JaxBatch(w, c, y, i), m, 1.0,
            deterministic=d, rngs={"dropout": jax.random.PRNGKey(0)},
            sample_key=None), _jax_params())
        assert set(record["losses"][scope]) == set(keys) == {
            "total_loss", "mae", "moe_aux"}, scope
        assert np.isfinite(record["losses"][scope]["moe_aux"]).all()
    best = torch.load(port_dir / "best.pth")
    assert has_moe_layers(best)
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "w.npz",
             weather=rng.normal(size=(5, T, 31)).astype(np.float32))
    served = ["--checkpoint", str(port_dir / "best.pth"), "--model-size",
              "mini", "--input", str(tmp_path / "w.npz"), "--output",
              str(tmp_path / "o.npz"), "--batch-size", "8", "--device", "cpu"]
    assert serve.run(serve.build_parser().parse_args(
        served + ["--moe-experts", "4"]))["n"] == 5
    with pytest.raises(ValueError, match="contains MoE"):
        serve.run(serve.build_parser().parse_args(served))


@pytest.mark.parametrize("model", ["mlp", "weathercnn"])
def test_pretrain_cli_rejects_experts_without_an_encoder(store, tmp_path,
                                                         model):
    args = pretrain.build_parser().parse_args([
        "--model", model, "--moe-experts", "4", "--data-dir", store,
        "--workdir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(ValueError, match="no transformer encoder"):
        pretrain.run(args)


N_SERVE = 45


def test_serve_moe_matches_jax_predictor(tmp_path):
    """`wm-serve-torch --moe-experts 4` on the converted weights against the
    JAX predictor on the flax params (a 32-row chunk plus 13 rows padded to
    the 32 bucket), fp32, at the fused kernel's bar (5e-5/1e-4); a dense
    request of a MoE checkpoint and a MoE request of a dense one raise."""
    params = _jax_params()
    torch.save(state_dict_from_jax_params(params), tmp_path / "moe.pth")
    w, c, y, i, m = _inputs(N_SERVE, seed=3)
    np.savez(tmp_path / "windows.npz", weather=w, coords=c, year=y,
             interval=i, mask=m)
    cfg = jax_config_for_size("mini", max_len=T, compute_dtype="float32",
                              **MOE)
    want = JaxPredictor(JaxWeatherBERT(cfg, attention_impl="pallas_qkv"),
                        params, buckets=(8, 32))(w, c, y, i, m)
    serve.run(serve.build_parser().parse_args([
        "--checkpoint", str(tmp_path / "moe.pth"), "--model-size", "mini",
        "--input", str(tmp_path / "windows.npz"), "--output",
        str(tmp_path / "out.npz"), "--batch-size", "32", "--compute-dtype",
        "float32", "--moe-experts", "4", "--moe-top-k", "2", "--device",
        "cpu"]))
    with np.load(tmp_path / "out.npz") as z:
        np.testing.assert_allclose(z["output"], np.asarray(want), atol=5e-5,
                                   rtol=1e-4)
    with pytest.raises(ValueError, match="contains MoE"):
        load_weather_predictor(str(tmp_path / "moe.pth"), "mini", max_len=T,
                               device="cpu")
    dense = make_model("weatherbert", model_config_for_size("mini",
                                                            max_len=T),
                       "torch")
    torch.save(dense.state_dict(), tmp_path / "dense.pth")
    with pytest.raises(ValueError, match="lacks MoE"):
        load_weather_predictor(str(tmp_path / "dense.pth"), "mini",
                               max_len=T, num_experts=4, device="cpu")
