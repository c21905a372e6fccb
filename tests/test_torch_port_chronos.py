"""The Chronos baseline (`weathermodel_tpu_torch/models/chronos_bolt.py`,
`models/chronos.py`) against the JAX package's on the CPU: the relative
position buckets exactly, the encoder at a small geometry over the series
its instance norm and patching treat apart (within 2e-5), ChronosYieldModel
at chronos-bolt-tiny, a chronos-bolt checkpoint (a synthetic state dict
under the checkpoint's key names) loaded into both packages, with JAX's
error texts, the yield loss and two Adam steps under the encoder freeze,
and `wm-yield-torch` / `wm-cropnet-torch` / the grid search with `--model
chronos` end to end. Dropout is off for parity: the port draws from
torch.Generator, not JAX's key chain."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weathermodel_tpu.models import chronos as jax_chronos
from weathermodel_tpu.models import chronos_bolt as jax_bolt
from weathermodel_tpu.train import yield_trainer as jax_yield_trainer
from weathermodel_tpu.utils.config import ModelConfig as JaxModelConfig
from weathermodel_tpu_torch.cli import cropnet_main, grid_search, yield_main
from weathermodel_tpu_torch.data.cropnet_data import synthetic_cropnet_df
from weathermodel_tpu_torch.data.yield_data import synthetic_yield_df
from weathermodel_tpu_torch.models import chronos, chronos_bolt
from weathermodel_tpu_torch.models.transfer import (
    chronos_state_dict_from_jax_params,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.train.yield_trainer import (
    YieldBatch,
    yield_losses,
)
from weathermodel_tpu_torch.utils.config import ModelConfig
from test_torch_port_jax_params import jax_compiled, jax_params_from_state

SMALL = dict(d_model=32, d_ff=64, num_layers=2, num_heads=2, d_kv=16,
             dropout_rate=0.0)
B, F, N_PAST = 2, 31, 6
T = (N_PAST + 1) * 52


def _seeded(model, seed=0):
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()


def test_buckets_are_the_jax_packages():
    """Every relative position in [-300, 300] (the exact powers 16, 32,
    64 and 128 among them, where an fp32 log may round either way), and the
    [T, T] table the encoder caches."""
    rel = np.arange(-300, 301)
    for buckets, distance in ((32, 128), (16, 64)):
        want = np.asarray(jax.jit(
            jax_bolt.relative_position_bucket, static_argnums=(1, 2))(
                jnp.asarray(rel), buckets, distance))
        got = chronos_bolt.relative_position_bucket(torch.from_numpy(rel),
                                                    buckets, distance)
        assert np.array_equal(got.numpy(), want)
        pos = np.arange(300)
        assert np.array_equal(chronos_bolt.position_buckets(
            300, buckets, distance).numpy(),
            want[pos[None, :] - pos[:, None] + 300])
    for t in (1, 52, 53, 364, 2048, 2049, 2100):
        assert chronos_bolt.num_patches(t) == jax_bolt.num_patches(t)


def _series(t, seed):
    """Four series: plain, all missing, NaN gaps, constant (scale 0)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, t)) * 3 + 1).astype(np.float32)
    x[1] = np.nan
    x[2, 3:40:2] = np.nan
    x[2, -5:] = np.nan
    x[3] = 2.5
    return x


@pytest.mark.parametrize("t", [52, 53, 364, 2100])
def test_small_encoder_matches_jax(t):
    """T = 53 left-pads 11 missing steps into the first patch; 2100 is
    truncated to the 2048-step context."""
    cfg = chronos_bolt.ChronosBoltConfig(**SMALL)
    jm = jax_bolt.ChronosBoltEncoder(jax_bolt.ChronosBoltConfig(**SMALL))
    pm = _seeded(chronos_bolt.ChronosBoltEncoder(cfg))
    x = _series(t, seed=t)
    params = jax_params_from_state(lambda: jm.init(jax.random.PRNGKey(0), x),
                                   chronos_state_dict_from_jax_params,
                                   pm.state_dict())
    want = np.asarray(jax_compiled(jm.apply, params, x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (
        4, chronos_bolt.num_patches(min(t, 2048)) + 1, SMALL["d_model"])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _yield_inputs(seed, t=T, n_past=N_PAST):
    rng = np.random.default_rng(seed)
    # a static mask of the features, as the Khaki data's; every series
    # differs, so a swapped [B, F] fold would show
    mask = np.broadcast_to(rng.random((1, 1, F)) < 0.4, (B, t, F)).copy()
    return (rng.normal(size=(B, t, F)).astype(np.float32),
            rng.uniform(30, 48, (B, 2)).astype(np.float32),
            np.full((B, t), 2010.0, np.float32),
            np.full((B, 1), 7.0, np.float32), mask,
            rng.normal(size=(B, n_past + 1)).astype(np.float32))


@functools.cache
def _yield_models(t=T, n_past=N_PAST):
    """(the JAX model, its params, the port model at chronos-bolt-tiny,
    seeded)."""
    jm = jax_chronos.ChronosYieldModel(JaxModelConfig(max_len=t),
                                       n_past_years=n_past)
    pm = _seeded(chronos.ChronosYieldModel(ModelConfig(max_len=t), n_past))
    params = jax_params_from_state(
        lambda: jm.init(jax.random.PRNGKey(0), *_yield_inputs(0, t, n_past)),
        chronos_state_dict_from_jax_params, pm.state_dict())
    return jm, params, pm


@functools.cache
def _apply():
    """The JAX model's apply, compiled once at _yield_inputs' shapes."""
    jm, params, _ = _yield_models()
    return jax.jit(jm.apply).lower(params, *_yield_inputs(0)).compile()


def test_state_dict_is_the_flax_tree():
    _, params, pm = _yield_models()
    sd = chronos_state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    assert set(sd) == set(pm.state_dict())
    for k, v in pm.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert "chronos_encoder.encoder.block_3.attn.q.weight" in sd


@pytest.mark.parametrize("seed", [1, 2])
def test_yield_model_matches_jax(seed):
    _, params, pm = _yield_models()
    inputs = _yield_inputs(seed)
    want = np.asarray(_apply()(params, *inputs))
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, inputs))
    assert got.shape == (B, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def _checkpoint(cfg, seed=0):
    """A chronos-bolt state dict under the checkpoint's key names, values
    from a numpy seed (torch's [out, in] layout), with decoder keys the
    loaders ignore."""
    rng = np.random.default_rng(seed)
    d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
    shapes = {}
    for lin, (o, i) in (("hidden_layer", (cfg.d_ff, 2 * cfg.patch_size)),
                        ("output_layer", (d, cfg.d_ff)),
                        ("residual_layer", (d, 2 * cfg.patch_size))):
        shapes[f"input_patch_embedding.{lin}.weight"] = (o, i)
        shapes[f"input_patch_embedding.{lin}.bias"] = (o,)
    for b in range(cfg.num_layers):
        pre = f"encoder.block.{b}.layer"
        for name, shape in (("q", (inner, d)), ("k", (inner, d)),
                            ("v", (inner, d)), ("o", (d, inner))):
            shapes[f"{pre}.0.SelfAttention.{name}.weight"] = shape
        shapes[f"{pre}.0.layer_norm.weight"] = (d,)
        shapes[f"{pre}.1.DenseReluDense.wi.weight"] = (cfg.d_ff, d)
        shapes[f"{pre}.1.DenseReluDense.wo.weight"] = (d, cfg.d_ff)
        shapes[f"{pre}.1.layer_norm.weight"] = (d,)
    shapes["encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
           ".weight"] = (cfg.relative_attention_num_buckets, cfg.num_heads)
    shapes["encoder.final_layer_norm.weight"] = (d,)
    shapes["shared.weight"] = (2, d)
    shapes["decoder.block.0.layer.0.SelfAttention.q.weight"] = (inner, d)
    return {k: torch.from_numpy(
        (rng.normal(size=s) / np.sqrt(s[-1])).astype(np.float32))
        for k, s in shapes.items()}


def test_checkpoint_loads_into_both_packages(tmp_path):
    """`load_chronos_torch_weights` from a file into the port's model and
    JAX's `load_torch_state_dict` into its tree: the same encoder, outputs
    within 2e-5."""
    _, params, _ = _yield_models()
    sd = _checkpoint(chronos_bolt.CHRONOS_BOLT_TINY)
    torch.save(sd, tmp_path / "chronos_bolt.pt")
    pm = _seeded(chronos.ChronosYieldModel(ModelConfig(max_len=T), N_PAST),
                 seed=5)
    chronos.load_chronos_torch_weights(pm, str(tmp_path / "chronos_bolt.pt"))
    loaded = jax_bolt.load_torch_state_dict(
        params, {k: v.numpy() for k, v in sd.items()})
    enc = pm.state_dict()
    for k, v in chronos_state_dict_from_jax_params(
            jax.tree.map(np.asarray, loaded)).items():
        if k.startswith("chronos_encoder."):
            assert torch.equal(enc[k], v), k
    assert torch.equal(pm.chronos_encoder.reg_token, sd["shared.weight"][1])
    # the head keeps the port's seed-5 draw: carry it into the JAX tree
    loaded = jax_params_from_state(lambda: params,
                                   chronos_state_dict_from_jax_params, enc)
    inputs = _yield_inputs(3)
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, np.asarray(_apply()(loaded, *inputs)),
                               atol=2e-5, rtol=0)


def test_checkpoint_errors_are_the_jax_packages():
    cfg = chronos_bolt.CHRONOS_BOLT_TINY
    _, params, _ = _yield_models()
    pm = chronos.ChronosYieldModel(ModelConfig(max_len=T), N_PAST)
    sd = _checkpoint(cfg)
    missing = {k: v for k, v in sd.items()
               if not k.startswith("encoder.block.1.")}
    bad = dict(sd)
    bad["input_patch_embedding.hidden_layer.weight"] = torch.zeros(
        cfg.d_ff + 1, 2 * cfg.patch_size)
    for broken, error in ((missing, KeyError), (bad, ValueError)):
        with pytest.raises(error) as want:
            jax_bolt.load_torch_state_dict(
                params, {k: v.numpy() for k, v in broken.items()})
        with pytest.raises(error) as got:
            chronos_bolt.load_torch_state_dict(pm, broken)
        assert str(got.value) == str(want.value)


def test_two_steps_under_the_freeze_match_jax():
    """The yield MSE on a batch with a padded row, then two Adam steps (lr
    1e-3) with the encoder frozen: JAX's freeze_subtree_optimizer gives the
    encoder zero updates whatever its gradients (ones here: the JAX side
    differentiates the head only, which keeps its compile short), the port
    takes the encoder out of the optimizer. The encoder stays bit for bit on
    both sides and the head moves as JAX's."""
    t, n_past, lr = T, N_PAST, 1e-3
    jm, params, pm = _yield_models()
    rng = np.random.default_rng(9)
    arrays = (*_yield_inputs(8, t, n_past),
              rng.normal(size=(B, 1)).astype(np.float32),
              np.array([1, 0], np.float32),
              np.zeros((B, n_past + 1, 11, 6), np.float32),
              np.zeros((B, n_past + 1, 14), np.float32))
    jbatch = jax_yield_trainer.YieldBatch(*map(jnp.asarray, arrays))
    tx = jax_chronos.freeze_subtree_optimizer(optax.adam(lr), params)
    enc = chronos.ENCODER

    def jax_step(p, opt_state):
        def loss_fn(head):
            q = {"params": {**head, enc: p["params"][enc]}}
            return jax_yield_trainer._yield_losses(
                jm, "mse", q, jbatch, 0.0, True, None)["total_loss"]

        head = {k: v for k, v in p["params"].items() if k != enc}
        loss, grads = jax.value_and_grad(loss_fn)(head)
        grads = {"params": {**grads, enc: jax.tree.map(
            jnp.ones_like, p["params"][enc])}}
        updates, opt_state = tx.update(grads, opt_state, p)
        return loss, optax.apply_updates(p, updates), opt_state

    step = jax.jit(jax_step)
    p, opt_state, want_losses, want = params, tx.init(params), [], []
    for _ in range(2):
        loss, p, opt_state = step(p, opt_state)
        want_losses.append(float(loss))
        want.append(chronos_state_dict_from_jax_params(
            jax.tree.map(np.asarray, p)))

    model = copy.deepcopy(pm)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = chronos.freeze_subtree_optimizer(
        torch.optim.Adam(model.parameters(), lr=lr), model)
    batch = YieldBatch(*map(torch.from_numpy, arrays))
    model.train()
    got_losses = []
    for i in range(2):
        optimizer.zero_grad(set_to_none=True)
        loss = yield_losses("mse", model(
            batch.weather, batch.coords, batch.year, batch.interval,
            batch.mask, batch.y_past, dropout_rate=0.0), batch,
            0.0)["total_loss"]
        loss.backward()
        optimizer.step()
        got_losses.append(loss.item())
        if i:
            continue
        # after the first step: Adam moves an entry by lr * g / (|g| +
        # 1e-8), the same on both sides where |g| is well above rounding
        # noise (not in the pooling logit's bias, to which the softmax over
        # patches is invariant: its gradient is noise on both sides)
        for k, q in model.named_parameters():
            if k.startswith(enc + "."):
                assert q.grad is not None and k not in optimizer.state, k
                continue
            well = q.grad.abs() > 1e-6
            np.testing.assert_allclose(q.detach()[well].numpy(),
                                       want[0][k][well].numpy(), atol=2e-6,
                                       rtol=0, err_msg=k)
            assert k == "attn_fc2.bias" or well.float().mean() > 0.9, k
    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-5)
    for k, v in model.state_dict().items():
        if k.startswith(enc + "."):
            assert torch.equal(v, start[k]) and torch.equal(want[1][k],
                                                            start[k]), k
        else:
            assert not torch.equal(v, start[k]), k


def test_clis_train_chronos(tmp_path):
    """`wm-yield-torch --model chronos` (one fold, one epoch, dropout on),
    `wm-cropnet-torch --model chronos` and one grid-search cell, a step
    each on tiny frames."""
    df = synthetic_yield_df(seed=6, n_locs=2, years=(2010, 2016))
    argv = ["--model", "chronos", "--device", "cpu", "--country",
            "synthetic", "--n-past-years", "1", "--n-train-years", "2",
            "--test-year", "2016", "--n-epochs", "1", "--n-warmup-epochs",
            "0", "--batch-size", "4"]
    args = yield_main.build_parser().parse_args(argv)
    args.crop_df = df
    result = yield_main.run(args)
    (trainer,) = result["trainers"]
    assert isinstance(trainer.model, chronos.ChronosYieldModel)
    assert np.isfinite(trainer.loss_history["train"]["total_loss"]).all()
    assert np.isfinite(result["avg_rmse_bu_acre"])
    assert np.isfinite(result["avg_r_squared"])

    args = cropnet_main.build_parser().parse_args(
        ["--model", "chronos", "--device", "cpu", "--crop-type", "Corn",
         "--n-past-years", "1", "--n-train-years", "2", "--n-epochs", "1",
         "--batch-size", "4"])
    args.cropnet_df = synthetic_cropnet_df(seed=0, n_counties=2)
    assert np.isfinite(cropnet_main.run(args)["Corn"][0])

    args = grid_search.build_parser().parse_args(
        argv + ["--out-dir", str(tmp_path)])
    args.crop_df = df
    tsv = grid_search.GridSearch(args, str(tmp_path), betas=(0.0,),
                                 batch_sizes=(4,), lrs=(1e-3,),
                                 n_train_years_list=(2,)).run()
    rows = open(tsv).read().strip().split("\n")
    assert len(rows) == 2 and "±" in rows[1], rows
