"""Pretrained-parameter transfer: the port's `load_pretrained` on state dicts
against the JAX package's on param trees (weathermodel_tpu/models/transfer.py),
bit exact, and `wm-pretrain-torch --pretrained-model-path` starting a
WeatherFormer from a WeatherBERT checkpoint."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models import WeatherFormer as JaxWeatherFormer
from weathermodel_tpu.models import WeatherFormerSinusoid as JaxSinusoid
from weathermodel_tpu.models.transfer import (
    load_pretrained as jax_load_pretrained,
)
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli import pretrain
from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
from weathermodel_tpu_torch.models.transfer import (
    load_pretrained,
    state_dict_from_jax_params,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import model_config_for_size
from test_torch_port_jax_params import jax_params_from_state

T = 8
PORT_NAMES = {"weatherbert": "weatherbert", "weatherformer": "weatherformer",
              "weatherformer_sinusoid": "weatherformersinusoid"}
JAX_MODELS = {"weatherbert": JaxWeatherBERT,
              "weatherformer": JaxWeatherFormer,
              "weatherformer_sinusoid": JaxSinusoid}


def _inputs(t=T):
    rng = np.random.default_rng(0)
    return (jnp.asarray(rng.normal(size=(1, t, 31)), jnp.float32),
            jnp.zeros((1, 2), jnp.float32),
            jnp.full((1, t), 1990.0, jnp.float32),
            jnp.full((1, 1), 7.0, jnp.float32),
            jnp.zeros((1, t, 31), bool))


@functools.cache
def _params(name, seed, size="mini", k=4, num_experts=0):
    """flax params of `name`: the port's init from `seed` in the flax tree
    (test_torch_port_jax_params.py; the tree's shapes traced from flax's
    init)."""
    cfg = jax_config_for_size(size, max_len=T, k=k, num_experts=num_experts)
    model = pretrain.make_model(PORT_NAMES[name], model_config_for_size(
        size, max_len=T, k=k, num_experts=num_experts), "torch")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return jax_params_from_state(
        lambda: JAX_MODELS[name](cfg).init(jax.random.PRNGKey(seed),
                                           *_inputs()),
        state_dict_from_jax_params, model.state_dict())


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


# (target, pretrained): out_proj kept (2F vs F head), the target's priors
# kept (the source has none), the priors transferred
@pytest.mark.parametrize("target,source", [
    ("weatherformer", "weatherbert"),
    ("weatherformer_sinusoid", "weatherformer"),
    ("weatherformer_sinusoid", "weatherformer_sinusoid")])
def test_matches_jax_load_pretrained(target, source):
    tgt, src = _params(target, 0), _params(source, 1)
    want = state_dict_from_jax_params(jax_load_pretrained(target, tgt, src))
    got = load_pretrained(target, state_dict_from_jax_params(tgt),
                          state_dict_from_jax_params(src))
    _assert_same_state(got, want)
    # what moved: the trunk always, the head and priors only as said above
    src_sd = state_dict_from_jax_params(src)
    tgt_sd = state_dict_from_jax_params(tgt)
    assert torch.equal(got["in_proj.weight"], src_sd["in_proj.weight"])
    head = tgt_sd if source == "weatherbert" else src_sd  # F vs 2F
    assert torch.equal(got["out_proj.weight"], head["out_proj.weight"])
    if target == "weatherformer_sinusoid":
        priors = src_sd if "frequency" in src_sd else tgt_sd
        assert torch.equal(got["frequency"], priors["frequency"])


@pytest.mark.parametrize("case", ["in_proj", "moe", "k"])
def test_mismatches_raise_as_jax(case):
    if case == "in_proj":  # another width: in_proj [31 + 3, 48] vs [.., 128]
        tgt, src = _params("weatherbert", 0), _params("weatherbert", 1,
                                                     size="small")
        match = "expected input dimension"
    elif case == "moe":
        tgt, src = _params("weatherbert", 0), _params("weatherbert", 1,
                                                     num_experts=4)
        match = "FFN architecture mismatch"
    else:
        tgt = _params("weatherformer_sinusoid", 0)
        src = _params("weatherformer_sinusoid", 1, k=3)
        match = "k mismatch"
    name = "weatherformer_sinusoid" if case == "k" else "weatherbert"
    with pytest.raises(ValueError, match=match) as want:
        jax_load_pretrained(name, tgt, src)
    with pytest.raises(ValueError, match=match) as got:
        load_pretrained(name, state_dict_from_jax_params(tgt),
                        state_dict_from_jax_params(src))
    assert str(got.value) == str(want.value)


def test_load_out_proj_false_keeps_the_target_head():
    tgt, src = _params("weatherbert", 0), _params("weatherbert", 1)
    want = state_dict_from_jax_params(
        jax_load_pretrained("weatherbert", tgt, src, load_out_proj=False))
    got = load_pretrained("weatherbert", state_dict_from_jax_params(tgt),
                          state_dict_from_jax_params(src),
                          load_out_proj=False)
    _assert_same_state(got, want)


def test_pretrain_cli_starts_a_weatherformer_from_a_weatherbert(tmp_path):
    """The JAX trainer's rule through `wm-pretrain-torch`: the WeatherBERT's
    trunk loads, the WeatherFormer keeps its own [2F, H] head."""
    from weathermodel_tpu_torch.train.trainer import PretrainTrainer
    from weathermodel_tpu_torch.utils.config import TrainConfig

    cfg = model_config_for_size("mini", max_len=24)
    bert = pretrain.make_model("weatherbert", cfg, "torch")
    bert.reset_parameters(torch.Generator().manual_seed(3))
    torch.save(bert.state_dict(), tmp_path / "bert.pth")
    store = tmp_path / "store"
    write_synthetic_dataset(str(store), n_chunks=8, n_samples=24, seq_len=24,
                            seed=0)
    result = pretrain.run(pretrain.build_parser().parse_args([
        "--model", "weatherformer", "--model-size", "mini",
        "--pretrained-model-path", str(tmp_path / "bert.pth"),
        "--batch-size", "8", "--n-epochs", "1", "--n-warmup-epochs", "0",
        "--data-dir", str(store), "--workdir", str(tmp_path / "run"),
        "--compute-dtype", "float32", "--attention-impl", "torch",
        "--device", "cpu"]))
    assert np.isfinite(result["best_val_loss"])

    trainer = PretrainTrainer(
        pretrain.make_model("weatherformer", cfg, "torch"), "weatherformer",
        cfg, TrainConfig(), lambda *a: iter(()), workdir=str(tmp_path),
        device="cpu", pretrained_state=pretrain.load_pretrained_params(
            str(tmp_path / "bert.pth")))
    state = trainer.model.state_dict()
    for k, v in bert.state_dict().items():
        if not k.startswith("out_proj."):
            assert torch.equal(state[k], v), k
    assert state["out_proj.weight"].shape == (2 * 31, cfg.hidden_dim)
