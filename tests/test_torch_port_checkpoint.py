"""The port's fault tolerance on the CPU (the cases of
tests/test_preempt_resume.py, on weathermodel_tpu_torch's trainer): a real
SIGTERM inside an epoch writes a full-state checkpoint and the resumed run
ends bitwise equal to an uninterrupted one; the boundary stop; the
`optimal_lr` schedule restored; the MoE composition; the Checkpointer's
retention, replacement and background write; the JAX save cadence; and the
WEATHERMODEL_PROFILE_DIR trace."""

import json
import os
import signal

import numpy as np
import pytest
import torch

from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
from weathermodel_tpu_torch.data.pretraining import (
    PretrainDataConfig,
    pretrain_batches,
)
from weathermodel_tpu_torch.models.weatherbert import WeatherBERT
from weathermodel_tpu_torch.models.weatherformer import WeatherFormer
from weathermodel_tpu_torch.ops.schedules import epoch_lr_schedule
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.testing import sigterm_during_step
from weathermodel_tpu_torch.train.checkpoint import Checkpointer
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.trainer import PretrainTrainer
from weathermodel_tpu_torch.utils.config import ModelConfig, TrainConfig

T = 16
N_EPOCHS = 3
# 1 layer of the mini width
MCFG = ModelConfig(num_heads=4, num_layers=1, hidden_dim_factor=12,
                   max_len=T)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth_preempt")
    write_synthetic_dataset(str(d), n_chunks=9, n_samples=48, seq_len=T)
    return str(d)


def _make_loaders(data_dir):
    cfg = PretrainDataConfig(data_dir=data_dir, batch_size=16, dry_run=False,
                             num_parts=9)

    def make(split, shuffle, seed):
        return pretrain_batches(split, cfg, shuffle=shuffle, seed=seed)

    return make


def _trainer(data_dir, workdir, resume=False, model_name="weatherbert",
             mcfg=MCFG, num_epochs=N_EPOCHS, **train_kw):
    # the reference cadence fires at epoch % N == 1, so a boundary save
    # still lands at epoch 1, after the mid-epoch save of that epoch
    tcfg = TrainConfig(batch_size=16, num_epochs=num_epochs, init_lr=1e-3,
                       num_warmup_epochs=1, decay_factor=None,
                       checkpoint_every=100, **train_kw)
    model = {"weatherbert": WeatherBERT,
             "weatherformer": WeatherFormer}[model_name](
        mcfg, attention_impl="flash")
    return PretrainTrainer(model, model_name, mcfg, tcfg,
                           _make_loaders(data_dir), workdir=str(workdir),
                           device="cpu", resume=resume)


def _params(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def _assert_same(base, res):
    for split in ("train", "val"):
        for k, v in base.output_json["losses"][split].items():
            assert res.output_json["losses"][split][k] == v, (
                f"{split}/{k} diverged after preempt + resume")
    for k, v in _params(base).items():
        assert torch.equal(res.model.state_dict()[k], v), k
    moments = [(s["exp_avg"], s["exp_avg_sq"])
               for s in base.optimizer.state_dict()["state"].values()]
    got = [(s["exp_avg"], s["exp_avg_sq"])
           for s in res.optimizer.state_dict()["state"].values()]
    assert len(got) == len(moments)
    for (m, v), (gm, gv) in zip(moments, got):
        assert torch.equal(m, gm) and torch.equal(v, gv)


@pytest.mark.parametrize("model_name", ["weatherbert", "weatherformer"])
def test_sigterm_mid_epoch_then_exact_resume(data_dir, tmp_path, model_name):
    baseline = _trainer(data_dir, tmp_path / "base", model_name=model_name)
    base_result = baseline.train()
    assert "preempted" not in base_result

    # --- preempted run: a real SIGTERM while step 3 of epoch 1 runs ----
    pre = _trainer(data_dir, tmp_path / "pre", model_name=model_name)
    handler_before = signal.getsignal(signal.SIGTERM)
    with sigterm_during_step(epoch=1, step=3):
        result = pre.train()
    assert result["preempted"] is True
    assert result["best_val_loss"] == pre.best_val_loss
    assert len(result["train_step_seconds"]) == 1
    # epoch 0 completed, epoch 1 in flight
    assert len(pre.output_json["losses"]["train"]["total_loss"]) == 1
    # the handler is uninstalled afterwards
    assert signal.getsignal(signal.SIGTERM) == handler_before
    with open(tmp_path / "pre" / "checkpoints" / "1" / "meta.json") as f:
        assert json.load(f)["mid_epoch"]["batch_idx"] == 3

    # --- resume: continues inside epoch 1, bitwise the uninterrupted run -
    res = _trainer(data_dir, tmp_path / "pre", resume=True,
                   model_name=model_name)
    assert res.start_epoch == 1
    assert res._resume_mid is not None and res._resume_mid["batch_idx"] == 3
    res_result = res.train()
    assert "preempted" not in res_result
    assert res_result["fast_forward_seconds"] >= 0
    assert res_result["best_val_loss"] == base_result["best_val_loss"]
    _assert_same(baseline, res)
    # the files too: the last boundary checkpoint and best.pth
    for name in ("best.pth", os.path.join("checkpoints", "2", "state.pt")):
        want = torch.load(tmp_path / "base" / name, weights_only=True)
        got = torch.load(tmp_path / "pre" / name, weights_only=True)
        if "model" in want:
            want, got = want["model"], got["model"]
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), (name, k)


def test_boundary_stop_when_signal_arrives_during_validation(data_dir,
                                                            tmp_path):
    tr = _trainer(data_dir, tmp_path / "valstop")
    orig_eval = tr._eval_step

    def eval_and_signal(*a, **kw):
        tr._stop_requested = True   # as if SIGTERM landed mid-validation
        return orig_eval(*a, **kw)

    tr._eval_step = eval_and_signal
    result = tr.train()
    assert result["preempted"] is True
    # one full epoch completed and checkpointed at the boundary (epoch 0
    # is off the cadence, so this save is the synchronous one)
    assert len(tr.output_json["losses"]["train"]["total_loss"]) == 1
    assert [s["wait"] for s in result["checkpoint_saves"]] == [True]
    res = _trainer(data_dir, tmp_path / "valstop", resume=True)
    assert res.start_epoch == 1 and res._resume_mid is None
    assert res.best_val_loss == tr.best_val_loss
    assert res.output_json == tr.output_json


def test_resume_restores_optimal_lr_schedule(data_dir, tmp_path,
                                             monkeypatch):
    """A use_optimal_lr run records its LR in output_json; the resumed
    schedule is built from that value, and the range test does not run
    again from the restored state."""
    tr = _trainer(data_dir, tmp_path / "lr")
    tr.output_json["model_config"]["optimal_lr"] = 3.3e-3
    tr.checkpointer.save(0, tr.model, tr.optimizer, 1.0, tr.output_json)

    res = _trainer(data_dir, tmp_path / "lr", resume=True,
                   use_optimal_lr=True)
    assert res.start_epoch == 1 and res.best_val_loss == 1.0
    expected = epoch_lr_schedule(3.3e-3, res.cfg.num_warmup_epochs,
                                 res.cfg.num_epochs, res.cfg.decay_factor)
    for epoch in range(N_EPOCHS):
        assert float(res.lr_schedule(epoch)) == float(expected(epoch))

    def no_finder(*a, **kw):
        raise AssertionError("the LR range test ran on resume")

    from weathermodel_tpu_torch.train import lr_finder

    monkeypatch.setattr(lr_finder, "find_optimal_lr", no_finder)
    res.cfg = TrainConfig(**{**res.cfg.__dict__, "num_epochs": 2})
    res.train()
    assert res.output_json["model_config"]["optimal_lr"] == 3.3e-3


def test_preempt_resume_is_exact_with_moe(data_dir, tmp_path):
    """The bitwise resume survives the MoE composition: the aux loss in the
    objective, the ragged dispatch (the grouped matmul's plain versions
    here) and the experts' parameters in Adam's state."""
    mcfg = ModelConfig(num_heads=4, num_layers=1, hidden_dim_factor=12,
                       max_len=T, num_experts=2, moe_top_k=1)

    def make(workdir, resume=False):
        return _trainer(data_dir, workdir, resume=resume, mcfg=mcfg,
                        num_epochs=2)

    base = make(tmp_path / "moe_base")
    base.train()
    assert "moe_aux" in base.output_json["losses"]["train"]

    pre = make(tmp_path / "moe_pre")
    orig_step = pre._train_step
    calls = {"n": 0}

    def step_and_stop(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            pre._stop_requested = True  # as if SIGTERM mid-epoch-0
        return orig_step(*a, **kw)

    pre._train_step = step_and_stop
    assert pre.train()["preempted"] is True

    res = make(tmp_path / "moe_pre", resume=True)
    assert res.start_epoch == 0 and res._resume_mid["batch_idx"] == 2
    res.train()
    _assert_same(base, res)


def _tiny():
    model = torch.nn.Linear(3, 2)
    optimizer = make_optimizer(model)
    return model, optimizer


def _adam_step(model, optimizer):
    optimizer.param_groups[0]["lr"] = 0.1
    model(torch.ones(4, 3)).square().sum().backward()
    optimizer.step()
    optimizer.zero_grad()


def test_checkpointer_keeps_three_newest_and_replaces_an_epoch(tmp_path):
    model, optimizer = _tiny()
    ckpt = Checkpointer(str(tmp_path))
    for epoch in range(5):
        _adam_step(model, optimizer)
        ckpt.save(epoch, model, optimizer, float(epoch), {"e": epoch})
    assert ckpt.all_epochs() == [2, 3, 4]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2", "3", "4"]
    # a second save of epoch 4 (a mid-epoch one, then the boundary's)
    ckpt.save(4, model, optimizer, 9.0, {"e": "mid"},
              mid_epoch={"batch_idx": 3, "sums": {"total_loss": 1.5}},
              generator=torch.Generator().manual_seed(5))
    _adam_step(model, optimizer)
    ckpt.save(4, model, optimizer, 8.0, {"e": "boundary"})
    assert ckpt.all_epochs() == [2, 3, 4]
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["2", "3", "4"]
    fresh, fresh_opt = _tiny()
    epoch, best, record, mid, gen = ckpt.restore(fresh, fresh_opt)
    assert (epoch, best, record, mid, gen) == (4, 8.0, {"e": "boundary"},
                                               None, None)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    assert fresh_opt.state_dict()["state"][0]["step"] == 6
    # an older epoch, with its mid-epoch record
    ckpt.save(3, model, optimizer, 7.0, {},
              mid_epoch={"batch_idx": 3, "sums": {"total_loss": 1.5}},
              generator=torch.Generator().manual_seed(5))
    _, _, _, mid, gen = ckpt.restore(fresh, fresh_opt, epoch=3)
    assert mid == {"batch_idx": 3, "sums": {"total_loss": 1.5}}
    g = torch.Generator()
    g.set_state(gen)
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(5)))


def test_async_save_holds_the_snapshot(tmp_path):
    """A wait=False save copies the state before it returns: the file holds
    the parameters, moments and step count of that moment, though Adam goes
    on updating them in place while the write is under way."""
    model, optimizer = _tiny()
    _adam_step(model, optimizer)
    want_model = {k: v.clone() for k, v in model.state_dict().items()}
    want_avg = optimizer.state[model.weight]["exp_avg"].clone()
    ckpt = Checkpointer(str(tmp_path))
    record = {"losses": [1.0]}
    ckpt.save(0, model, optimizer, 1.0, record, wait=False)
    for _ in range(3):
        _adam_step(model, optimizer)
    record["losses"].append(2.0)
    ckpt.wait_until_finished()
    assert not ckpt.saves[0]["wait"]
    assert ckpt.saves[0]["write_s"] >= 0 and ckpt.saves[0]["bytes"] > 0
    fresh, fresh_opt = _tiny()
    _, _, got_record, _, _ = ckpt.restore(fresh, fresh_opt)
    assert got_record == {"losses": [1.0]}
    for k, v in want_model.items():
        assert torch.equal(fresh.state_dict()[k], v)
        assert not torch.equal(model.state_dict()[k], v)
    assert torch.equal(fresh_opt.state[fresh.weight]["exp_avg"], want_avg)
    assert fresh_opt.state[fresh.weight]["step"] == 1


def test_boundary_saves_follow_the_jax_cadence(data_dir, tmp_path):
    """epoch % checkpoint_every == 1 or the last epoch
    (weathermodel_tpu/train/trainer.py:486), written in the background."""
    tr = _trainer(data_dir, tmp_path / "cadence", num_epochs=4)
    tr.cfg = TrainConfig(**{**tr.cfg.__dict__, "checkpoint_every": 5})
    saved = []
    real = tr.checkpointer.save

    def spy(epoch, *a, **kw):
        saved.append((epoch, kw.get("wait", True)))
        return real(epoch, *a, **kw)

    tr.checkpointer.save = spy
    result = tr.train()
    assert saved == [(1, False), (3, False)]
    assert tr.checkpointer.all_epochs() == [1, 3]
    assert [s["epoch"] for s in result["checkpoint_saves"]] == [1, 3]
    with open(tmp_path / "cadence" / "checkpoints" / "3" /
              "output_json.json") as f:
        assert json.load(f)["losses"] == tr.output_json["losses"]


def test_profile_dir_writes_a_trace(data_dir, tmp_path, monkeypatch):
    """WEATHERMODEL_PROFILE_DIR: a torch.profiler trace of epoch
    start_epoch + 1's training pass (the CPU's activities here)."""
    monkeypatch.setenv("WEATHERMODEL_PROFILE_DIR", str(tmp_path / "prof"))
    tr = _trainer(data_dir, tmp_path / "run", num_epochs=2)
    tr.train()
    traces = os.listdir(tmp_path / "prof")
    assert traces == ["weatherbert_epoch1.json"]
    with open(tmp_path / "prof" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("addmm" in n or "linear" in n for n in names)
    assert np.isfinite(tr.best_val_loss)
