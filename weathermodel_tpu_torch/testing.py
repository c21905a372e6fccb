"""Test support for the port's tests and `chip_smoke.py`. A test file takes
the fixture by importing it:

    from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

`sigterm_during_step` preempts a pretraining run the way a scheduler does,
with a real SIGTERM to the process. `yield_baseline_step` runs one seeded
training step of the GNN-RNN or Chronos baseline on a device, for holding
the card's step against the CPU's.
"""

import contextlib
import os
import signal

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs at small shapes, where one thread is about as
    fast as a pool; under the suite's parallel workers, which share the
    host's cores, an oversubscribed pool slows small ops 10-25x."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@contextlib.contextmanager
def sigterm_during_step(epoch: int, step: int):
    """Within the block, the first `PretrainTrainer` training pass of epoch
    `epoch` sends its own process a real SIGTERM just as its step `step`
    (counted from 1) starts: the handler runs while that step is in flight,
    and the trainer writes its preemption checkpoint after it."""
    from weathermodel_tpu_torch.train.trainer import PretrainTrainer

    real_run = PretrainTrainer._run_epoch
    fired = False

    def run_epoch(self, epoch_, split, mid=None):
        nonlocal fired
        if fired or epoch_ != epoch or split != "train":
            return real_run(self, epoch_, split, mid)
        real_step, n = self._train_step, 0

        def counting_step(*args, **kwargs):
            nonlocal fired, n
            n += 1
            if n == step:
                fired = True
                os.kill(os.getpid(), signal.SIGTERM)
            return real_step(*args, **kwargs)

        self._train_step = counting_step
        try:
            return real_run(self, epoch_, split, mid)
        finally:
            self._train_step = real_step

    PretrainTrainer._run_epoch = run_epoch
    try:
        yield
    finally:
        PretrainTrainer._run_epoch = real_run


def yield_baseline_step(name: str, device, n: int, seed: int = 0):
    """One fp32 training step of the yield CLIs' baseline `name` at its
    defaults (n_past_years 6, so 7 years of 52 weeks): "gnnrnn" on one
    graph of `n` counties, "chronos" on `n` windows. Weights and inputs are
    drawn from `seed`; dropout is off and the rate 0, so the step leaves
    the weights as they were. Returns (the eval-mode forward's output, the
    loss, {parameter name: gradient}), all on the CPU, for holding one
    device's step against another's."""
    import numpy as np

    from weathermodel_tpu_torch.train.state import make_optimizer

    rng = np.random.default_rng(seed)
    years, weeks, features = 7, 52, 31

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    generator = torch.Generator().manual_seed(seed)
    if name == "gnnrnn":
        from weathermodel_tpu_torch.models.gnn import (
            GNNRNNYieldModel,
            build_county_adjacency,
        )
        from weathermodel_tpu_torch.train.gnn_trainer import (
            GraphYears,
            make_gnn_train_step,
        )

        model = GNNRNNYieldModel(n_past_years=years - 1)
        model.reset_parameters(generator)
        model = model.to(device)
        graphs = GraphYears(
            put(rng.normal(size=(1, n, years, 6, weeks))),
            put(rng.normal(size=(1, n, years, 11, 6))),
            put(rng.normal(size=(1, n, years))), put(rng.normal(size=(1, n))),
            put(rng.random((1, n)) < 0.9, torch.bool))
        coords = put(np.stack([rng.uniform(30, 48, n),
                               rng.uniform(-120, -80, n)], axis=1))
        adj = put(build_county_adjacency(n))
        model.eval()
        with torch.no_grad():
            out = model(graphs.weather[0], graphs.soil[0], coords,
                        graphs.y_past[0], adj)
        loss = make_gnn_train_step(model, make_optimizer(model))(
            graphs, 0, coords, adj, None, 0.0, dropout_rate=0.0)
    elif name == "chronos":
        from weathermodel_tpu_torch.models.chronos import ChronosYieldModel
        from weathermodel_tpu_torch.train.yield_trainer import (
            YieldBatch,
            make_yield_train_step,
        )
        from weathermodel_tpu_torch.utils.config import ModelConfig

        t = years * weeks
        model = ChronosYieldModel(ModelConfig(max_len=t), years - 1)
        model.reset_parameters(generator)
        model = model.to(device)
        mask = np.ones((n, t, features), dtype=bool)
        mask[:, :, [7, 8, 11, 1, 2, 29]] = False   # the Khaki static mask
        batch = YieldBatch(
            put(rng.normal(size=(n, t, features))),
            put(rng.uniform(30, 48, (n, 2))),
            put(2009.0 + np.arange(t)[None] / weeks + np.zeros((n, 1))),
            put(np.full((n, 1), 7.0)), put(mask, torch.bool),
            put(rng.normal(size=(n, years))), put(rng.normal(size=(n, 1))),
            put(np.ones(n)), put(np.zeros((n, years, 11, 6))),
            put(np.zeros((n, years, 14))))
        model.eval()
        with torch.no_grad():
            out = model(batch.weather, batch.coords, batch.year,
                        batch.interval, batch.mask, batch.y_past)
        loss = make_yield_train_step(model, make_optimizer(model), "mse")(
            batch, generator, 0.0, dropout_rate=0.0)["total_loss"]
    else:
        raise ValueError(f"not a yield baseline: {name!r}")
    grads = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
             if p.grad is not None}
    return out.cpu(), float(loss), grads
