"""Test support for the port's tests and `chip_smoke.py`. A test file takes
the fixture by importing it:

    from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

`sigterm_during_step` preempts a pretraining run the way a scheduler does,
with a real SIGTERM to the process.
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
