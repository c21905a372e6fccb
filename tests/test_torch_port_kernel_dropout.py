"""Kernels B8 and B8m (ops/kernel_dropout.py, their plain versions on the
CPU) against weathermodel_tpu/ops/pallas_dropout.py where the Pallas
interpreter can run it (rate 0: it has no TPU PRNG), then the JAX TPU tests'
assertions (tests/test_pallas_dropout.py) restated on the port: survivors
exactly 1/(1 - p), keep rate within 0.01, one mask per seed, the backward
reusing the forward's mask, and no saved mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.ops import pallas_dropout as jax_pd
from weathermodel_tpu_torch.ops.dropout import ffn_keep_mask
from weathermodel_tpu_torch.ops.kernel_dropout import (
    LANES,
    kernel_dropout,
    lane_dropout,
    random_keep_mask,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rate_zero_matches_jax(dtype):
    x = np.random.default_rng(0).normal(size=(2, 3, 40))
    tdt, jdt = DTYPES[dtype]
    want = np.asarray(jax_pd.dropout(jnp.asarray(x, jdt), 0.0,
                                     jnp.int32(1)).astype(jnp.float32))
    tx = torch.tensor(x, dtype=tdt)
    for got in (kernel_dropout(tx, 0.0, 1), lane_dropout(tx, 0.0, 1)):
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert random_keep_mask((2, 3, 40), 0.0, 1, "cpu").all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 33, 576), (3, 5, 37), (1,)])
def test_kernel_dropout_is_its_mask_times_the_rounded_scale(shape, dtype):
    """kernel_dropout(x) == where(random_keep_mask(x.shape), x * scale, 0)
    bitwise, with scale = 1/(1 - p) rounded to x's dtype; the mask is the
    FFN sites' bits on the [ceil(n / 512), 512] lane view, cut to n."""
    tdt = DTYPES[dtype][0]
    x = torch.tensor(np.random.default_rng(1).normal(size=shape), dtype=tdt)
    keep = random_keep_mask(shape, 0.1, 17, "cpu")
    n = x.numel()
    lanes = ffn_keep_mask(17, -(-n // LANES), LANES, 0.1, "cpu")
    assert torch.equal(keep, lanes.reshape(-1)[:n].reshape(shape))
    scale = torch.tensor(1 / 0.9, dtype=tdt)
    assert torch.equal(kernel_dropout(x, 0.1, 17),
                       torch.where(keep, x * scale, torch.zeros_like(x)))


def test_statistics_determinism_and_scaling():
    """tests/test_pallas_dropout.py's TPU assertions, on the plain version."""
    x = torch.ones(64, 33, 576)  # last dim not lane-aligned
    rate = 0.25
    o1, o2, o3 = (kernel_dropout(x, rate, s) for s in (7, 7, 8))
    assert torch.equal(o1, o2) and not torch.equal(o1, o3)
    kept = o1 != 0
    assert torch.equal(o1[kept], torch.full_like(o1[kept], 1 / (1 - rate)))
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01
    assert abs(o1.mean().item() - 1.0) < 0.01
    mask = random_keep_mask((64, 33, 576), rate, 7, "cpu")
    assert torch.equal(mask, kept)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_reuses_forward_mask(dtype):
    tdt = DTYPES[dtype][0]
    x = torch.ones(8, 256, dtype=tdt, requires_grad=True)
    out = kernel_dropout(x, 0.5, 3)
    (dx,) = torch.autograd.grad(out, x, torch.ones_like(out))
    assert torch.equal(out != 0, dx != 0)
    assert torch.equal(dx[dx != 0], torch.full_like(dx[dx != 0], 2.0))
    x = torch.tensor(np.random.default_rng(2).normal(size=(4, 300)),
                     dtype=tdt, requires_grad=True)
    y = kernel_dropout(x, 0.1, 4)
    (g,) = torch.autograd.grad(y.float().sum(), x)
    assert torch.equal(y, g * x)


def test_kernel_dropout_saves_no_mask():
    saved = []
    x = torch.randn(3, 700, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = kernel_dropout(x, 0.1, 5)
    assert saved == []
    y.sum().backward()
    assert torch.equal(x.grad != 0, y != 0)
