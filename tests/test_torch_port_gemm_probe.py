"""The blocked matmul probe P3 (weathermodel_tpu_torch/ops/blocked_mm.py):
its plain version against the JAX probe `pallas_mm`
(scripts/abl_gemm_probe.py) in the Pallas interpreter, on the same bf16
inputs, and the port of the ablation script on the CPU.

The JAX script is loaded from its file with its `pl` replaced by a namespace
whose `pallas_call` runs in interpret mode; `scripts/` is not edited.
`pallas_mm` writes only the rows and columns its grid (m // bm, n // bn)
reaches; the interpreter leaves the rest NaN, and so does the plain version.

The bar on the covered region: both sum in fp32 in another order and round
once, so all but a few entries agree bitwise (0.01% here) and the rest
differ by one bf16 ulp at the output's scale.
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from weathermodel_tpu_torch.ops.blocked_mm import (
    blocked_mm,
    blocked_mm_reference,
    covered,
)
from weathermodel_tpu_torch.scripts import abl_gemm_probe
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

SCRIPT = (Path(__file__).resolve().parents[1] / "scripts"
          / "abl_gemm_probe.py")
K, N = 576, 2304
# (m, bm, bn): 512 rows past the last whole bm = 1024 block, and whole blocks
CASES = [(1536, 1024, 1152), (1536, 1024, 2304), (512, 256, 1152),
         (512, 256, 2304), (512, 512, 1152), (512, 512, 2304)]
DIFFER_SHARE = 1e-2


@pytest.fixture(scope="module")
def pallas_mm():
    spec = importlib.util.spec_from_file_location("jax_abl_gemm_probe",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(**{**vars(pl), "pallas_call":
                                      functools.partial(pl.pallas_call,
                                                        interpret=True)})
    return mod.pallas_mm


@pytest.fixture(scope="module")
def operands():
    """x [1536, K] and w [K, N] bf16 as the script makes them; a test takes
    the first m rows of x."""
    return abl_gemm_probe.inputs(1536, "cpu")


def _jax(a):
    return jnp.asarray(a.float().numpy(), jnp.bfloat16)  # exact


@pytest.mark.parametrize("m,bm,bn", CASES)
def test_plain_matches_pallas_mm(pallas_mm, operands, m, bm, bn):
    x, w = operands[0][:m], operands[1]
    want = np.asarray(pallas_mm(_jax(x), _jax(w), bm, bn), np.float32)
    got = blocked_mm_reference(x, w, bm, bn).float().numpy()
    rows, cols = covered(m, N, bm, bn)
    assert (rows, cols) == (m // bm * bm, N // bn * bn)
    region = (slice(0, rows), slice(0, cols))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[region]).max())) - 7)
    assert np.abs(got[region] - want[region]).max() <= ulp
    assert (got[region] != want[region]).mean() <= DIFFER_SHARE
    # the rows past the last whole block: unwritten, NaN on both sides
    assert np.isnan(want[rows:]).all() and np.isnan(got[rows:]).all()
    assert not np.isnan(got[region]).any()


def test_plain_version_leaves_uncovered_columns_nan():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(70, 40))).float()
    w = torch.from_numpy(rng.normal(size=(40, 50))).float()
    y = blocked_mm_reference(x, w, 32, 16)  # covers 64 rows, 48 columns
    torch.testing.assert_close(y[:64, :48], x[:64] @ w[:, :48])
    assert y[64:].isnan().all() and y[:, 48:].isnan().all()


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_nothing(operands):
    x, w = operands[0][:512], operands[1]
    blocked_mm.launches = 0
    torch.testing.assert_close(blocked_mm(x, w, 512, 1152),
                               blocked_mm_reference(x, w, 512, 1152),
                               rtol=0, atol=0)
    assert blocked_mm.launches == 0


def test_wrapper_rejects_bad_shapes_and_blocks(operands):
    x, w = operands[0][:64], operands[1]
    with pytest.raises(ValueError, match="share k"):
        blocked_mm(x, w[:100], 64, 128)
    with pytest.raises(ValueError, match="positive"):
        blocked_mm(x, w, 0, 128)


def test_script_main_on_cpu():
    out = abl_gemm_probe.main(device="cpu", m=1536, steps=1)
    lines = out["lines"]
    assert lines[0].startswith("device: cpu")
    assert lines[1].startswith("torch.matmul ")
    assert [ln.split()[2:4] for ln in lines[2:]] == [
        [f"bm={bm}", f"bn={bn}"] for bm, bn in abl_gemm_probe.ARMS]
    assert all(ln.endswith("TF/s") for ln in lines[1:])
    assert [(a["rows"], a["cols"]) for a in out["arms"]] == [
        (1536, 2304), (1536, 2304), (1024, 2304), (1536, 2304), (1024, 2304)]
    assert out["matmul_ms"] > 0 and all(a["ms"] > 0 for a in out["arms"])


def test_script_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        abl_gemm_probe.main(device="cuda", m=1536, steps=1)
    # the command line sets only the device; main runs the JAX script's shape
    assert vars(abl_gemm_probe.parse_args([])) == {"device": "cuda"}
    assert (abl_gemm_probe.M, abl_gemm_probe.STEPS) == (70144, 30)
