"""The head-layout probes P1 and P2 (weathermodel_tpu_torch/ops/headpack.py):
their plain versions against the JAX probes `run_v0` and `run_v1`
(scripts/abl_headpack.py) in the Pallas interpreter, on the same bf16
inputs, and the port of the ablation script on the CPU.

The JAX script is loaded from its file with its `pl` replaced by a namespace
whose `pallas_call` runs in interpret mode; `scripts/` is not edited. Its
module constants (B, TP, NH) size the kernels, so a test sets them.

The bar, plain version against JAX: both sum in fp32 in another order and
round once, so all but a few entries agree bitwise and the rest differ by
one bf16 ulp at the output's scale (1.0 at outputs up to 636, about 0.02% of
the entries). A missing rounding of S changes about 40% of them.
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

from weathermodel_tpu_torch.ops import headpack
from weathermodel_tpu_torch.scripts import abl_headpack
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "abl_headpack.py"
# (T, NH): the script's shape, and smaller ones where G = 3 divides NH or not
SHAPES = [(384, 16), (40, 6), (24, 7)]
# entries that may differ from JAX's (fp32 sums in another order)
DIFFER_SHARE = 1e-2


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("jax_abl_headpack", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(**{**vars(pl), "pallas_call":
                                      functools.partial(pl.pallas_call,
                                                        interpret=True)})
    return mod


def _inputs(b, t, h, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, t, h))).to(
        torch.bfloat16) for _ in range(3))


def _jax(a):
    return jnp.asarray(a.float().numpy(), jnp.bfloat16)  # exact


def _assert_within_ulp(got, want):
    """got, want fp32 numpy: max|got - want| at most one bf16 ulp of
    max|want|, and at most DIFFER_SHARE of the entries differ."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = np.abs(got - want).max()
    assert err <= ulp, (err, ulp)
    share = (got != want).mean()
    assert share <= DIFFER_SHARE, share


@pytest.fixture(scope="module")
def jax_outputs(script):
    """run_v0 and run_v1 at B = 2 (one grid step) for each of SHAPES."""
    out = {}
    saved = {name: getattr(script, name) for name in ("B", "TP", "H", "NH")}
    try:
        for t, nh in SHAPES:
            script.B, script.TP, script.NH = 2, t, nh
            script.H = nh * script.HD
            q, k, v = _inputs(2, t, script.H)
            jq, jk, jv = map(_jax, (q, k, v))
            out[t, nh] = ((q, k, v),
                          np.asarray(script.run_v0(jq, jk, jv), np.float32),
                          np.asarray(script.run_v1(jq, jk, jv), np.float32))
    finally:
        for name, value in saved.items():
            setattr(script, name, value)
    return out


@pytest.mark.parametrize("t,nh", SHAPES)
def test_v0_plain_matches_run_v0(jax_outputs, t, nh):
    (q, k, v), want, _ = jax_outputs[t, nh]
    got = headpack.headpack_v0_reference(q, k, v, nh)
    _assert_within_ulp(got.float().numpy(), want)


@pytest.mark.parametrize("t,nh", SHAPES)
def test_v1_plain_matches_run_v1(jax_outputs, t, nh):
    (q, k, v), _, want = jax_outputs[t, nh]
    live = nh // 3 * 3 * 36
    got = headpack.headpack_v1_reference(q, k, v, nh).float().numpy()
    _assert_within_ulp(got[..., :live], want[..., :live])
    # the heads past the last whole group: never written by the kernel, NaN
    # in the interpreter and in the plain version
    assert np.isnan(want[..., live:]).all()
    assert np.isnan(got[..., live:]).all()


def test_v1_plain_leaves_head_15_nan_and_matches_v0_plain(jax_outputs):
    (q, k, v), _, _ = jax_outputs[384, 16]
    p1 = headpack.headpack_v0_reference(q, k, v).float().numpy()
    p2 = headpack.headpack_v1_reference(q, k, v).float().numpy()
    assert np.isnan(p2[..., 15 * 36:]).all()
    assert not np.isnan(p2[..., :15 * 36]).any()
    _assert_within_ulp(p2[..., :15 * 36], p1[..., :15 * 36])


def test_block_diagonal_layout():
    a = torch.arange(2 * 5 * 6 * 4, dtype=torch.float32).view(2, 5, 24)
    bd = headpack.block_diagonal(a, num_heads=6)  # HD = 4
    assert bd.shape == (2, 2, 15, 12)
    for g in range(2):
        for i in range(3):
            head = a[:, :, (3 * g + i) * 4:(3 * g + i + 1) * 4]
            block = bd[:, g, i * 5:(i + 1) * 5]
            assert torch.equal(block[..., i * 4:(i + 1) * 4], head)
            block[..., i * 4:(i + 1) * 4] = 0
            assert not block.any()


@pytest.mark.parametrize("fn", [headpack.headpack_v0, headpack.headpack_v1])
def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing(fn):
    q, k, v = _inputs(1, 24, 576, seed=1)
    ref = getattr(headpack, fn.__name__ + "_reference")
    fn.launches = 0
    torch.testing.assert_close(fn(q, k, v), ref(q, k, v), equal_nan=True,
                               rtol=0, atol=0)
    assert fn.launches == 0


@pytest.mark.parametrize("fn", [headpack.headpack_v0, headpack.headpack_v1])
def test_wrappers_reject_bad_shapes(fn):
    q, k, v = _inputs(1, 8, 576)
    with pytest.raises(ValueError, match="share one"):
        fn(q, k[:, :4], v)
    with pytest.raises(ValueError, match="multiple of"):
        fn(q[..., :570], k[..., :570], v[..., :570])


def test_script_main_on_cpu():
    out = abl_headpack.main(device="cpu", batch=2, steps=1)
    assert out["lines"][0].startswith("device: cpu")
    assert out["lines"][1].startswith("v0 vs v1 rel err (heads 0-14): ")
    assert out["lines"][2].startswith("V0 per-head matmuls (B=2): ")
    assert out["lines"][3].startswith("V1 packed block-diag g=3 (B=2): ")
    assert out["rel_err"] <= 2.0 ** -8
    assert out["v0_ms"] > 0 and out["v1_ms"] > 0


def test_script_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        abl_headpack.main(device="cuda", batch=2, steps=1)
    assert vars(abl_headpack.parse_args([])) == {"device": "cuda"}
    assert (abl_headpack.B, abl_headpack.STEPS) == (224, 30)
