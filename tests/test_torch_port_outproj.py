"""Kernel B5, the fused QKV attention + out-projection (`fused_qkv_op`):
the port's plain version against the JAX package's Pallas kernel
`flash_attention_fused_outproj` (interpret mode on the CPU), the layer
against JAX `SelfAttention("pallas_qkv_op")`, `wm-serve-torch
--attention-impl fused_qkv_op` against `wm-serve --attention-impl
pallas_qkv_op`, and the inference-only rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import weathermodel_tpu.ops.pallas_attention as pa
from weathermodel_tpu.cli import serve as jax_serve
from weathermodel_tpu.models.blocks import SelfAttention as JaxSelfAttention
from weathermodel_tpu_torch import bench
from weathermodel_tpu_torch.cli import serve as port_serve
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models.blocks import SelfAttention
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    fused_qkv_attention_outproj,
    fused_qkv_attention_outproj_reference,
    fused_qkv_attention_train_reference,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import model_config_for_size


def _inputs(b, t, h):
    """tests/test_pallas_fused_qkv.py's inputs, JAX layout ([in, out])."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, t, h)).astype(np.float32)
    w = (rng.normal(size=(h, 3 * h)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(3 * h,)) * 0.1).astype(np.float32)
    rng = np.random.default_rng(7)
    wo = (rng.normal(size=(h, h)) * 0.2).astype(np.float32)
    bo = (rng.normal(size=(h,)) * 0.1).astype(np.float32)
    return x, w, bias, wo, bo


def _torch_args(x, w, bias, wo, bo):
    """The same tensors in the port's layout ([out, in] weights)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (x, w.T, bias, wo.T, bo))


@pytest.mark.parametrize("b,t,h,nh", [(3, 13, 24, 2), (5, 37, 36, 3)])
def test_plain_version_matches_jax_pallas_kernel(b, t, h, nh):
    x, w, bias, wo, bo = _inputs(b, t, h)
    want = np.asarray(pa.flash_attention_fused_outproj(
        x, w, bias, wo, bo, num_heads=nh))
    got = fused_qkv_attention_outproj(*_torch_args(x, w, bias, wo, bo), nh)
    # the JAX package's bar for this kernel (tests/test_pallas_fused_qkv.py)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_plain_version_with_dropout_is_the_training_forms_attention():
    args = _torch_args(*_inputs(2, 13, 24))
    got = fused_qkv_attention_outproj_reference(*args, 2, 0.1, 1234)
    o = fused_qkv_attention_train_reference(*args[:3], 2, 0.1, 1234)[0]
    torch.testing.assert_close(got, o @ args[3].T + args[4], rtol=0, atol=0)
    assert not torch.equal(got, fused_qkv_attention_outproj_reference(
        *args, 2))


def test_layer_matches_jax_pallas_qkv_op():
    x = np.random.default_rng(3).normal(size=(2, 9, 24)).astype(np.float32)
    m_jax = JaxSelfAttention(24, 2, attention_impl="pallas_qkv_op")
    params = m_jax.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(m_jax.apply(params, jnp.asarray(x)))
    p = jax.tree.map(np.asarray, params)["params"]
    layer = SelfAttention(24, 2, "fused_qkv_op")
    layer.load_state_dict({
        "in_proj_weight": torch.tensor(p["qkv_proj"]["kernel"].T),
        "in_proj_bias": torch.tensor(p["qkv_proj"]["bias"]),
        "out_proj.weight": torch.tensor(p["out_proj"]["kernel"].T),
        "out_proj.bias": torch.tensor(p["out_proj"]["bias"])})
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    # the same parameters as every other impl, and the same output as the
    # plain path within the kernel's bar
    plain = SelfAttention(24, 2, "torch")
    plain.load_state_dict(layer.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(got, plain(torch.from_numpy(x)),
                                   atol=5e-5, rtol=1e-4)


def test_is_inference_only():
    args = _torch_args(*_inputs(2, 9, 24))
    with pytest.raises(ValueError, match="inference-only"):
        fused_qkv_attention_outproj(args[0].requires_grad_(), *args[1:], 2)
    layer = SelfAttention(24, 2, "fused_qkv_op")
    x = torch.zeros(2, 9, 24)
    with pytest.raises(ValueError, match="'fused_qkv'"):
        layer(x)  # parameters that need a gradient
    with torch.no_grad(), pytest.raises(ValueError, match="'fused_qkv'"):
        layer(x, dropout_rate=0.1, generator=torch.Generator())
    with torch.no_grad():
        assert layer(x).shape == x.shape


MINI = {"BENCH_MODEL_SIZE": "mini", "BENCH_BATCH_PER_CHIP": "2",
        "BENCH_STEPS": "1", "BENCH_ATTENTION": "fused_qkv_op"}


def test_bench_runs_fused_qkv_op_in_eval_and_refuses_train(capsys):
    record = bench.run({**MINI, "BENCH_MODE": "eval"}, device="cpu")
    assert record["attention_impl"] == "fused_qkv_op"
    assert record["value"] > 0 and np.isfinite(record["loss"])
    with pytest.raises(ValueError, match="inference only"):
        bench.run(MINI, device="cpu")


T, N = 24, 45


def test_port_serve_matches_jax_serve(tmp_path):
    """A mini WeatherBERT's weights as a reference .pth and N=45 seeded
    windows through both entry points in fp32 (--batch-size 32: a chunk of
    32 and 13 rows padded to the 32 bucket)."""
    model = make_model("weatherbert",
                       model_config_for_size("mini", max_len=T), "torch")
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp_path / "mini.pth")
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "windows.npz",
             weather=rng.normal(size=(N, T, 31)).astype(np.float32),
             coords=rng.uniform(-90, 90, (N, 2)).astype(np.float32),
             mask=rng.random((N, T, 31)) < 0.15)
    argv = ["--checkpoint", str(tmp_path / "mini.pth"), "--model",
            "weatherbert", "--model-size", "mini", "--input",
            str(tmp_path / "windows.npz"), "--batch-size", "32",
            "--compute-dtype", "float32"]
    jax_serve.run(jax_serve.build_parser().parse_args(argv + [
        "--output", str(tmp_path / "jax.npz"), "--attention-impl",
        "pallas_qkv_op"]))
    port_serve.run(port_serve.build_parser().parse_args(argv + [
        "--output", str(tmp_path / "port.npz"), "--attention-impl",
        "fused_qkv_op", "--device", "cpu"]))
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert b["output"].shape == a["output"].shape == (N, T, 31)
        np.testing.assert_allclose(b["output"], a["output"], atol=5e-5,
                                   rtol=1e-4)
