"""The port's CUDA kernels on the card: against their plain PyTorch versions,
and through the model, the train step and the entry points. Every test needs a CUDA
device and skips without one. This file imports no JAX, so it also runs on
a GPU host without it:

    python -m pytest -m gpu --noconftest tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from weathermodel_tpu_torch.cli import serve
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_reference,
    fused_qkv_attention_reference,
    fused_qkv_attention_train,
    fused_qkv_attention_train_reference,
)
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.steps import (
    Batch,
    batch_to_device,
    make_train_step,
)
from weathermodel_tpu_torch.utils.config import model_config_for_size

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU host: python -m pytest "
                    "-m gpu --noconftest tests/test_torch_port_gpu.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, t, h, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h))
    w = rng.normal(size=(3 * h, h)) / h ** 0.5
    bias = rng.normal(size=(3 * h,)) * 0.1
    return tuple(torch.tensor(a, dtype=dtype, device=device)
                 for a in (x, w, bias))


# kernel vs plain, same inputs: fp32 differs only in summation order; bf16
# can also flip a rounding of q/k/v or of a softmax weight (2^-8 relative)
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


# one geometry per model size, so every head-dim instantiation (36, 28, 20,
# 12) runs; large and medium at the full T=365
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,nh", [(8, 365, 576, 16), (4, 365, 336, 12),
                                      (4, 100, 200, 10), (3, 24, 48, 4)])
def test_kernel_matches_plain(cuda, dtype, b, t, h, nh):
    x, w, bias = _inputs(b, t, h, dtype, cuda)
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(x, w, bias, nh)
    assert fused_qkv_attention.launches == before + 1
    want = fused_qkv_attention_reference(x, w, bias, nh)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# the training form and B2 against their plain versions, dropout off and on
# (the same seed on both sides, so the same keep-mask); the same bars as the
# eval form: only summation order differs in fp32, and in bf16 that can flip
# a rounding of q/k/v, of a weight or of ds (2^-8 relative)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,nh", [(4, 365, 576, 16), (3, 24, 48, 4)])
def test_train_kernels_match_plain(cuda, dtype, rate, b, t, h, nh):
    x, w, bias = _inputs(b, t, h, dtype, cuda)
    seed = 1234567
    before = (fused_qkv_attention_train.launches,
              fused_qkv_attention_bwd.launches)
    o, qkv = fused_qkv_attention_train(x, w, bias, nh, rate, seed)
    o_ref, qkv_ref = fused_qkv_attention_train_reference(x, w, bias, nh,
                                                         rate, seed)
    do = torch.randn(o.shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1)).to(dtype)
    # B2 on the reference's qkv, so that both see the same input
    dqkv = fused_qkv_attention_bwd(qkv_ref, do, nh, rate, seed)
    dqkv_ref = fused_qkv_attention_bwd_reference(qkv_ref, do, nh, rate, seed)
    torch.cuda.synchronize()
    assert (fused_qkv_attention_train.launches,
            fused_qkv_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert qkv.shape == (b, t, 3 * h) and dqkv.dtype == dtype
    for got, want in ((qkv, qkv_ref), (o, o_ref), (dqkv, dqkv_ref)):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_train_kernel_dropout_is_the_seeds(cuda):
    x, w, bias = _inputs(2, 40, 48, torch.float32, cuda)
    a, _ = fused_qkv_attention_train(x, w, bias, 4, 0.1, 5)
    b, _ = fused_qkv_attention_train(x, w, bias, 4, 0.1, 5)
    c, _ = fused_qkv_attention_train(x, w, bias, 4, 0.1, 6)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w, bias = _inputs(2, 5, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_qkv_attention(x.transpose(0, 1).contiguous().transpose(0, 1),
                            w, bias, 4)
    with pytest.raises(ValueError, match="dtype"):
        fused_qkv_attention(x, w.to(torch.bfloat16), bias, 4)
    with pytest.raises(ValueError, match="head dim"):
        fused_qkv_attention(x, w, bias, 3)  # hd 16 is not instantiated


def test_model_kernel_path_matches_plain_path(cuda):
    cfg = model_config_for_size("small", max_len=64)
    fused = make_model("weatherbert", cfg, "fused_qkv").eval()
    plain = make_model("weatherbert", cfg, "torch").eval()
    plain.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(0)
    inputs = (rng.normal(size=(4, 64, 31)), rng.uniform(-90, 90, (4, 2)),
              np.full((4, 64), 1995.0), np.full((4, 1), 7.0))
    inputs = [torch.tensor(a, dtype=torch.float32, device=cuda)
              for a in inputs]
    inputs.append(torch.tensor(rng.random((4, 64, 31)) < 0.15, device=cuda))
    with torch.inference_mode():
        got = fused.to(cuda)(*inputs)
        want = plain.to(cuda)(*inputs)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)


def test_train_step_kernel_path_matches_plain_path(cuda):
    """One step at small width, same weights, batch and mask, dropout off:
    fp32 sums in another order only (the bars of chip_smoke.py's STEP_TOL);
    then a step with dropout on launches each training kernel once per
    layer and microbatch."""
    cfg = model_config_for_size("small", max_len=64)
    rng = np.random.default_rng(0)
    batch = batch_to_device(Batch(
        rng.normal(size=(4, 64, 31)), rng.uniform(-90, 90, (4, 2)),
        np.full((4, 64), 1995.0), np.full((4, 1), 7.0)), cuda)
    mask = torch.tensor(rng.random((4, 64, 31)) < 0.15, device=cuda)
    models, losses = [], []
    for impl in ("fused_qkv", "torch"):
        model = make_model("weatherbert", cfg, impl)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(cuda)
        step = make_train_step(model, make_optimizer(model), "weatherbert")
        out = step(batch, torch.Generator().manual_seed(0), 0.0, 1,
                   mask=mask, dropout_rate=0.0)
        models.append(model)
        losses.append(out["total_loss"].item())
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    for (name, pk), pp in zip(models[0].named_parameters(),
                              models[1].parameters()):
        assert (pk.grad - pp.grad).norm() <= 1e-4 * pp.grad.norm(), name

    before = (fused_qkv_attention_train.launches,
              fused_qkv_attention_bwd.launches)
    step = make_train_step(models[0], make_optimizer(models[0]),
                           "weatherbert", grad_accum=2)
    out = step(batch, torch.Generator().manual_seed(1), 1e-4, 1)
    assert np.isfinite(out["total_loss"].item())
    n = 2 * cfg.num_layers
    assert (fused_qkv_attention_train.launches,
            fused_qkv_attention_bwd.launches) == (before[0] + n, before[1] + n)


def test_serve_entry_point_launches_kernel(cuda, tmp_path):
    cfg = model_config_for_size("mini", max_len=24)
    torch.save(make_model("weatherbert", cfg, "torch").state_dict(),
               tmp_path / "m.pth")
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "w.npz",
             weather=rng.normal(size=(45, 24, 31)).astype(np.float32))
    args = serve.build_parser().parse_args([
        "--checkpoint", str(tmp_path / "m.pth"), "--model-size", "mini",
        "--input", str(tmp_path / "w.npz"), "--output",
        str(tmp_path / "o.npz"), "--batch-size", "32", "--device", "cuda"])
    before = fused_qkv_attention.launches
    serve.run(args)
    # 45 windows = a 32-row chunk + 13 rows padded to the 32 bucket
    assert fused_qkv_attention.launches - before == cfg.num_layers * 2
    with np.load(tmp_path / "o.npz") as z:
        out = z["output"]
    assert out.shape == (45, 24, 31) and np.isfinite(out).all()
