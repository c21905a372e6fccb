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
from weathermodel_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd,
    flash_attention_fwd_reference,
)
from weathermodel_tpu_torch.ops.fused_ffn import (
    FusedFFN,
    fused_ffn,
    fused_ffn_reference,
)
from weathermodel_tpu_torch.ops.fused_ffn_ln import (
    FusedFFNLN,
    fused_ffn_ln,
    fused_ffn_ln_bwd,
    fused_ffn_ln_bwd_reference,
    fused_ffn_ln_reference,
)
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_reference,
    fused_qkv_attention_outproj,
    fused_qkv_attention_outproj_reference,
    fused_qkv_attention_reference,
    fused_qkv_attention_train,
    fused_qkv_attention_train_reference,
)
from weathermodel_tpu_torch.ops.gmm import (
    GroupedMatmul,
    gmm,
    gmm_reference,
    tgmm,
    tgmm_reference,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
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


# B3f and B3b against their plain versions at WeatherFormer-small's width
# (T=365, H=200, 10 heads of 20) and at mini's head dim, on the column slices
# of a packed projection (the model's layout) and on three separate tensors;
# the bars of the fused kernels, for the same reasons
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,nh", [(2, 365, 200, 10), (2, 37, 48, 4)])
def test_flash_kernels_match_plain(cuda, dtype, rate, packed, b, t, h, nh):
    rng = np.random.default_rng(2)
    qkv = torch.tensor(rng.normal(size=(b, t, 3 * h)), dtype=dtype,
                       device=cuda)
    q, k, v = qkv.chunk(3, dim=-1)
    if not packed:
        q, k, v = (a.contiguous() for a in (q, k, v))
    do = torch.tensor(rng.normal(size=(b, t, h)), dtype=dtype, device=cuda)
    seed = 424242
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    o = flash_attention_fwd(q, k, v, nh, rate, seed)
    grads = flash_attention_bwd(q, k, v, do, nh, rate, seed)
    o_ref = flash_attention_fwd_reference(q, k, v, nh, rate, seed)
    grads_ref = flash_attention_bwd_reference(q, k, v, do, nh, rate, seed)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches,
            flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert o.dtype == dtype and o.shape == (b, t, h) and o.is_contiguous()
    for got, want in ((o, o_ref), *zip(grads, grads_ref)):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_flash_kernels_draw_the_fused_kernels_mask(cuda):
    """One seed, one keep-mask: B3f on the packed projection equals B1's
    training form."""
    x, w, bias = _inputs(2, 40, 48, torch.float32, cuda)
    o_fused, qkv = fused_qkv_attention_train(x, w, bias, 4, 0.1, 9)
    o = flash_attention_fwd(*qkv.chunk(3, dim=-1), 4, 0.1, 9)
    torch.testing.assert_close(o, o_fused, atol=1e-6, rtol=1e-5)
    assert not torch.equal(o, flash_attention_fwd(*qkv.chunk(3, dim=-1), 4,
                                                  0.1, 10))


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q, k, v = (torch.zeros(2, 5, 48, device=cuda) for _ in range(3))
    with pytest.raises(ValueError, match="row stride"):
        flash_attention_fwd(q.transpose(0, 1).contiguous().transpose(0, 1),
                            k, v, 4, 0.0, 0)
    with pytest.raises(ValueError, match="contiguous do"):
        flash_attention_bwd(q, k, v, q.transpose(0, 1).contiguous()
                            .transpose(0, 1), 4, 0.0, 0)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, k, v, 3, 0.0, 0)  # hd 16 is not instantiated


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


def test_weatherformer_step_flash_path_matches_plain_path(cuda):
    """WeatherFormer-small's ELBO step through B3f/B3b against the plain
    attention path, same weights, batch and mask, dropout off (the bars of
    the WeatherBERT step above); then with dropout on each B3 kernel
    launches once per layer, and the deterministic eval forward runs B3f."""
    cfg = model_config_for_size("small", max_len=64)
    rng = np.random.default_rng(0)
    batch = batch_to_device(Batch(
        rng.normal(size=(4, 64, 31)), rng.uniform(-90, 90, (4, 2)),
        np.full((4, 64), 1995.0), np.full((4, 1), 7.0)), cuda)
    mask = torch.zeros(4, 64, 31, dtype=torch.bool, device=cuda)
    mask[..., :10] = True
    models, losses = [], []
    for impl in ("flash", "torch"):
        model = make_model("weatherformer", cfg, impl)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(cuda)
        step = make_train_step(model, make_optimizer(model), "weatherformer",
                               objective="elbo", beta=0.5)
        out = step(batch, torch.Generator().manual_seed(0), 0.0, 10,
                   mask=mask, dropout_rate=0.0)
        models.append(model)
        losses.append(out["total_loss"].item())
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    for (name, pk), pp in zip(models[0].named_parameters(),
                              models[1].parameters()):
        assert (pk.grad - pp.grad).norm() <= 1e-4 * pp.grad.norm(), name

    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    step = make_train_step(models[0], make_optimizer(models[0]),
                           "weatherformer", objective="elbo", beta=0.5)
    out = step(batch, torch.Generator().manual_seed(1), 1e-4, 10)
    assert np.isfinite(out["total_loss"].item())
    n = cfg.num_layers
    assert (flash_attention_fwd.launches,
            flash_attention_bwd.launches) == (before[0] + n, before[1] + n)
    with torch.inference_mode():
        models[0].eval()(*batch[:4], mask)
    assert flash_attention_fwd.launches == before[0] + 2 * n


# group layouts of the grouped matmul (rows per group, summing to S): group
# boundaries inside a 128-row tile, empty first/middle/last groups, S not a
# multiple of 128, one group over many tiles, tiny groups sharing one tile
GMM_GROUPS = [[100, 60, 96], [0, 256, 0], [128, 0, 44, 128], [640],
              [1, 1, 1, 127], [0, 333, 0, 367, 0]]
# (K, N): partial 32-deep slabs and 128-wide tiles with 16-byte loads, and a
# K whose rows are not whole 16-byte chunks (element loads)
GMM_DIMS = [(80, 200), (12, 40)]


def _gmm_inputs(groups, k, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    s, e = sum(groups), len(groups)
    lhs, rhs, dy = (torch.tensor(rng.normal(size=shape), dtype=dtype,
                                 device=device)
                    for shape in ((s, k), (e, k, n), (s, n)))
    return lhs, rhs, dy, torch.tensor(groups, device=device)


@pytest.mark.parametrize("k,n", GMM_DIMS)
@pytest.mark.parametrize("groups", GMM_GROUPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernels_match_plain(cuda, dtype, groups, k, n):
    """B4 (plain and rhs^T) and B4t against their plain versions on the
    edge cases, at the bars of the attention kernels (inputs of unit scale,
    sums of up to K or S products: the bf16 outputs round once, as the plain
    versions do, so they may sit one bf16 ulp apart)."""
    lhs, rhs, dy, gs = _gmm_inputs(groups, k, n, dtype, cuda)
    before = (gmm.launches, tgmm.launches)
    out = gmm(lhs, rhs, gs)
    out_t = gmm(dy, rhs, gs, trans_rhs=True)
    d_rhs = tgmm(lhs, dy, gs)
    torch.cuda.synchronize()
    assert (gmm.launches, tgmm.launches) == (before[0] + 2, before[1] + 1)
    assert out.shape == (sum(groups), n) and out.dtype == dtype
    assert d_rhs.shape == (len(groups), k, n) and d_rhs.dtype == dtype
    tol = {torch.float32: dict(atol=1e-3, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}[dtype]
    for got, want in ((out, gmm_reference(lhs, rhs, gs)),
                      (out_t, gmm_reference(dy, rhs, gs, trans_rhs=True)),
                      (d_rhs, tgmm_reference(lhs, dy, gs))):
        torch.testing.assert_close(got.float(), want.float(), **tol)
    # d_lhs through the rhs^T flag is gmm on a transposed copy, bit for bit
    assert torch.equal(out_t, gmm(dy, rhs.transpose(1, 2).contiguous(), gs))
    for g, size in enumerate(groups):
        if size == 0:
            assert torch.count_nonzero(d_rhs[g]) == 0


def test_grouped_matmul_gradients_match_plain(cuda):
    lhs, rhs, dy, gs = _gmm_inputs([70, 0, 150, 36], 48, 192, torch.float32,
                                   cuda, seed=3)
    lhs.requires_grad_()
    rhs.requires_grad_()
    before = (gmm.launches, tgmm.launches)
    got = torch.autograd.grad(GroupedMatmul.apply(lhs, rhs, gs), (lhs, rhs),
                              dy)
    assert (gmm.launches, tgmm.launches) == (before[0] + 2, before[1] + 1)
    want = torch.autograd.grad(gmm_reference(lhs, rhs, gs), (lhs, rhs), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_gmm_never_takes_the_plain_path_on_cuda(cuda, monkeypatch):
    from weathermodel_tpu_torch.ops import gmm as gmm_ops

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(gmm_ops, "gmm_reference", refuse)
    monkeypatch.setattr(gmm_ops, "tgmm_reference", refuse)
    lhs, rhs, dy, gs = _gmm_inputs([5, 7], 16, 32, torch.float32, cuda)
    gmm_ops.gmm(lhs, rhs, gs)
    gmm_ops.tgmm(lhs, dy, gs)
    with pytest.raises(ValueError, match="dtype"):
        gmm_ops.gmm(lhs.half(), rhs.half(), gs)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_ops.gmm(lhs.T.contiguous().T, rhs, gs)
    with pytest.raises(ValueError, match="group_sizes"):
        gmm_ops.gmm(lhs, rhs, gs.cpu())


def test_moe_path_never_waits_on_the_host(cuda):
    """A MoE WeatherBERT's training forward and backward on the card, dropout
    on: no operation synchronises with the host (torch's sync debug mode
    raises on one, such as a group size read back), and each layer launches
    B4 four times (two forward, two d_lhs) and B4t twice."""
    cfg = model_config_for_size("mini", max_len=32, num_experts=4)
    model = make_model("weatherbert", cfg, "fused_qkv").to(cuda).train()
    rng = np.random.default_rng(0)
    inputs = [torch.tensor(a, dtype=torch.float32, device=cuda) for a in (
        rng.normal(size=(4, 32, 31)), rng.uniform(-90, 90, (4, 2)),
        np.full((4, 32), 1995.0), np.full((4, 1), 7.0))]
    inputs.append(torch.tensor(rng.random((4, 32, 31)) < 0.15, device=cuda))
    before = (gmm.launches, tgmm.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = model(*inputs, generator=torch.Generator().manual_seed(0),
                         return_moe_aux=True)
        (out.square().mean() + cfg.moe_aux_weight * aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = cfg.num_layers
    assert (gmm.launches, tgmm.launches) == (before[0] + 4 * n,
                                             before[1] + 2 * n)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


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


# fused FFN kernels: rows not a multiple of the 32-row block, H and F not
# multiples of 16 or 128; the last at WeatherBERT-large's widths
FFN_SHAPES = [(300, 48, 192), (1000, 200, 800), (730, 576, 2304)]
# against each output's own scale: a flipped bf16 rounding of an
# intermediate moves an output by about one ulp (2^-8 relative); fp32 sums
# in another order only
FFN_SCALE_TOL = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6}


def _ffn_inputs(m, h, f, dtype, device, seed=0):
    """x [m, h], W1, b1, W2, b2, LN scale and bias (fp32 vectors), and a
    cotangent of a mean loss's scale (the weight gradients O(1))."""
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.tensor(a, dtype=dt, device=device)

    return (t(rng.normal(size=(m, h))),
            t(rng.uniform(-1, 1, (h, f)) / h ** 0.5),
            t(rng.uniform(-1, 1, f) / h ** 0.5, torch.float32),
            t(rng.uniform(-1, 1, (f, h)) / f ** 0.5),
            t(rng.uniform(-1, 1, h) / f ** 0.5, torch.float32),
            t(1 + 0.1 * rng.normal(size=h), torch.float32),
            t(0.1 * rng.normal(size=h), torch.float32),
            t(rng.normal(size=(m, h)) / m ** 0.5))


def _assert_scaled_close(name, got, want, dtype):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **TOL[dtype], msg=lambda m: name + m)
    err = (got - want).abs().max().item()
    assert err <= FFN_SCALE_TOL[dtype] * want.abs().max().item(), (name, err)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,h,f", FFN_SHAPES)
def test_ffn_kernels_match_plain(cuda, dtype, rate, m, h, f):
    x, w1, b1, w2, b2, ls, lb, do = _ffn_inputs(m, h, f, dtype, cuda)
    seeds = (11, 2 ** 32 - 5)
    counts = (fused_ffn_ln.launches, fused_ffn_ln_bwd.launches,
              fused_ffn.launches)
    ln_args = (x, w1, b1, w2, b2, ls, lb)
    _assert_scaled_close("B6f out", fused_ffn_ln(*ln_args, rate, seeds),
                         fused_ffn_ln_reference(*ln_args, rate, seeds), dtype)
    got = fused_ffn_ln_bwd(*ln_args, do, rate, seeds)
    want = fused_ffn_ln_bwd_reference(*ln_args, do, rate, seeds)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"),
                          got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _assert_scaled_close("B6b " + name, a, b, dtype)
    f_k, h_k = fused_ffn(x, w1, b1, w2, b2, rate, seeds, want_h=True)
    f_p, h_p = fused_ffn_reference(x, w1, b1, w2, b2, rate, seeds, True)
    _assert_scaled_close("B7 f", f_k, f_p, dtype)
    _assert_scaled_close("B7 h", h_k, h_p, dtype)
    f_only, none = fused_ffn(x, w1, b1, w2, b2, rate, seeds)
    assert none is None and torch.equal(f_only, f_k)
    if rate > 0:  # the kernels drop exactly where the plain versions do
        assert torch.equal(f_k == 0, f_p == 0)
        assert torch.equal(h_k == 0, h_p == 0)
    assert (fused_ffn_ln.launches, fused_ffn_ln_bwd.launches,
            fused_ffn.launches) == (counts[0] + 1, counts[1] + 1,
                                    counts[2] + 2)


def test_ffn_functions_match_autograd_of_plain(cuda):
    """FusedFFNLN's and FusedFFN's gradients against autograd through the
    plain versions (fp32, dropout on: the same masks)."""
    x, w1, b1, w2, b2, ls, lb, do = _ffn_inputs(300, 200, 800,
                                                 torch.float32, cuda)
    seeds = (3, 4)
    for fn, ref, args in (
            (lambda *a: FusedFFNLN.apply(*a, 0.1, seeds),
             lambda *a: fused_ffn_ln_reference(*a, 0.1, seeds),
             (x, w1, b1, w2, b2, ls, lb)),
            (lambda *a: FusedFFN.apply(*a, 0.1, seeds),
             lambda *a: fused_ffn_reference(*a, 0.1, seeds)[0],
             (x, w1, b1, w2, b2))):
        leaves = [a.detach().requires_grad_() for a in args]
        got = torch.autograd.grad(fn(*leaves), leaves, do)
        leaves = [a.detach().requires_grad_() for a in args]
        want = torch.autograd.grad(ref(*leaves), leaves, do)
        for a, b in zip(got, want):
            _assert_scaled_close("grad", a, b, torch.float32)


def test_ffn_kernels_never_take_the_plain_path_on_cuda(cuda, monkeypatch):
    from weathermodel_tpu_torch.ops import fused_ffn as b7_ops
    from weathermodel_tpu_torch.ops import fused_ffn_ln as b6_ops

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(b6_ops, "fused_ffn_ln_reference", refuse)
    monkeypatch.setattr(b6_ops, "fused_ffn_ln_bwd_reference", refuse)
    monkeypatch.setattr(b7_ops, "fused_ffn_reference", refuse)
    x, w1, b1, w2, b2, ls, lb, do = _ffn_inputs(40, 48, 192, torch.float32,
                                                 cuda)
    b6_ops.fused_ffn_ln(x, w1, b1, w2, b2, ls, lb)
    b6_ops.fused_ffn_ln_bwd(x, w1, b1, w2, b2, ls, lb, do)
    b7_ops.fused_ffn(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="dtype"):
        b7_ops.fused_ffn(x.half(), w1.half(), b1, w2.half(), b2)
    with pytest.raises(ValueError, match="contiguous"):
        b7_ops.fused_ffn(x, w2.T, b1, w1.T, b2)
    wide = torch.zeros(4, 656, device=cuda)
    with pytest.raises(ValueError, match="640"):
        b7_ops.fused_ffn(wide, torch.zeros(656, 8, device=cuda), b1[:8],
                         torch.zeros(8, 656, device=cuda),
                         torch.zeros(656, device=cuda))


@pytest.mark.parametrize("ffn_impl", ["fused_ffn_ln", "fused_ffn"])
def test_model_ffn_kernel_paths_match_plain_path(cuda, ffn_impl):
    """WeatherBERT-small, fp32: the eval forward of each fused FFN impl
    against the plain FFN at 5e-5; then one training step with dropout and
    grad_accum 2 launches B6f and B6b (or B7) once per layer and
    microbatch."""
    cfg = model_config_for_size("small", max_len=64)
    rng = np.random.default_rng(0)
    batch = batch_to_device(Batch(
        rng.normal(size=(4, 64, 31)), rng.uniform(-90, 90, (4, 2)),
        np.full((4, 64), 1995.0), np.full((4, 1), 7.0)), cuda)
    mask = torch.tensor(rng.random((4, 64, 31)) < 0.15, device=cuda)
    fused = make_model("weatherbert", cfg, "fused_qkv", ffn_impl).to(cuda)
    plain = make_model("weatherbert", cfg, "fused_qkv").to(cuda)
    plain.load_state_dict(fused.state_dict())
    with torch.inference_mode():
        got = fused.eval()(*batch[:4], mask)
        want = plain.eval()(*batch[:4], mask)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)
    before = (fused_ffn_ln.launches, fused_ffn_ln_bwd.launches,
              fused_ffn.launches)
    step = make_train_step(fused, make_optimizer(fused), "weatherbert",
                           grad_accum=2)
    out = step(batch, torch.Generator().manual_seed(1), 1e-4, 1)
    assert np.isfinite(out["total_loss"].item())
    n = 2 * cfg.num_layers
    expect = (n, n, 0) if ffn_impl == "fused_ffn_ln" else (0, 0, n)
    assert tuple(a - b for a, b in zip(
        (fused_ffn_ln.launches, fused_ffn_ln_bwd.launches,
         fused_ffn.launches), before)) == expect


# kernel B5 (attention + out-projection) against its plain version: every
# head dim, T = 365 and a short T, dropout off (the eval form) and on (the
# training form's attention, the same seed on both sides); B1's bars, and
# against the output's own scale
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,nh", [(4, 365, 576, 16), (3, 37, 336, 12),
                                      (2, 365, 200, 10), (3, 37, 48, 4)])
def test_outproj_kernel_matches_plain(cuda, dtype, rate, b, t, h, nh):
    x, w, bias = _inputs(b, t, h, dtype, cuda)
    rng = np.random.default_rng(1)
    wo = torch.tensor(rng.uniform(-1, 1, (h, h)) / h ** 0.5, dtype=dtype,
                      device=cuda)
    bo = torch.tensor(rng.uniform(-1, 1, h) / h ** 0.5, dtype=dtype,
                      device=cuda)
    before = fused_qkv_attention_outproj.launches
    got = fused_qkv_attention_outproj(x, w, bias, wo, bo, nh, rate, 1234567)
    want = fused_qkv_attention_outproj_reference(x, w, bias, wo, bo, nh, rate,
                                                 1234567)
    torch.cuda.synchronize()
    assert fused_qkv_attention_outproj.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_scaled_close("B5 y", got, want, dtype)


def test_outproj_kernel_rejects_what_it_does_not_take(cuda, monkeypatch):
    x, w, bias = _inputs(2, 5, 48, torch.float32, cuda)
    wo, bo = torch.zeros(48, 48, device=cuda), torch.zeros(48, device=cuda)
    with pytest.raises(ValueError, match="inference-only"):
        fused_qkv_attention_outproj(x, w, bias, wo.requires_grad_(), bo, 4)
    wo = wo.detach()
    with pytest.raises(ValueError, match="dtype"):
        fused_qkv_attention_outproj(x, w, bias, wo.to(torch.bfloat16), bo, 4)
    with pytest.raises(ValueError, match="wo must be"):
        fused_qkv_attention_outproj(x, w, bias, wo[:, :24], bo, 4)
    with pytest.raises(ValueError, match="contiguous"):
        fused_qkv_attention_outproj(x, w, bias, wo.T, bo, 4)
    with pytest.raises(RuntimeError, match="CUDA kernel launch failed"):
        # more keys than phase 1's shared memory holds: bound-checked, no
        # padding and no fallback
        x_long = _inputs(1, 2000, 576, torch.float32, cuda)[0]
        fused_qkv_attention_outproj(x_long, *_inputs(1, 1, 576,
                                                     torch.float32, cuda)[1:],
                                    torch.zeros(576, 576, device=cuda),
                                    torch.zeros(576, device=cuda), 16)
    # a CUDA tensor never takes the plain version
    import weathermodel_tpu_torch.ops.fused_qkv_attention as fqa

    def refuse(*a, **k):
        raise AssertionError("plain version on a CUDA tensor")

    monkeypatch.setattr(fqa, "fused_qkv_attention_outproj_reference", refuse)
    fused_qkv_attention_outproj(x, w, bias, wo, bo, 4)


def test_serve_entry_point_launches_outproj_kernel(cuda, tmp_path):
    """`wm-serve-torch --attention-impl fused_qkv_op`: B5 in every layer and
    no B1 eval, the output within the fp32 kernel bar of the plain path."""
    cfg = model_config_for_size("small", max_len=37)
    torch.save(make_model("weatherbert", cfg, "torch").state_dict(),
               tmp_path / "m.pth")
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "w.npz",
             weather=rng.normal(size=(45, 37, 31)).astype(np.float32))
    outs = {}
    for impl in ("fused_qkv_op", "torch"):
        args = serve.build_parser().parse_args([
            "--checkpoint", str(tmp_path / "m.pth"), "--model-size", "small",
            "--input", str(tmp_path / "w.npz"), "--output",
            str(tmp_path / f"{impl}.npz"), "--batch-size", "32",
            "--compute-dtype", "float32", "--attention-impl", impl,
            "--device", "cuda"])
        before = (fused_qkv_attention_outproj.launches,
                  fused_qkv_attention.launches)
        serve.run(args)
        if impl == "fused_qkv_op":
            assert (fused_qkv_attention_outproj.launches - before[0],
                    fused_qkv_attention.launches - before[1]) == \
                (cfg.num_layers * 2, 0)
        with np.load(tmp_path / f"{impl}.npz") as z:
            outs[impl] = z["output"]
    torch.testing.assert_close(outs["fused_qkv_op"], outs["torch"],
                               atol=1e-4, rtol=1e-3)


# the keep-mask family (B9b, B9p, B8m, B8): integer hashes and one rounding,
# so kernel and plain version agree bitwise
MASK_SHAPES = [(2048, 2304), (96, 128), (33, 384), (0, 256)]


@pytest.mark.parametrize("m,c", MASK_SHAPES)
def test_maskgen_kernels_match_plain(cuda, m, c):
    from weathermodel_tpu_torch.ops import maskgen

    keep = maskgen.bool_keep_mask(m, c, 0.1, 11, cuda)
    assert torch.equal(keep, maskgen.bool_keep_mask_reference(m, c, 0.1, 11,
                                                              cuda))
    if m % maskgen.GROUP == 0:
        packed = maskgen.packed_keep_mask(m, c, 0.1, 11, cuda)
        assert packed.dtype == torch.int32 and packed.shape == (m // 32, c)
        assert torch.equal(packed, maskgen.packed_keep_mask_reference(
            m, c, 0.1, 11, cuda))
        assert torch.equal(maskgen.unpack_keep(packed, m), keep)


@pytest.mark.parametrize("shape", [(2, 365, 2304), (3, 5, 37), (1,), (512,),
                                   (1000, 513), (0, 4)])
def test_random_keep_mask_matches_plain(cuda, shape):
    from weathermodel_tpu_torch.ops.kernel_dropout import (
        random_keep_mask,
        random_keep_mask_reference,
    )

    got = random_keep_mask(shape, 0.25, 5, cuda)
    assert got.shape == shape
    assert torch.equal(got, random_keep_mask_reference(shape, 0.25, 5, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 365, 2304), (3, 5, 37), (1000, 513)])
def test_lane_dropout_matches_plain(cuda, dtype, shape):
    """B8 forward and backward bitwise against its plain version; the
    gradient is the forward's mask times the dtype-rounded scale times dy;
    an offset view (not 16-byte aligned) takes the scalar path."""
    from weathermodel_tpu_torch.ops.kernel_dropout import (
        kernel_dropout,
        lane_dropout,
        lane_dropout_reference,
        random_keep_mask,
    )

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
    y = lane_dropout(x, 0.1, 9)
    assert torch.equal(y, lane_dropout_reference(x, 0.1, 9))
    keep = random_keep_mask(shape, 0.1, 9, cuda)
    scale = torch.tensor(1 / 0.9, dtype=dtype, device=cuda)
    assert torch.equal(y, torch.where(keep, x * scale, torch.zeros_like(x)))
    leaf = x.detach().requires_grad_()
    dy = torch.tensor(rng.normal(size=shape), dtype=dtype, device=cuda)
    (dx,) = torch.autograd.grad(kernel_dropout(leaf, 0.1, 9), leaf, dy)
    assert torch.equal(dx, torch.where(keep, dy * scale,
                                       torch.zeros_like(dy)))
    flat = x.reshape(-1)[1:]
    assert torch.equal(lane_dropout(flat, 0.1, 9),
                       lane_dropout_reference(flat, 0.1, 9))


def test_keep_mask_kernels_never_take_the_plain_path_on_cuda(cuda,
                                                             monkeypatch):
    from weathermodel_tpu_torch.ops import kernel_dropout, maskgen

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for module, name in ((maskgen, "bool_keep_mask_reference"),
                         (maskgen, "packed_keep_mask_reference"),
                         (kernel_dropout, "random_keep_mask_reference"),
                         (kernel_dropout, "lane_dropout_reference")):
        monkeypatch.setattr(module, name, refuse)
    before = (maskgen.bool_keep_mask.launches,
              maskgen.packed_keep_mask.launches,
              kernel_dropout.random_keep_mask.launches,
              kernel_dropout.lane_dropout.launches)
    maskgen.bool_keep_mask(64, 128, 0.1, 1, cuda)
    maskgen.packed_keep_mask(64, 128, 0.1, 1, cuda)
    kernel_dropout.random_keep_mask((7, 9), 0.1, 1, cuda)
    kernel_dropout.lane_dropout(torch.ones(7, 9, device=cuda), 0.1, 1)
    assert (maskgen.bool_keep_mask.launches,
            maskgen.packed_keep_mask.launches,
            kernel_dropout.random_keep_mask.launches,
            kernel_dropout.lane_dropout.launches) == tuple(
                n + 1 for n in before)
    with pytest.raises(ValueError, match="c % 128"):
        maskgen.bool_keep_mask(64, 100, 0.1, 1, cuda)
    with pytest.raises(ValueError, match="m % 32"):
        maskgen.packed_keep_mask(40, 128, 0.1, 1, cuda)
    with pytest.raises(ValueError, match="dtype"):
        kernel_dropout.lane_dropout(torch.ones(4, device=cuda,
                                               dtype=torch.half), 0.1, 1)


@pytest.mark.parametrize("impl,kernel", [("maskgen", "packed_keep_mask"),
                                         ("maskgen_bool", "bool_keep_mask")])
def test_train_step_maskgen_launches_the_mask_kernel(cuda, impl, kernel):
    """A WeatherBERT step at hidden 128 (every plain site takes the kernel:
    rows 4 x 16 = 64, C 128 or 512) launches the impl's mask kernel at the
    three sites of each layer, none in the backward (the plain attention:
    head dim 32 is not one of the attention kernels')."""
    from weathermodel_tpu_torch.ops import dropout, maskgen
    from weathermodel_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(num_heads=4, hidden_dim_factor=32, num_layers=2,
                      max_len=16)
    model = make_model("weatherbert", cfg, "torch")
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda)
    step = make_train_step(model, make_optimizer(model), "weatherbert")
    rng = np.random.default_rng(0)
    batch = batch_to_device(Batch(
        rng.normal(size=(4, 16, 31)), rng.uniform(-90, 90, (4, 2)),
        np.full((4, 16), 1995.0), np.full((4, 1), 7.0)), cuda)
    fn = getattr(maskgen, kernel)
    old = dropout.get_impl()
    dropout.set_impl(impl)
    try:
        before = fn.launches
        out = step(batch, torch.Generator().manual_seed(0), 1e-4, 1)
    finally:
        dropout.set_impl(old)
    assert np.isfinite(out["total_loss"].item())
    assert fn.launches - before == 3 * cfg.num_layers
