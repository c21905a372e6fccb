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
# 12) runs; large and medium at the full T=365. Then T at the bf16 body's
# 64-row tile edges (1, 64, 65, 383, 384), one at each head dim, and the
# longest T the float32 body takes at hd 36 (453)
ATTENTION_SHAPES = [(8, 365, 576, 16), (4, 365, 336, 12), (4, 100, 200, 10),
                    (3, 24, 48, 4), (2, 1, 576, 16), (2, 64, 336, 12),
                    (2, 65, 200, 10), (2, 383, 48, 4), (2, 384, 576, 16),
                    (1, 453, 576, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,nh", ATTENTION_SHAPES)
def test_kernel_matches_plain(cuda, dtype, b, t, h, nh):
    x, w, bias = _inputs(b, t, h, dtype, cuda)
    before = fused_qkv_attention.launches
    got = fused_qkv_attention(x, w, bias, nh)
    assert fused_qkv_attention.launches == before + 1
    want = fused_qkv_attention_reference(x, w, bias, nh)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    _assert_scaled_close("B1 o", got, want, dtype)


# the training form and B2 against their plain versions, dropout off and on
# (the same seed on both sides, so the same keep-mask); the same bars as the
# eval form: only summation order differs in fp32, and in bf16 that can flip
# a rounding of q/k/v, of a weight or of ds (2^-8 relative)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,nh", [(4, 365, 576, 16), (3, 24, 48, 4),
                                      (2, 1, 200, 10), (2, 64, 48, 4),
                                      (2, 65, 336, 12), (1, 384, 576, 16),
                                      (1, 453, 576, 16)])
def test_train_kernels_match_plain(cuda, dtype, rate, b, t, h, nh):
    x, w, bias = _inputs(b, t, h, dtype, cuda)
    seed = 1234567
    before = (fused_qkv_attention_train.launches,
              fused_qkv_attention_bwd.launches)
    o, qkv = fused_qkv_attention_train(x, w, bias, nh, rate, seed)
    o_ref, qkv_ref = fused_qkv_attention_train_reference(x, w, bias, nh,
                                                         rate, seed)
    do = torch.randn(o.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(1)).to(dtype)
    # B2 on the reference's qkv, so that both see the same input
    dqkv = fused_qkv_attention_bwd(qkv_ref, do, nh, rate, seed)
    dqkv_ref = fused_qkv_attention_bwd_reference(qkv_ref, do, nh, rate, seed)
    torch.cuda.synchronize()
    assert (fused_qkv_attention_train.launches,
            fused_qkv_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert qkv.shape == (b, t, 3 * h) and dqkv.dtype == dtype
    for got, want in ((qkv, qkv_ref), (o, o_ref), (dqkv, dqkv_ref)):
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# The bf16 forward body of B3f (csrc/flash_attention_hopper.cuh) keeps a
# head's q, k and v in shared memory up to this T at each head dim; past it
# bf16 runs the scalar body (at hd 12 it takes every T up to MAX_CONTEXT)
FWD_RESIDENT_T = {12: 1536, 20: 1152, 28: 1152, 36: 768}
FLASH_HEADS = {12: (48, 4), 20: (200, 10), 28: (336, 12), 36: (576, 16)}


def _flash_cases():
    """(b, t, h, heads): WeatherFormer-small's width (T=365, H=200, 10 heads
    of 20), the yield step's T=364 and mini's head dim at T=37; the forward
    body's 64-row tile edges (T = 1, 64, 65, 383) at each head dim; its
    largest resident T and one more (the scalar body) at hd 36 and 20."""
    cases = [(2, 365, 200, 10), (2, 364, 200, 10), (2, 37, 48, 4)]
    for hd, (h, nh) in FLASH_HEADS.items():
        cases += [(2, t, h, nh) for t in (1, 64, 65, 383)]
    for hd in (36, 20):
        h, nh = FLASH_HEADS[hd]
        cases += [(1, t, h, nh) for t in (FWD_RESIDENT_T[hd],
                                          FWD_RESIDENT_T[hd] + 1)]
    return cases


# B3f and B3b against their plain versions, on the column slices of a packed
# projection (the model's layout) and on three separate tensors; the bars of
# the fused kernels, for the same reasons. In bf16 B3f twice, bitwise equal
# (a fixed summation order), and its body's shared memory query at T; in
# fp32 both twice, bitwise equal, and the FFMA bodies' queries
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,nh", _flash_cases())
def test_flash_kernels_match_plain(cuda, dtype, rate, packed, b, t, h, nh):
    from weathermodel_tpu_torch.kernels import build

    hd = h // nh
    lib = build.load_library().lib
    assert (lib.wm_flash_attention_wgmma_smem(hd, t) > 0) == (
        t <= FWD_RESIDENT_T[hd])
    assert (lib.wm_flash_attention_ffma_smem(hd, t) > 0) == (
        t <= FFMA_FWD_T[hd])
    assert (lib.wm_attention_bwd_ffma_smem(hd, t) > 0) == (
        t <= FFMA_BWD_T[hd])
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
    _assert_scaled_close(f"B3f o T={t} hd={hd} rate={rate}", o, o_ref, dtype)
    assert torch.equal(o, flash_attention_fwd(q, k, v, nh, rate, seed))
    if dtype == torch.float32:
        again = flash_attention_bwd(q, k, v, do, nh, rate, seed)
        assert all(torch.equal(a, b) for a, b in zip(grads, again))


# The fp32 FFMA bodies (csrc/attention_ffma.cuh) keep a head's k and v (the
# forward), or each backward pass's operands, in shared memory up to this T
# at each head dim; past it fp32 runs the scalar bodies
FFMA_FWD_T = {12: 1536, 20: 1448, 28: 1032, 36: 800}
FFMA_BWD_T = {12: 1536, 20: 1320, 28: 968, 36: 760}


def _ffma_cases():
    """(b, t, h, heads): the FFMA bodies' edges at each head dim: T = 1, 9
    (8-row padding), 65 (a block of two rows a thread takes 64 a warp), 193
    (six warps of one row a thread), 385 (of two), the largest T each body
    keeps on chip and one more; WeatherBERT-large's T = 365 (B2's
    geometry)."""
    cases = [(2, 365, 576, 16)]
    for hd, (h, nh) in FLASH_HEADS.items():
        ts = {1, 9, 65, 193, 385, FFMA_FWD_T[hd], FFMA_FWD_T[hd] + 1,
              FFMA_BWD_T[hd], FFMA_BWD_T[hd] + 1}
        cases += [(1, t, h, nh) for t in sorted(ts) if t <= 1536]
    return cases


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("b,t,h,nh", _ffma_cases())
def test_fp32_ffma_bodies_match_plain(cuda, rate, b, t, h, nh):
    """fp32 B3f and B3b (on the column slices of one projection) and B2 (on
    the packed qkv) against their plain versions at TOL and 2^-16 of
    max|plain|, across the FFMA bodies' edges and their dispatch boundary
    (the shared memory queries say which body runs); each call twice,
    bitwise equal; one launch each."""
    from weathermodel_tpu_torch.kernels import build

    hd = h // nh
    lib = build.load_library().lib
    assert (lib.wm_flash_attention_ffma_smem(hd, t) > 0) == (
        t <= FFMA_FWD_T[hd])
    assert (lib.wm_attention_bwd_ffma_smem(hd, t) > 0) == (
        t <= FFMA_BWD_T[hd])
    rng = np.random.default_rng(t + h)
    qkv = torch.tensor(rng.normal(size=(b, t, 3 * h)), dtype=torch.float32,
                       device=cuda)
    do = torch.tensor(rng.normal(size=(b, t, h)), dtype=torch.float32,
                      device=cuda)
    q, k, v = qkv.chunk(3, dim=-1)
    seed = 161803
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches,
              fused_qkv_attention_bwd.launches)
    runs = [("B3f", lambda: (flash_attention_fwd(q, k, v, nh, rate, seed),),
             (flash_attention_fwd_reference(q, k, v, nh, rate, seed),)),
            ("B3b", lambda: flash_attention_bwd(q, k, v, do, nh, rate, seed),
             flash_attention_bwd_reference(q, k, v, do, nh, rate, seed)),
            ("B2", lambda: (fused_qkv_attention_bwd(qkv, do, nh, rate, seed),),
             (fused_qkv_attention_bwd_reference(qkv, do, nh, rate, seed),))]
    for name, run, want in runs:
        first, second = run(), run()
        torch.cuda.synchronize()
        for i, (got, again, ref) in enumerate(zip(first, second, want)):
            assert torch.equal(got, again), (name, i)
            torch.testing.assert_close(got, ref, **TOL[torch.float32])
            _assert_scaled_close(f"{name} {i} T={t} hd={hd} rate={rate}", got,
                                 ref, torch.float32)
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches,
            fused_qkv_attention_bwd.launches) == (before[0] + 2, before[1] + 2,
                                                  before[2] + 2)


# The bf16 backward body (csrc/attention_bwd_hopper.cuh, B2 and B3b) keeps a
# head's operands in shared memory up to this T at each head dim; past it bf16
# runs the scalar passes (at hd 12 it takes every T up to MAX_CONTEXT)
BWD_RESIDENT_T = {12: 1536, 20: 832, 28: 832, 36: 576}
BWD_HEADS = {12: (48, 4), 20: (200, 10), 28: (336, 12), 36: (576, 16)}


def _bwd_body_cases():
    """(t, h, heads): the body's 64-row tile edges, its largest resident T
    and one past it (the scalar passes), at each head dim."""
    cases = []
    for hd, (h, nh) in BWD_HEADS.items():
        top = BWD_RESIDENT_T[hd]
        for t in (1, 64, 65, 383, 384, top, top + 1):
            if t <= 1536:
                cases.append((t, h, nh))
    return cases


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t,h,nh", _bwd_body_cases())
def test_bf16_bwd_body_matches_plain(cuda, t, h, nh, rate):
    """bf16 B2 (packed qkv) and B3b (on the column slices of one projection
    and on three tensors) against their plain versions at 2^-6 of max|plain|,
    across the body's tile edges and its dispatch boundary; each call twice,
    bitwise equal (no atomics, a fixed summation order); one launch each."""
    from weathermodel_tpu_torch.kernels import build

    hd = h // nh
    smem = build.load_library().lib.wm_attention_bwd_wgmma_smem
    assert (smem(hd, t) > 0) == (t <= BWD_RESIDENT_T[hd])
    assert smem(hd, BWD_RESIDENT_T[hd]) > 0
    rng = np.random.default_rng(t + h)
    qkv = torch.tensor(rng.normal(size=(1, t, 3 * h)), dtype=torch.bfloat16,
                       device=cuda)
    do = torch.tensor(rng.normal(size=(1, t, h)), dtype=torch.bfloat16,
                      device=cuda)
    seed = 271828
    slices = qkv.chunk(3, dim=-1)
    separate = tuple(a.contiguous() for a in slices)
    before = (fused_qkv_attention_bwd.launches, flash_attention_bwd.launches)
    runs = [("B2", lambda: (fused_qkv_attention_bwd(qkv, do, nh, rate, seed),),
             (fused_qkv_attention_bwd_reference(qkv, do, nh, rate, seed),))]
    for name, (q, k, v) in (("B3b slices", slices), ("B3b tensors", separate)):
        runs.append((name,
                     lambda q=q, k=k, v=v: flash_attention_bwd(
                         q, k, v, do, nh, rate, seed),
                     flash_attention_bwd_reference(q, k, v, do, nh, rate,
                                                   seed)))
    for name, run, want in runs:
        first, second = run(), run()
        torch.cuda.synchronize()
        for i, (got, again, ref) in enumerate(zip(first, second, want)):
            assert torch.equal(got, again), (name, i)
            _assert_scaled_close(f"{name} {i} T={t} hd={hd} rate={rate}", got,
                                 ref, torch.bfloat16)
    assert (fused_qkv_attention_bwd.launches,
            flash_attention_bwd.launches) == (before[0] + 2, before[1] + 4)


def test_bf16_bwd_rejects_what_it_does_not_take(cuda):
    """The bf16 backward's layout rule: H a multiple of 8 (3 heads of 12) and
    every operand's rows 8-byte aligned raise a ValueError from B2 and B3b
    before any launch; float32 takes both on the scalar passes."""
    counts = (fused_qkv_attention_bwd.launches, flash_attention_bwd.launches)

    def packed(t, h, dtype, shift=0):
        buf = torch.randn(t * 3 * h + shift, device=cuda).to(dtype)
        return buf[shift:].view(1, t, 3 * h)

    qkv, do = packed(24, 36, torch.bfloat16), torch.randn(
        1, 24, 36, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_qkv_attention_bwd(qkv, do, 3, 0.0, 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_bwd(*qkv.chunk(3, dim=-1), do, 3, 0.0, 0)
    qkv = packed(24, 48, torch.bfloat16, shift=1)
    do = torch.randn(1, 24, 48, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="8-byte aligned"):
        fused_qkv_attention_bwd(qkv, do, 4, 0.1, 3)
    with pytest.raises(ValueError, match="8-byte aligned"):
        flash_attention_bwd(*qkv.chunk(3, dim=-1), do, 4, 0.1, 3)
    q, k, v = (a.contiguous() for a in packed(24, 48, torch.bfloat16)
               .chunk(3, dim=-1))
    shifted = torch.empty(q.numel() + 2, dtype=q.dtype,
                          device=cuda)[2:].view_as(q)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="8-byte aligned"):
        flash_attention_bwd(shifted, k, v, do, 4, 0.0, 0)
    assert (fused_qkv_attention_bwd.launches,
            flash_attention_bwd.launches) == counts
    qkv = packed(24, 36, torch.float32, shift=1)
    do = torch.randn(1, 24, 36, device=cuda)
    _assert_scaled_close("fp32 B2 at H = 36",
                         fused_qkv_attention_bwd(qkv, do, 3, 0.0, 0),
                         fused_qkv_attention_bwd_reference(qkv, do, 3, 0.0, 0),
                         torch.float32)


def test_bf16_fwd_rejects_what_it_does_not_take(cuda):
    """bf16 B3f takes its body's layout rule at every T (H a multiple of 8,
    every operand's rows 8-byte aligned): a ValueError before any launch;
    float32 takes both on the scalar body."""
    before = flash_attention_fwd.launches
    qkv = torch.randn(1, 24, 3 * 36, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_fwd(*qkv.chunk(3, dim=-1), 3, 0.0, 0)
    buf = torch.randn(24 * 3 * 48 + 1, device=cuda).to(torch.bfloat16)
    qkv = buf[1:].view(1, 24, 3 * 48)
    with pytest.raises(ValueError, match="8-byte aligned"):
        flash_attention_fwd(*qkv.chunk(3, dim=-1), 4, 0.1, 3)
    q, k, v = (a.contiguous() for a in torch.randn(
        1, 24, 3 * 48, device=cuda).to(torch.bfloat16).chunk(3, dim=-1))
    shifted = torch.empty(q.numel() + 2, dtype=q.dtype,
                          device=cuda)[2:].view_as(q)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="8-byte aligned"):
        flash_attention_fwd(shifted, k, v, 4, 0.0, 0)
    # past the body's T (800 > 768 at hd 36) too, where the scalar body runs
    qkv = torch.randn(1, 800, 3 * 576 + 1, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="8-byte aligned"):
        flash_attention_fwd(*qkv[..., 1:].chunk(3, dim=-1), 16, 0.0, 0)
    assert flash_attention_fwd.launches == before
    buf = torch.randn(24 * 3 * 36 + 1, device=cuda)
    q, k, v = buf[1:].view(1, 24, 3 * 36).chunk(3, dim=-1)
    _assert_scaled_close("fp32 B3f at H = 36, odd offsets",
                         flash_attention_fwd(q, k, v, 3, 0.1, 5),
                         flash_attention_fwd_reference(q, k, v, 3, 0.1, 5),
                         torch.float32)


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


@pytest.mark.parametrize("b,t,h,nh", [(2, 365, 576, 16), (3, 65, 200, 10)])
def test_bf16_train_kernel_draws_the_scalar_bodys_mask(cuda, b, t, h, nh):
    """One seed, one keep-mask across the bodies: in bf16 B1's training form
    (attention_hopper.cuh) against B3f (its own wgmma body,
    flash_attention_hopper.cuh, at these T) on the same qkv, with dropout
    0.1; a mask that differed in one bit would move o far past the bars.
    Then B2 on the B1 body's qkv residual against its plain version."""
    x, w, bias = _inputs(b, t, h, torch.bfloat16, cuda)
    o, qkv = fused_qkv_attention_train(x, w, bias, nh, 0.1, 77)
    o_flash = flash_attention_fwd(*qkv.chunk(3, dim=-1), nh, 0.1, 77)
    _assert_scaled_close("B1 train vs B3f", o, o_flash, torch.bfloat16)
    do = torch.randn(o.shape, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(2)
                     ).to(torch.bfloat16)
    _assert_scaled_close(
        "B2", fused_qkv_attention_bwd(qkv, do, nh, 0.1, 77),
        fused_qkv_attention_bwd_reference(qkv, do, nh, 0.1, 77),
        torch.bfloat16)


@pytest.mark.parametrize("h,nh", [(48, 4), (200, 10), (336, 12), (576, 16)])
def test_bf16_body_takes_t_up_to_its_limit(cuda, h, nh):
    """Every attention kernel at the longest T it takes at each head dim
    (MAX_CONTEXT, the library's own limit: the bf16 body's shared memory
    there is its streaming layout's), in bf16, then one more: a ValueError
    naming the limit from B1's two forms, B5, B2, B3f and B3b, in both
    dtypes, before any launch, and no fallback."""
    from weathermodel_tpu_torch.kernels import build
    from weathermodel_tpu_torch.ops.attention import MAX_CONTEXT

    hd = h // nh
    lib = build.load_library().lib
    assert lib.wm_qkv_attention_wgmma_smem(hd, MAX_CONTEXT) > 0
    assert lib.wm_qkv_attention_wgmma_smem(hd, MAX_CONTEXT + 1) == 0
    x, w, bias = _inputs(1, MAX_CONTEXT, h, torch.bfloat16, cuda)
    _assert_scaled_close("B1 o at the limit",
                         fused_qkv_attention(x, w, bias, nh),
                         fused_qkv_attention_reference(x, w, bias, nh),
                         torch.bfloat16)
    kernels = (fused_qkv_attention, fused_qkv_attention_train,
               fused_qkv_attention_outproj, fused_qkv_attention_bwd,
               flash_attention_fwd, flash_attention_bwd)
    counts = [k.launches for k in kernels]
    for dtype in (torch.float32, torch.bfloat16):
        x, w, bias = _inputs(1, MAX_CONTEXT + 1, h, dtype, cuda)
        wo = torch.zeros(h, h, dtype=dtype, device=cuda)
        bo = torch.zeros(h, dtype=dtype, device=cuda)
        qkv = torch.zeros(1, MAX_CONTEXT + 1, 3 * h, dtype=dtype, device=cuda)
        q, k, v = qkv.chunk(3, dim=-1)
        match = f"T up to {MAX_CONTEXT}, got T={MAX_CONTEXT + 1}"
        for call in (lambda: fused_qkv_attention(x, w, bias, nh),
                     lambda: fused_qkv_attention_train(x, w, bias, nh, 0.1, 1),
                     lambda: fused_qkv_attention_outproj(x, w, bias, wo, bo,
                                                         nh),
                     lambda: fused_qkv_attention_bwd(qkv, x, nh, 0.1, 1),
                     lambda: flash_attention_fwd(q, k, v, nh, 0.1, 1),
                     lambda: flash_attention_bwd(q, k, v, x, nh, 0.1, 1)):
            with pytest.raises(ValueError, match=match):
                call()
    assert [k.launches for k in kernels] == counts


# every attention form past the T whose rows fit on chip (the bf16 body's
# streamed K^T and V^T, the scalar bodies' device workspace): T = 730 (two
# years of daily windows, as `wm-serve-torch` takes them) and 1024, at every
# head dim, in both dtypes, forward and backward, dropout 0.1, against the
# plain versions (the same seed on both sides)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,nh", [(48, 4), (200, 10), (336, 12), (576, 16)])
@pytest.mark.parametrize("t", [730, 1024])
def test_attention_kernels_take_long_context(cuda, t, h, nh, dtype):
    x, w, bias = _inputs(1, t, h, dtype, cuda, seed=t)
    rng = np.random.default_rng(h)
    wo = torch.tensor(rng.normal(size=(h, h)) / h ** 0.5, dtype=dtype,
                      device=cuda)
    bo = torch.tensor(rng.normal(size=h) * 0.1, dtype=dtype, device=cuda)
    do = torch.tensor(rng.normal(size=(1, t, h)), dtype=dtype, device=cuda)
    seed, rate = 31337, 0.1
    pairs = [("B1 eval", fused_qkv_attention(x, w, bias, nh),
              fused_qkv_attention_reference(x, w, bias, nh)),
             ("B5", fused_qkv_attention_outproj(x, w, bias, wo, bo, nh),
              fused_qkv_attention_outproj_reference(x, w, bias, wo, bo, nh))]
    o, qkv = fused_qkv_attention_train(x, w, bias, nh, rate, seed)
    o_ref, qkv_ref = fused_qkv_attention_train_reference(x, w, bias, nh, rate,
                                                         seed)
    pairs += [("B1 train o", o, o_ref), ("B1 train qkv", qkv, qkv_ref),
              ("B2", fused_qkv_attention_bwd(qkv_ref, do, nh, rate, seed),
               fused_qkv_attention_bwd_reference(qkv_ref, do, nh, rate,
                                                 seed))]
    q, k, v = qkv_ref.chunk(3, dim=-1)
    pairs.append(("B3f", flash_attention_fwd(q, k, v, nh, rate, seed),
                  flash_attention_fwd_reference(q, k, v, nh, rate, seed)))
    for name, got, want in zip(
            ("B3b dq", "B3b dk", "B3b dv"),
            flash_attention_bwd(q, k, v, do, nh, rate, seed),
            flash_attention_bwd_reference(q, k, v, do, nh, rate, seed)):
        pairs.append((name, got, want))
    torch.cuda.synchronize()
    for name, got, want in pairs:
        assert got.dtype == dtype and got.shape == want.shape, name
        _assert_scaled_close(f"{name} T={t}", got, want, dtype)


def test_bf16_body_rejects_what_it_does_not_take(cuda):
    """H not a multiple of 8 (3 heads of 12) and x or w_qkv off a 16-byte
    boundary raise a ValueError in bf16, before any launch; float32 takes
    both on the scalar body."""
    counts = (fused_qkv_attention.launches,
              fused_qkv_attention_train.launches)
    x, w, bias = _inputs(2, 24, 36, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_qkv_attention(x, w, bias, 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_qkv_attention_train(x, w, bias, 3, 0.0, 0)
    x, w, bias = _inputs(2, 24, 48, torch.bfloat16, cuda)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=cuda)[1:].view_as(x)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_qkv_attention(shifted, w, bias, 4)
    assert (fused_qkv_attention.launches,
            fused_qkv_attention_train.launches) == counts
    x, w, bias = _inputs(2, 24, 36, torch.float32, cuda)
    _assert_scaled_close("fp32 B1 o at H = 36",
                         fused_qkv_attention(x, w, bias, 3),
                         fused_qkv_attention_reference(x, w, bias, 3),
                         torch.float32)


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


def _yield_batch(device, b=4, n_past=1, seed=0):
    from weathermodel_tpu_torch.train.yield_trainer import YieldBatch

    rng = np.random.default_rng(seed)
    t = (n_past + 1) * 52
    mask = np.ones((b, t, 31), dtype=bool)
    mask[:, :, [7, 8, 11, 1, 2, 29]] = False
    arrays = (rng.normal(size=(b, t, 31)), rng.uniform(30, 48, (b, 2)),
              2005.0 + np.arange(t)[None] / 52 + np.zeros((b, 1)),
              np.full((b, 1), 7.0), mask, rng.normal(size=(b, n_past + 1)),
              rng.normal(size=(b, 1)), np.ones(b),
              np.zeros((b, n_past + 1, 11, 6)), np.zeros((b, n_past + 1, 14)))
    return YieldBatch(*(torch.tensor(a, device=device,
                                     dtype=torch.bool if a.dtype == bool
                                     else torch.float32) for a in arrays))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yield_step_flash_path_matches_plain_path(cuda, dtype):
    """WeatherFormer-small's yield ELBO step through B3f/B3b against the
    plain attention path, same weights, batch and eps, dropout off. fp32 at
    chip_smoke.py's STEP_TOL (1e-5 of the loss, 1e-3 of each gradient's
    norm: every gradient comes back through all layers from one pooled
    prediction a window, and the plain path alone differs by ~1.7e-4
    between the card and the CPU); bf16 at 2^-6 of the loss and 5e-2 of
    each gradient's norm. The pooling logit's bias is left out: its
    gradient is zero in exact arithmetic. Then with dropout on each B3
    kernel launches once per layer, and the eval step runs B3f once per
    layer."""
    from weathermodel_tpu_torch.models.yield_models import (
        WeatherFormerYieldModel,
    )
    from weathermodel_tpu_torch.train.yield_trainer import (
        make_yield_eval_step,
        make_yield_train_step,
    )

    cfg = model_config_for_size("small", max_len=104, compute_dtype=dtype)
    batch = _yield_batch(cuda)
    eps = torch.randn(batch.weather.shape, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(1))
    models, losses = [], []
    for impl in ("flash", "torch"):
        model = WeatherFormerYieldModel(cfg, 1, impl)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(cuda)
        step = make_yield_train_step(model, make_optimizer(model), "elbo",
                                     1e-4)
        out = step(batch, torch.Generator().manual_seed(0), 0.0, eps=eps,
                   dropout_rate=0.0)
        models.append(model)
        losses.append(out["total_loss"].item())
    loss_bar, grad_bar = (1e-5, 1e-3) if dtype == "float32" else (2**-6, 5e-2)
    assert abs(losses[0] - losses[1]) <= loss_bar * abs(losses[1])
    for (name, pk), pp in zip(models[0].named_parameters(),
                              models[1].parameters()):
        if name == "weather_attention.2.bias":
            continue  # the softmax over T ignores it: its gradient is 0
        assert (pk.grad - pp.grad).norm() <= grad_bar * pp.grad.norm(), name

    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    step = make_yield_train_step(models[0], make_optimizer(models[0]), "elbo",
                                 1e-4)
    out = step(batch, torch.Generator().manual_seed(1), 1e-4)
    assert np.isfinite(out["total_loss"].item())
    n = cfg.num_layers
    assert (flash_attention_fwd.launches,
            flash_attention_bwd.launches) == (before[0] + n, before[1] + n)
    rmse = make_yield_eval_step(models[0], "elbo")(
        batch, torch.Generator().manual_seed(2))["total_loss"]
    assert np.isfinite(rmse.item())
    assert flash_attention_fwd.launches == before[0] + 2 * n


def test_wm_yield_torch_on_the_card(cuda):
    """`wm-yield-torch`'s run at WeatherFormer-small on a small synthetic
    frame: 4 B3f and 4 B3b launches a training step, 4 B3f a validation
    batch, none of B1/B2, finite RMSE."""
    from weathermodel_tpu_torch.cli import yield_main
    from weathermodel_tpu_torch.data.yield_data import synthetic_yield_df

    args = yield_main.build_parser().parse_args([
        "--country", "synthetic", "--n-past-years", "1", "--n-train-years",
        "4", "--test-year", "2016", "--n-epochs", "2", "--n-warmup-epochs",
        "0", "--batch-size", "8"])
    args.crop_df = synthetic_yield_df(seed=0, n_locs=5)
    counted = (flash_attention_fwd, flash_attention_bwd,
               fused_qkv_attention_train, fused_qkv_attention_bwd,
               fused_qkv_attention)
    before = [fn.launches for fn in counted]
    result = yield_main.run(args)
    (trainer,) = result["trainers"]
    steps = sum(len(s) for s in trainer.train_step_seconds)
    val_batches = 2 * -(-trainer.test_arrays.weather.shape[0] // 8)
    got = [fn.launches - b for fn, b in zip(counted, before)]
    assert got == [4 * (steps + val_batches), 4 * steps, 0, 0, 0]
    assert np.isfinite(result["avg_rmse_bu_acre"])


# group layouts of the grouped matmul (rows per group, summing to S): group
# boundaries inside a 128-row tile, empty first/middle/last groups, S not a
# multiple of 128, one group over many tiles, tiny groups sharing one tile
GMM_GROUPS = [[100, 60, 96], [0, 256, 0], [128, 0, 44, 128], [640],
              [1, 1, 1, 127], [0, 333, 0, 367, 0]]
# (K, N): in bf16 both sides of the dispatch in gmm.cu and tgmm.cu. (80, 200)
# runs the wgmma/TMA body (gmm_hopper.cuh) in partial 64-deep slabs and
# 192-wide tiles; (12, 40), a K whose rows are not whole 16-byte chunks, runs
# gmm_common.cuh's tiles (element loads). fp32 runs the tiles at both.
GMM_DIMS = [(80, 200), (12, 40)]
GMM_TOL = {torch.float32: dict(atol=1e-3, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


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
    tol = GMM_TOL[dtype]
    for got, want in ((out, gmm_reference(lhs, rhs, gs)),
                      (out_t, gmm_reference(dy, rhs, gs, trans_rhs=True)),
                      (d_rhs, tgmm_reference(lhs, dy, gs))):
        torch.testing.assert_close(got.float(), want.float(), **tol)
    # d_lhs through the rhs^T flag is gmm on a transposed copy, bit for bit
    assert torch.equal(out_t, gmm(dy, rhs.transpose(1, 2).contiguous(), gs))
    for g, size in enumerate(groups):
        if size == 0:
            assert torch.count_nonzero(d_rhs[g]) == 0


# uneven groups of a few thousand rows: an empty one, one under a slab, group
# boundaries inside 128-row tiles and 64-row slabs
GMM_BODY_GROUPS = [700, 0, 1500, 333, 64, 1200, 5, 198]


def _gmm_body_calls(lhs, rhs, dy, gs):
    """B4 (rhs as stored, and its d_lhs form through rhs^T) and B4t."""
    return (gmm(lhs, rhs, gs), gmm(dy, rhs, gs, trans_rhs=True),
            tgmm(lhs, dy, gs))


@pytest.mark.parametrize("k,n", [(576, 2304), (2304, 576)])
def test_gmm_body_matches_plain_at_moe_widths(cuda, k, n):
    """bf16 B4's four forms of a MoE layer (fwd1 and dlhs1 at 576 x 2304, fwd2
    and dlhs2 at 2304 x 576) and B4t's two on the wgmma/TMA body, against
    their plain versions at the bf16 bars; two calls give equal bits."""
    lhs, rhs, dy, gs = _gmm_inputs(GMM_BODY_GROUPS, k, n, torch.bfloat16,
                                   cuda, seed=5)
    before = (gmm.launches, tgmm.launches)
    got = _gmm_body_calls(lhs, rhs, dy, gs)
    again = _gmm_body_calls(lhs, rhs, dy, gs)
    torch.cuda.synchronize()
    assert (gmm.launches, tgmm.launches) == (before[0] + 4, before[1] + 2)
    wants = (gmm_reference(lhs, rhs, gs),
             gmm_reference(dy, rhs, gs, trans_rhs=True),
             tgmm_reference(lhs, dy, gs))
    for name, g, a, w in zip(("B4", "B4 rhs^T", "B4t"), got, again, wants):
        assert torch.equal(g, a), name
        torch.testing.assert_close(g.float(), w.float(),
                                   **GMM_TOL[torch.bfloat16])
        _assert_scaled_close(name, g, w, torch.bfloat16)
    assert torch.count_nonzero(got[2][1]) == 0  # the empty group


@pytest.mark.parametrize("k,n", [(576, 2304), (80, 200)])
def test_gmm_body_masks_other_groups_rows(cuda, k, n):
    """NaN in the rows of one group (lhs and dy) leaves every other group's B4
    rows and B4t blocks finite and equal to the plain versions: B4 zeroes the
    rows of other groups in its A stage, B4t in both operands' stages (the
    TPU's rule, 0 * NaN = NaN)."""
    groups = [300, 77, 450, 0, 173]
    lhs, rhs, dy, gs = _gmm_inputs(groups, k, n, torch.bfloat16, cuda,
                                   seed=6)
    lhs[300:377] = float("nan")
    dy[300:377] = float("nan")
    out, out_t, d_rhs = _gmm_body_calls(lhs, rhs, dy, gs)
    torch.cuda.synchronize()
    keep = torch.ones(sum(groups), dtype=torch.bool, device=cuda)
    keep[300:377] = False
    for got, want in ((out, gmm_reference(lhs, rhs, gs)),
                      (out_t, gmm_reference(dy, rhs, gs, trans_rhs=True))):
        assert torch.isfinite(got[keep]).all()
        torch.testing.assert_close(got[keep].float(), want[keep].float(),
                                   **GMM_TOL[torch.bfloat16])
    want = tgmm_reference(lhs, dy, gs)
    others = [0, 2, 3, 4]
    assert torch.isfinite(d_rhs[others]).all()
    torch.testing.assert_close(d_rhs[others].float(), want[others].float(),
                               **GMM_TOL[torch.bfloat16])


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
# multiples of 16 or 128; the third at WeatherBERT-large's widths; then rows
# not a multiple of the bf16 body's 64-row block and of its cluster (65 =
# 64 + 1, 1001), small's H = 200 (halves of 100, F = 800 = 6 x 128 + 32) and
# medium's (336, 1344); last the widest H the kernels take (the bf16 body's
# 10-atom instantiation)
FFN_SHAPES = [(300, 48, 192), (1000, 200, 800), (730, 576, 2304),
              (65, 576, 2304), (1001, 200, 800), (333, 336, 1344),
              (97, 640, 2560)]
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


def test_ffn_kernels_reject_what_they_do_not_take(cuda):
    """The bf16 bodies (forward, and B6b's) need H and F multiples of 8 and
    16-byte aligned x and weights (TMA); they raise on anything else, before
    any launch, and never fall back. H > 640 raises in both dtypes; fp32
    takes any H and F up to it."""
    counts = (fused_ffn_ln.launches, fused_ffn.launches)
    for m, h, f in ((64, 52, 192), (64, 48, 100)):
        x, w1, b1, w2, b2, ls, lb, _ = _ffn_inputs(m, h, f, torch.bfloat16,
                                                    cuda)
        with pytest.raises(ValueError, match="multiples of 8"):
            fused_ffn(x, w1, b1, w2, b2)
        with pytest.raises(ValueError, match="multiples of 8"):
            fused_ffn_ln(x, w1, b1, w2, b2, ls, lb)
    x, w1, b1, w2, b2, ls, lb, _ = _ffn_inputs(64, 48, 192, torch.bfloat16,
                                                cuda)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=cuda)[1:].view_as(x)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_ffn(shifted, w1, b1, w2, b2, want_h=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_ffn_ln(shifted, w1, b1, w2, b2, ls, lb)
    for dtype in (torch.bfloat16, torch.float32):
        wide = torch.zeros(4, 648, device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="640"):
            fused_ffn(wide, torch.zeros(648, 8, device=cuda, dtype=dtype),
                      b1[:8], torch.zeros(8, 648, device=cuda, dtype=dtype),
                      torch.zeros(648, device=cuda))
    assert (fused_ffn_ln.launches, fused_ffn.launches) == counts
    # B6b's bf16 body: the same rule, do 16-byte aligned too, and F up to
    # 2560 (its mask bits' shared memory)
    count = fused_ffn_ln_bwd.launches
    for m, h, f in ((64, 52, 192), (64, 48, 100)):
        args = _ffn_inputs(m, h, f, torch.bfloat16, cuda)
        with pytest.raises(ValueError, match="multiples of 8"):
            fused_ffn_ln_bwd(*args)
    x, w1, b1, w2, b2, ls, lb, do = _ffn_inputs(64, 48, 192, torch.bfloat16,
                                                 cuda)
    shifted_do = torch.empty(do.numel() + 1, dtype=do.dtype,
                             device=cuda)[1:].view_as(do)
    shifted_do.copy_(do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_ffn_ln_bwd(x, w1, b1, w2, b2, ls, lb, shifted_do)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_ffn_ln_bwd(shifted, w1, b1, w2, b2, ls, lb, do)
    args = _ffn_inputs(64, 48, 2568, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="F up to 2560"):
        fused_ffn_ln_bwd(*args)
    assert fused_ffn_ln_bwd.launches == count
    x, w1, b1, w2, b2, ls, lb, _ = _ffn_inputs(64, 52, 100, torch.float32,
                                                cuda)
    _assert_scaled_close("fp32 B7 f", fused_ffn(x, w1, b1, w2, b2)[0],
                         fused_ffn_reference(x, w1, b1, w2, b2)[0],
                         torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_kernels_take_vectors_at_odd_offsets(cuda, dtype):
    """Biases and LN parameters that are views 4 bytes off an 8-byte
    boundary (the bf16 body reads them in pairs): the wrappers copy them,
    and the kernels match their plain versions."""
    x, w1, b1, w2, b2, ls, lb, _ = _ffn_inputs(97, 48, 192, dtype, cuda)

    def shifted(v):
        out = torch.zeros(v.numel() + 1, device=cuda)[1:]
        assert out.data_ptr() % 8 == 4
        return out.copy_(v)

    b1o, b2o, lso, lbo = (shifted(v) for v in (b1, b2, ls, lb))
    _assert_scaled_close(
        "B6f out", fused_ffn_ln(x, w1, b1o, w2, b2o, lso, lbo, 0.1, (1, 2)),
        fused_ffn_ln_reference(x, w1, b1, w2, b2, ls, lb, 0.1, (1, 2)), dtype)
    for got, want in zip(
            fused_ffn(x, w1, b1o, w2, b2o, 0.1, (1, 2), want_h=True),
            fused_ffn_reference(x, w1, b1, w2, b2, 0.1, (1, 2), True)):
        _assert_scaled_close("B7", got, want, dtype)


def _ffn_grid_inputs(m, h, f, device, seed=0):
    """`_ffn_inputs` in bf16 with x (multiples of 1/4 up to 1) and W1 and b1
    (multiples of 1/256 up to 1/32) on a grid where every partial sum of
    x W1 + b1 is exact in fp32: the kernel and the plain version then take
    the same ReLU side in every entry, whatever their summation orders. On
    normal inputs an entry of x W1 + b1 within fp32 rounding of 0 can fall on
    either side in the two orders (it did at M = 4097): that row's x dz then
    moves a whole column of dW1 and its db1 entry past the bars."""
    rng = np.random.default_rng(seed)
    x, w1, b1, w2, b2, ls, lb, do = _ffn_inputs(m, h, f, torch.bfloat16,
                                                 device, seed)

    def grid(top, step, dtype, *shape):  # multiples of 1/step up to top/step
        return torch.tensor(rng.integers(-top, top + 1, shape) / step,
                            dtype=dtype, device=device)

    return (grid(4, 4, torch.bfloat16, m, h),
            grid(8, 256, torch.bfloat16, h, f), grid(8, 256, torch.float32, f),
            w2, b2, ls, lb, do)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m", [1001, 4097])
def test_bf16_ffn_bwd_weight_gradients_on_the_gmm_body(cuda, m, rate):
    """bf16 B6b at WeatherBERT-large's widths (H = 576, F = 2304), M not a
    multiple of 64 nor of the weight gradients' row slices (the grouped
    matmul's body over slices of 64-row multiples, the bias row from a
    column of ones), on `_ffn_grid_inputs`: all seven outputs at the bf16
    bars and 2^-6 of max|plain|, and a second call gives equal bits (fixed
    slices, an ordered sum, no atomics)."""
    args = _ffn_grid_inputs(m, 576, 2304, cuda, seed=m)
    seeds = (5, 6)
    got = fused_ffn_ln_bwd(*args, rate, seeds)
    again = fused_ffn_ln_bwd(*args, rate, seeds)
    want = fused_ffn_ln_bwd_reference(*args, rate, seeds)
    for name, a, b, w in zip(("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"),
                             got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert torch.equal(a, b), name
        _assert_scaled_close("B6b " + name, a, w, torch.bfloat16)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_ffn_bwd_on_normal_inputs_with_the_kernels_relu_side(cuda, rate):
    """bf16 B6b at WeatherBERT-large's widths (H = 576, F = 2304) and M = 4097
    on normal inputs (`_ffn_inputs`), the plain version fed the kernel's own
    ReLU side (its hidden hd's nonzeros), so a pre-activation within fp32
    rounding of 0 cannot move the comparison: all seven outputs at the bf16
    bars and 2^-6 of max|plain|. The kernel's side must be the plain
    pre-activation's wherever the dropout keeps, but for ties: at most 1e-4
    of the entries, each within 2^-10 of max|x W1 + b1| of 0."""
    from weathermodel_tpu_torch.ops.dropout import ffn_keep_mask

    m, h, f = 4097, 576, 2304
    args = _ffn_inputs(m, h, f, torch.bfloat16, cuda, seed=m)
    seeds = (5, 6)
    hidden = torch.empty(m, f, dtype=torch.bfloat16, device=cuda)
    got = fused_ffn_ln_bwd(*args, rate, seeds, hidden=hidden)
    side = hidden != 0
    x, w1, b1 = args[:3]
    pre = x.float() @ w1.float() + b1
    differ = side != ((pre > 0) & ffn_keep_mask(seeds[0], m, f, rate, cuda))
    assert differ.float().mean().item() <= 1e-4
    if differ.any():
        assert pre[differ].abs().max() <= 2 ** -10 * pre.abs().max()
    want = fused_ffn_ln_bwd_reference(*args, rate, seeds, relu_keep=side)
    for name, a, w in zip(("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"),
                          got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        _assert_scaled_close("B6b " + name, a, w, torch.bfloat16)


_TILES_PROFILE = """
import json, torch
from weathermodel_tpu_torch.ops.fused_ffn_ln import fused_ffn_ln_bwd
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    fused_qkv_attention_outproj)
g = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape, dtype=torch.bfloat16):
    return (torch.randn(*shape, device="cuda", generator=g) * 0.05).to(dtype)
ffn = (rnd(1001, 576), rnd(576, 2304), rnd(2304, dtype=torch.float32),
       rnd(2304, 576), rnd(576, dtype=torch.float32),
       1 + rnd(576, dtype=torch.float32), rnd(576, dtype=torch.float32),
       rnd(1001, 576))
attn = (rnd(3, 37, 576), rnd(1728, 576), rnd(1728), rnd(576, 576), rnd(576))
for call in (lambda: fused_ffn_ln_bwd(*ffn, 0.1, (1, 2)),
             lambda: fused_qkv_attention_outproj(*attn, 16)):
    call()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    print(json.dumps(sorted({e.key for e in prof.key_averages()
                             if e.device_type == cuda})))
"""


def test_bf16_ffn_bwd_and_outproj_never_launch_the_wmma_tiles(cuda):
    """bf16 B6b's weight gradients and B5's out-projection run the grouped
    matmul's body (expert_wgrad_wgmma_kernel<true>,
    expert_gemm_wgmma_kernel<true, true>), never the WMMA tiles' bf16
    wgrad_kernel or outproj_kernel: the kernels of a profiled call of each,
    in a fresh process (a profile taken after many others in one process
    can come back empty)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", _TILES_PROFILE], check=True,
                         stdout=subprocess.PIPE, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parents[1]).stdout
    b6b, b5 = (json.loads(line) for line in out.splitlines()[-2:])
    for name, keys, body, tiles in (
            ("B6b", b6b, "expert_wgrad_wgmma_kernel<true>",
             "wgrad_kernel<__nv_bfloat16"),
            ("B5", b5, "expert_gemm_wgmma_kernel<true, true>",
             "outproj_kernel<__nv_bfloat16")):
        assert any(body in k for k in keys), (name, keys)
        assert not any(tiles in k for k in keys), (name, keys)


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
                                      (2, 365, 200, 10), (3, 37, 48, 4),
                                      (2, 1, 576, 16), (2, 64, 200, 10),
                                      (2, 65, 48, 4), (2, 384, 336, 12),
                                      (1, 453, 576, 16)])
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


def _outproj_weights(h, dtype, device):
    rng = np.random.default_rng(1)
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in (
        rng.uniform(-1, 1, (h, h)) / h ** 0.5,
        rng.uniform(-1, 1, h) / h ** 0.5))


@pytest.mark.parametrize("b,t,rate", [(3, 37, 0.0), (3, 37, 0.1),
                                      (256, 365, 0.0)])
def test_bf16_outproj_on_the_gmm_body(cuda, b, t, rate):
    """bf16 B5 at WeatherBERT-large's width: its out-projection on the
    grouped matmul's body (B4's transposed-weight form as one group, bo
    added in fp32 before the rounding), at a ragged M = 111 and at the
    serving batch (M = 93440 = 730 x 128): y at 2^-6 of max|plain|, and a
    second call gives equal bits."""
    x, w, bias = _inputs(b, t, 576, torch.bfloat16, cuda)
    wo, bo = _outproj_weights(576, torch.bfloat16, cuda)
    got = fused_qkv_attention_outproj(x, w, bias, wo, bo, 16, rate, 99)
    again = fused_qkv_attention_outproj(x, w, bias, wo, bo, 16, rate, 99)
    want = fused_qkv_attention_outproj_reference(x, w, bias, wo, bo, 16, rate,
                                                 99)
    assert torch.equal(got, again)
    _assert_scaled_close("B5 y", got, want, torch.bfloat16)


def test_bf16_outproj_off_the_body_rule_keeps_the_tiles(cuda):
    """A bf16 wo or bo 2 bytes off a 16-byte boundary is off the grouped
    matmul body's layout rule: phase 2 takes the WMMA tiles by the explicit
    dispatch, and y still matches the plain version."""
    x, w, bias = _inputs(2, 37, 200, torch.bfloat16, cuda)
    wo, bo = _outproj_weights(200, torch.bfloat16, cuda)

    def shifted(a):
        out = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)[1:]
        return out.view_as(a).copy_(a)

    want = fused_qkv_attention_outproj_reference(x, w, bias, wo, bo, 10)
    for args in ((shifted(wo), bo), (wo, shifted(bo))):
        assert any(a.data_ptr() % 16 for a in args)
        _assert_scaled_close("B5 y", fused_qkv_attention_outproj(
            x, w, bias, *args, 10), want, torch.bfloat16)


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
    with pytest.raises(ValueError, match="T up to 1536, got T=2000"):
        # more keys than the attention kernels take: bound-checked before any
        # launch, no padding and no fallback
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
# so kernel and plain version agree bitwise. The bool body's edges: m off its
# 64-row tiles (1001, 65), c >= 2^16 (columns whose hoisted term has high
# bits), the bench microbatch's FFN hidden site; the packed body's: c >= 2^16,
# and 129 word rows, off its chunks of 4 (c = 384: 32 runs of 4 columns
# across) and of 2 (c = 2304: 64 across)
MASK_SHAPES = [(2048, 2304), (96, 128), (33, 384), (0, 256), (1001, 2304),
               (65, 128), (3, 65664), (105120, 2304), (32, 65664),
               (4128, 384), (4128, 2304)]
# rates and seeds at their ends: rate 0 keeps all, 0.999 nearly none
MASK_EDGE_RATES, MASK_EDGE_SEEDS = (0.0, 0.999), (0, 2 ** 32 - 1)


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
                                   (1000, 513), (0, 4), (65, 512), (3, 65664),
                                   (288, 365, 2304)])
def test_random_keep_mask_matches_plain(cuda, shape):
    from weathermodel_tpu_torch.ops.kernel_dropout import (
        random_keep_mask,
        random_keep_mask_reference,
    )

    got = random_keep_mask(shape, 0.25, 5, cuda)
    assert got.shape == shape
    assert torch.equal(got, random_keep_mask_reference(shape, 0.25, 5, cuda))


@pytest.mark.parametrize("seed", MASK_EDGE_SEEDS)
@pytest.mark.parametrize("rate", MASK_EDGE_RATES)
def test_keep_mask_kernels_at_rate_and_seed_edges(cuda, rate, seed):
    """B9b, B9p and B8m at the rates' and seeds' ends, on shapes off the bool
    and packed bodies' tiles and past 2^16 columns: bitwise equal to their
    plain versions, and two calls give equal bits."""
    from weathermodel_tpu_torch.ops import maskgen
    from weathermodel_tpu_torch.ops.kernel_dropout import (
        random_keep_mask,
        random_keep_mask_reference,
    )

    for m, c in ((1001, 2304), (3, 65664), (96, 384), (32, 65664),
                 (4128, 384)):
        keep = maskgen.bool_keep_mask(m, c, rate, seed, cuda)
        assert torch.equal(keep, maskgen.bool_keep_mask(m, c, rate, seed,
                                                        cuda))
        assert torch.equal(keep, maskgen.bool_keep_mask_reference(
            m, c, rate, seed, cuda))
        if m % maskgen.GROUP == 0:
            packed = maskgen.packed_keep_mask(m, c, rate, seed, cuda)
            assert torch.equal(packed, maskgen.packed_keep_mask(
                m, c, rate, seed, cuda))
            assert torch.equal(packed, maskgen.packed_keep_mask_reference(
                m, c, rate, seed, cuda))
            assert torch.equal(maskgen.unpack_keep(packed, m), keep)
    for shape in ((1000, 513), (3, 65664), (65, 512)):
        keep = random_keep_mask(shape, rate, seed, cuda)
        assert torch.equal(keep, random_keep_mask(shape, rate, seed, cuda))
        assert torch.equal(keep, random_keep_mask_reference(shape, rate, seed,
                                                            cuda))


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


# the probes P1, P2 (bf16) and P3: kernel against plain version on the
# computed region, at SCALE 2^-6 of the plain output's largest magnitude
# (the fp32 sums run in another order, so an entry's rounding, or one S's in
# P1/P2, can flip: one bf16 ulp at the output's scale), and at most 1% of
# the entries differing at all (a missing rounding of S changes ~40%)
PROBE_SCALE_TOL = 2.0 ** -6
PROBE_DIFFER_SHARE = 1e-2
# (B, T, NH): the script's shape; T not a multiple of the 64-row tile nor of
# the 384-row work item; 7 heads, one whole group of 3 and a head left over in P2
HEADPACK_SHAPES = [(224, 384, 16), (3, 100, 16), (2, 37, 7)]


def _assert_probe_close(name, got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= PROBE_SCALE_TOL * want.abs().max().item(), (name, err)
    share = (got != want).float().mean().item()
    assert share <= PROBE_DIFFER_SHARE, (name, share)


def _refill_freed(shape, dtype, device):
    """Free a NaN-filled block of this size, so that the caching allocator
    hands it to the next allocation of the size: what a kernel leaves
    unwritten then reads NaN."""
    torch.full(shape, float("nan"), dtype=dtype, device=device)


def _headpack_inputs(b, t, nh, device, offset=0):
    """q, k, v bf16 [b, t, nh * 36] from numpy normals, each `offset`
    elements into its own buffer."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        a = torch.tensor(rng.normal(size=(b, t, nh * 36)),
                         dtype=torch.bfloat16, device=device)
        buf = torch.empty(a.numel() + offset, dtype=a.dtype, device=device)
        out.append(buf[offset:].view(a.shape))
        out[-1].copy_(a)
    return out


def _check_headpack(name, b, t, nh, device, offset=0):
    """One launch of the probe against its plain version on the columns it
    computes; the others (P2's last heads) never written."""
    from weathermodel_tpu_torch.ops import headpack

    fn = getattr(headpack, name)
    ref = getattr(headpack, name + "_reference")
    q, k, v = _headpack_inputs(b, t, nh, device, offset)
    before = fn.launches
    _refill_freed(q.shape, q.dtype, device)
    got = fn(q, k, v, num_heads=nh)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    live = nh * 36 if name == "headpack_v0" else nh // 3 * 3 * 36
    _assert_probe_close(name, got[..., :live],
                        ref(q, k, v, num_heads=nh)[..., :live])
    assert got[..., live:].isnan().all()  # P2's last head: never written


@pytest.mark.parametrize("b,t,nh", HEADPACK_SHAPES)
@pytest.mark.parametrize("name", ["headpack_v0", "headpack_v1"])
def test_headpack_kernels_match_plain(cuda, name, b, t, nh):
    _check_headpack(name, b, t, nh, cuda)


# the wgmma body's edges (csrc/headpack_hopper.cuh): T = 1 (63 rows of the
# tile past T), 64 (one whole key slab), 65 (a slab and one row), 1024 (16
# slabs a head); 16 heads (P2: 5 groups, head 15 unwritten) and 7 (P2: 2
# groups and a head left over; H = 252 is not a multiple of 8, so no TMA map
# fits the rows and the body loads by cp.async)
HEADPACK_EDGE_SHAPES = [(2, t, nh) for t in (1, 64, 65, 1024) for nh in (16, 7)]


@pytest.mark.parametrize("b,t,nh", HEADPACK_EDGE_SHAPES)
@pytest.mark.parametrize("name", ["headpack_v0", "headpack_v1"])
def test_headpack_kernels_at_the_body_edges(cuda, name, b, t, nh):
    _check_headpack(name, b, t, nh, cuda)


@pytest.mark.parametrize("name", ["headpack_v0", "headpack_v1"])
def test_headpack_kernels_take_8_byte_aligned_operands(cuda, name):
    """q, k, v 4 elements into their buffers: 8-byte aligned, not 16, so the
    body loads them by cp.async at the probe's width."""
    _check_headpack(name, 3, 100, 16, cuda, offset=4)


@pytest.mark.parametrize("name", ["headpack_v0", "headpack_v1"])
def test_headpack_kernels_give_equal_bits(cuda, name):
    """Two calls at the probe's shape give equal bits on the columns they
    write: a fixed summation order, no atomics."""
    from weathermodel_tpu_torch.ops import headpack

    fn = getattr(headpack, name)
    q, k, v = _headpack_inputs(224, 384, 16, cuda)
    live = 576 if name == "headpack_v0" else 540
    first = fn(q, k, v)[..., :live].clone()
    again = fn(q, k, v)[..., :live]
    assert torch.equal(first, again)


_HEADPACK_PROFILE = """
import json, torch
from weathermodel_tpu_torch.ops.headpack import headpack_v0, headpack_v1
from weathermodel_tpu_torch.scripts import abl_headpack
q, k, v = abl_headpack.inputs(abl_headpack.B, "cuda")
for fn in (headpack_v0, headpack_v1):
    fn(q, k, v)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(q, k, v)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    print(json.dumps(sorted({e.key for e in prof.key_averages()
                             if e.device_type == cuda})))
"""


def test_headpack_kernels_launch_the_wgmma_body(cuda):
    """P1 and P2 at the probe's shape run headpack_wgmma_kernel and no WMMA
    headpack_kernel: the kernels of a profiled call of each, in a fresh
    process (a profile taken after many others in one process can come back
    empty)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", _HEADPACK_PROFILE],
                         check=True, stdout=subprocess.PIPE, text=True,
                         timeout=600,
                         cwd=Path(__file__).resolve().parents[1]).stdout
    for name, keys in zip(("P1", "P2"),
                          (json.loads(line)
                           for line in out.splitlines()[-2:])):
        assert any("headpack_wgmma_kernel" in k for k in keys), (name, keys)
        assert not any("headpack_kernel" in k for k in keys), (name, keys)


def test_headpack_kernels_reject_what_they_do_not_take(cuda):
    from weathermodel_tpu_torch.ops import headpack

    q = torch.randn(2, 64, 576, device=cuda, dtype=torch.bfloat16)
    for fn in (headpack.headpack_v0, headpack.headpack_v1):
        before = fn.launches
        with pytest.raises(ValueError, match="bfloat16"):
            fn(q.float(), q.float(), q.float())
        with pytest.raises(ValueError, match="contiguous"):
            fn(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1))
        with pytest.raises(ValueError, match="head dim"):
            fn(q, q, q, num_heads=12)
        with pytest.raises(ValueError, match="devices"):
            fn(q, q.cpu(), q)
        assert fn.launches == before


# (m, k, n, bm, bn, dtype): the script's first and last arms (bf16: the
# grouped matmul's wgmma body as one group); a covered region that ends
# inside the body's 128 x 192 tile, short of m and n (mc = 900 < 1000, nc =
# 384 < 504); covered regions that end inside a 128-tile, k not a multiple of
# the 32-deep slab, and k, n whose rows are not whole 16-byte chunks (bf16
# off the body's rule: the WMMA tiles, and their scalar staging path)
BLOCKED_MM_CASES = [(70144, 576, 2304, 512, 1152, torch.bfloat16),
                    (70144, 576, 2304, 1024, 2304, torch.bfloat16),
                    (1000, 200, 504, 300, 128, torch.bfloat16),
                    (1000, 200, 500, 300, 128, torch.bfloat16),
                    (1000, 200, 500, 300, 128, torch.float32),
                    (130, 37, 70, 65, 35, torch.bfloat16),
                    (130, 37, 70, 65, 35, torch.float32)]


@pytest.mark.parametrize("m,k,n,bm,bn,dtype", BLOCKED_MM_CASES)
def test_blocked_mm_kernel_matches_plain(cuda, m, k, n, bm, bn, dtype):
    from weathermodel_tpu_torch.ops.blocked_mm import (
        blocked_mm,
        blocked_mm_reference,
        covered,
    )

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(m, k)) * 0.1, dtype=dtype, device=cuda)
    w = torch.tensor(rng.normal(size=(k, n)) * 0.05, dtype=dtype,
                     device=cuda)
    rows, cols = covered(m, n, bm, bn)
    before = blocked_mm.launches
    _refill_freed((m, n), dtype, cuda)
    got = blocked_mm(x, w, bm, bn)
    torch.cuda.synchronize()
    assert blocked_mm.launches == before + 1
    want = blocked_mm_reference(x, w, bm, bn)
    if dtype == torch.float32:  # fp32 sums in another order only
        torch.testing.assert_close(got[:rows, :cols], want[:rows, :cols],
                                   atol=1e-5, rtol=1e-4)
    else:
        _assert_probe_close("blocked_mm", got[:rows, :cols],
                            want[:rows, :cols])
    assert got[rows:].isnan().all() and got[:, cols:].isnan().all()


def test_blocked_mm_rejects_what_it_does_not_take(cuda):
    from weathermodel_tpu_torch.ops.blocked_mm import blocked_mm

    x = torch.randn(256, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(64, 128, device=cuda, dtype=torch.bfloat16)
    before = blocked_mm.launches
    with pytest.raises(ValueError, match="contiguous"):
        blocked_mm(x.T.contiguous().T, w, 128, 128)
    with pytest.raises(ValueError, match="dtype"):
        blocked_mm(x.half(), w.half(), 128, 128)
    assert blocked_mm.launches == before
    blocked_mm(x[:100], w, 128, 128)  # no whole bm block: nothing to launch
    assert blocked_mm.launches == before
