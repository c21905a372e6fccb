"""The port's dropout layer against the JAX package's: the kept values'
scaling of the plain dropout (JAX `bits8_dropout`), and the maskgen impls
(ops/maskgen.py, kernels B9p and B9b as their plain versions on the CPU)
against weathermodel_tpu/ops/pallas_maskgen.py. The JAX mask kernels draw
from the TPU's PRNG, which the Pallas interpreter lacks, so the JAX side
runs with the port's mask injected in place of its kernel's
(`packed_keep_mask` / `bool_keep_mask` monkeypatched); everything else
(unpacking, applying, the VJP, the shape rule) is the JAX package's own.
All comparisons are bitwise, in fp32 and bf16, on numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import weathermodel_tpu.ops.dropout as jax_dropout
import weathermodel_tpu.ops.pallas_maskgen as jax_maskgen
from weathermodel_tpu_torch.ops import dropout, maskgen
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
RATE = 0.1


def _pair(a, dtype):
    """The same numpy values as a torch and a JAX array of `dtype`."""
    tdt, jdt = DTYPES[dtype]
    return torch.tensor(a, dtype=tdt), jnp.asarray(a, jdt)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture
def impl():
    """Set a dropout impl for one test; restores the one before."""
    old = dropout.get_impl()
    yield dropout.set_impl
    dropout.set_impl(old)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_scales_kept_values_as_jax_bits8(dtype):
    """Fault C2: where both keep an element, the port's plain dropout and
    JAX `bits8_dropout` give the same value bitwise (x times 1/(1 - p)
    rounded to x's dtype, the product rounded once)."""
    x = np.random.default_rng(0).normal(size=(16, 64, 128))
    tx, jx = _pair(x, dtype)
    assert dropout.get_impl() == "auto"
    got = _np(dropout.dropout(tx, RATE, 1234))
    want = _np(jax_dropout.bits8_dropout(jx, jax.random.PRNGKey(0), RATE))
    both = (got != 0) & (want != 0)
    assert both.mean() > 0.75
    np.testing.assert_array_equal(got[both], want[both])


def test_unpack_keep_matches_jax():
    words = np.zeros((2, 128), np.int32)
    words[0, 0] = 0b101
    words[1, 5] = -1
    words[0, 7] = np.int32(-2 ** 31)  # bit 31 alone
    words[1, 9] = 2 ** 31 - 1         # every bit but 31
    rand = np.random.default_rng(1).integers(-2 ** 31, 2 ** 31, (3, 256),
                                             dtype=np.int64).astype(np.int32)
    for w in (words, rand):
        m = w.shape[0] * maskgen.GROUP
        got = maskgen.unpack_keep(torch.from_numpy(w), m)
        want = np.asarray(jax_maskgen.unpack_keep(jnp.asarray(w), m))
        assert got.dtype == torch.bool and got.shape == (m, w.shape[1])
        np.testing.assert_array_equal(got.numpy(), want)
    keep = maskgen.unpack_keep(torch.from_numpy(words), 64)
    assert keep[[0, 2], 0].all() and not keep[1, 0]
    assert keep[32:, 5].all() and keep[31, 7] and not keep[:31, 7].any()
    assert keep[32:63, 9].all() and not keep[63, 9]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_jax_apply_packed_and_bool(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 256))
    tx, jx = _pair(x, dtype)
    words = maskgen.packed_keep_mask(64, 256, RATE, 99, "cpu")
    keep = maskgen.unpack_keep(words, 64)
    got = _np(dropout.apply_keep(tx, keep, RATE))
    np.testing.assert_array_equal(got, _np(jax_maskgen._apply_packed(
        jx, jnp.asarray(words.numpy()), RATE)))
    np.testing.assert_array_equal(got, _np(jax_maskgen._apply_bool(
        jx, jnp.asarray(keep.numpy()), RATE)))


def _inject(monkeypatch, name, mask):
    """Make the JAX mask kernel `name` return the port's `mask`."""
    def stub(m, c, rate, seed):
        return jnp.asarray(mask.numpy())
    monkeypatch.setattr(jax_maskgen, name, stub)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["packed", "bool"])
def test_maskgen_dropout_forward_and_vjp_match_jax(monkeypatch, kind, dtype):
    """packed_dropout / bool_dropout of x [2, 32, 256] and their gradients
    against JAX's with the port's mask injected: bitwise."""
    rng = np.random.default_rng(3)
    x, dy = rng.normal(size=(2, 2, 32, 256))
    seed = 4321
    if kind == "packed":
        mask = maskgen.packed_keep_mask(64, 256, RATE, seed, "cpu")
        port_fn, jax_fn = maskgen.packed_dropout, jax_maskgen.packed_dropout
    else:
        mask = maskgen.bool_keep_mask(64, 256, RATE, seed, "cpu")
        port_fn, jax_fn = maskgen.bool_dropout, jax_maskgen.bool_dropout
    _inject(monkeypatch, f"{kind}_keep_mask", mask)
    tx, jx = _pair(x, dtype)
    tdy, jdy = _pair(dy, dtype)
    leaf = tx.requires_grad_()
    got = port_fn(leaf, RATE, seed)
    got.backward(tdy)
    want, vjp = jax.vjp(lambda a: jax_fn(a, jax.random.PRNGKey(0), RATE), jx)
    (want_dx,) = vjp(jdy)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(leaf.grad), _np(want_dx))
    assert (_np(got) == 0).mean() > 0.05


# large's three dense sites at the bench microbatch, the MoE hidden of 3 x
# 96 windows, and two odd shapes
DECISION_SHAPES = [(288, 365, 576), (288, 365, 2304), (70080, 2304),
                   (3, 5, 256), (32, 100)]


@pytest.mark.parametrize("kind", ["packed", "bool"])
def test_kernel_or_fallback_decision_matches_jax(monkeypatch, kind):
    """Which shapes take the mask kernel and which the plain impl, observed
    through recording stubs (JAX under jax.eval_shape, the port on the meta
    device): nothing of the shapes' size is allocated."""
    seen = []

    def record(tag):
        def stub(x, *args):
            seen.append(tag)
            return x
        return stub

    monkeypatch.setattr(jax_maskgen, f"_{kind}_dropout2d", record("kernel"))
    monkeypatch.setattr(jax_dropout, "bits8_dropout", record("fallback"))
    jax_fn = getattr(jax_maskgen, f"{kind}_dropout")
    want = []
    for shape in DECISION_SHAPES:
        jax.eval_shape(lambda a: jax_fn(a, jax.random.PRNGKey(0), RATE),
                       jax.ShapeDtypeStruct(shape, jnp.bfloat16))
        want.append(seen.pop())

    class Recorder:
        apply = staticmethod(record("kernel"))

    monkeypatch.setattr(maskgen, "PackedDropout" if kind == "packed"
                        else "BoolDropout", Recorder)
    monkeypatch.setattr(maskgen, "rand_dropout", record("fallback"))
    got = []
    for shape in DECISION_SHAPES:
        x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
        assert getattr(maskgen, f"{kind}_dropout")(x, RATE, 1).shape == shape
        got.append(seen.pop())
    assert got == want
    odd = "fallback" if kind == "packed" else "kernel"
    assert got == ["fallback", "kernel", "kernel", odd, "fallback"]


@pytest.mark.parametrize("kind", ["packed", "bool"])
def test_keep_masks_hold_the_jax_kernels_properties(kind):
    """The JAX TPU tests' assertions on the plain versions: keep rate within
    5e-3 of 1 - p, one mask per seed, another for another seed; the packed
    mask unpacks to the bool one exactly."""
    m, c = 4096, 256
    fn = getattr(maskgen, f"{kind}_keep_mask")
    a, b, other = (fn(m, c, RATE, s, "cpu") for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, other)
    keep = maskgen.unpack_keep(a, m) if kind == "packed" else a
    assert torch.equal(keep, maskgen.bool_keep_mask(m, c, RATE, 3, "cpu"))
    assert abs(keep.float().mean().item() - (1 - RATE)) < 5e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["packed", "bool"])
def test_maskgen_dropout_survivors_and_backward_mask(kind, dtype):
    """Survivors of ones are exactly 1/(1 - p) in the dtype; the backward
    applies the forward's mask (y == g * x, as scripts/abl_maskgen.py
    checks on the TPU)."""
    fn = getattr(maskgen, f"{kind}_dropout")
    tdt = DTYPES[dtype][0]
    y = fn(torch.ones(128, 256, dtype=tdt), 0.25, 7)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.75))
    x = torch.tensor(np.random.default_rng(5).normal(size=(4, 32, 128)),
                     dtype=tdt, requires_grad=True)
    y = fn(x, RATE, 8)
    (g,) = torch.autograd.grad(y.float().sum(), x)
    assert torch.equal(y, g * x)


def test_packed_dropout_saves_only_the_packed_words():
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    x = torch.randn(2, 32, 256, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = maskgen.packed_dropout(x, RATE, 9)
    assert saved == [((64 // 32, 256), torch.int32)]
    y.sum().backward()
    saved.clear()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        maskgen.bool_dropout(x, RATE, 9)
    assert saved == [((64, 256), torch.bool)]


def test_set_impl_arms(impl):
    for name in dropout.JAX_ONLY_IMPLS:
        assert name in jax_dropout._IMPLS
        with pytest.raises(NotImplementedError, match="item 15"):
            impl(name)
    with pytest.raises(ValueError, match="Unknown dropout impl"):
        impl("maskgen_packed")
    assert dropout.get_impl() == "auto"
    assert set(dropout.DROPOUT_IMPLS) | set(dropout.JAX_ONLY_IMPLS) == \
        set(jax_dropout._IMPLS)
    for name in dropout.DROPOUT_IMPLS:
        impl(name)
        assert dropout.get_impl() == name


# csrc/keep_mask.cu's bool body (B9b, B8m): mix32's multipliers
M32 = 2 ** 32 - 1
HASH_MULS = (0x7FEB352D, 0x846CA68B)


def _np_mix32(x):
    """mix32 on numpy uint64 holding uint32 values."""
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(HASH_MULS[0])) & np.uint64(M32)
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(HASH_MULS[1])) & np.uint64(M32)
    return x ^ (x >> np.uint64(16))


def _bool_body_keep(keys, cols, threshold, at_least):
    """The bool body's arithmetic, step by step, in uint64, for row keys [r]
    and columns [c] (whole 16-column runs starting at multiples of 16): the
    hoisted shift-xor, the rest of mix32, the carries of bits + (2^32 -
    threshold) packed four to a word by Horner steps that take the carry in,
    and B8m's complement; asserts each identity it relies on and returns the
    mask the words' bytes hold."""
    u64 = np.uint64
    keys, cols = keys[:, None], cols[None, :]
    k1 = keys ^ (keys >> u64(16))                  # per row, in shared memory
    c0 = cols & ~u64(15)                           # the thread's 16-column run
    cterm = c0 ^ (c0 >> u64(16))                   # per thread, once
    y = (k1 ^ cterm) ^ (cols & u64(15))            # per row, then an immediate
    x = keys ^ cols
    np.testing.assert_array_equal(y, x ^ (x >> u64(16)))  # the hoist
    u = (y * u64(HASH_MULS[0])) & u64(M32)
    u = u ^ (u >> u64(15))
    u = (u * u64(HASH_MULS[1])) & u64(M32)
    bits = u ^ (u >> u64(16))
    np.testing.assert_array_equal(bits, _np_mix32(x))
    addend = 2 ** 32 - threshold                   # (hi, lo): hi is 1 only at 0
    lo, hi = u64(addend & M32), u64(addend >> 32)
    step = hi + ((bits + lo) >> u64(32))           # the IADD3's carry, plus hi
    assert step.max() <= 1
    np.testing.assert_array_equal(step == 1, bits >= threshold)
    quads = step.reshape(step.shape[0], -1, 4)     # bytes 0-3 of each word
    word = np.zeros(quads.shape[:2], np.uint64)
    for i in (3, 2, 1, 0):                         # IMAD.X: acc * 256 + carry
        word = ((word * u64(256)) & u64(M32)) + quads[..., i]
    if not at_least:                               # bits < threshold
        word = word ^ u64(0x01010101)
    got = (word[..., None] >> (u64(8) * np.arange(4, dtype=np.uint64))) & u64(255)
    assert got.max() <= 1
    return got.reshape(step.shape) == 1


def _np_row_keys(seed, rows):
    """dropout_head_key(seed, row) for rows 0 .. rows - 1."""
    row = (np.arange(rows, dtype=np.uint64) + np.uint64(0x9E3779B9)) \
        & np.uint64(M32)
    return _np_mix32(np.uint64(seed) ^ _np_mix32(row))


@pytest.mark.parametrize("at_least", [True, False])
def test_bool_body_identities_match_hash_keep_mask(at_least):
    """The bool body's hoisted shift-xor, its compares as carries and their
    packing give `hash_keep_mask`'s mask exactly: at seeds 0, 2^32 - 1 and one
    between, columns past 2^16 and thresholds at and near both ends; and on
    random keys across the uint32 range with runs of columns up to 2^20
    against bits >= threshold (or <) of mix32(key ^ col)."""
    thresholds = [1, 2 ** 31, 2 ** 32 - 1, maskgen.maskgen_threshold(0.1),
                  maskgen.maskgen_threshold(0.999),
                  dropout.dropout_params(0.1)[1]]
    if at_least:
        thresholds.append(maskgen.maskgen_threshold(0.0))
    rows, cols = 5, 65664 + 256
    col = np.arange(cols, dtype=np.uint64)
    for seed in (0, 2 ** 32 - 1, 20260202):
        keys = _np_row_keys(seed, rows)
        for thr in thresholds:
            want = dropout.hash_keep_mask(seed, rows, cols, thr, at_least,
                                          "cpu").numpy()
            np.testing.assert_array_equal(
                _bool_body_keep(keys, col, thr, at_least), want)
    rng = np.random.default_rng(17)
    keys = rng.integers(0, 2 ** 32, 2048, dtype=np.uint64)
    keys[:2] = (0, M32)
    runs = rng.integers(0, 2 ** 16, 32, dtype=np.uint64) * np.uint64(16)
    cols = (runs[:, None] + np.arange(16, dtype=np.uint64)).reshape(-1)
    bits = _np_mix32(keys[:, None] ^ cols[None, :])
    for thr in thresholds:
        keep = bits >= thr if at_least else bits < thr
        np.testing.assert_array_equal(
            _bool_body_keep(keys, cols, thr, at_least), keep)


def _packed_body_state(keys, cols):
    """The packed body's hash (B9p), step by step, in uint64, for the row
    keys of whole words [32 w] and `cols` columns (a multiple of 4): per row
    K1 and per thread (four columns c0 .. c0 + 3) the column term, the four
    hash inputs h + j after the hoist (word j's carries are column
    c0 + (j ^ b)'s), and the rest of mix32 to its state u before the last
    shift-xor; asserts the hoist and returns (K1, the column terms, u)."""
    u64 = np.uint64
    k1 = keys ^ (keys >> u64(16))                  # per row, in shared memory
    c0 = np.arange(0, cols, 4, dtype=np.uint64)    # a thread's first column
    cterm = c0 ^ (c0 >> u64(16))                   # per thread, once
    base = k1[:, None] ^ cterm[None, :]            # [rows, threads]
    h, b = base & u64(M32 - 3), base & u64(3)      # one LOP3 a row; the swap
    j = np.arange(4, dtype=np.uint64)
    y = h[..., None] + j                           # word j's hash input
    x = keys[:, None, None] ^ (c0[None, :, None] + (j ^ b[..., None]))
    np.testing.assert_array_equal(y, x ^ (x >> u64(16)))  # the hoist
    u = (h[..., None] * u64(HASH_MULS[0]) + j * u64(HASH_MULS[0])) & u64(M32)
    np.testing.assert_array_equal(u, (y * u64(HASH_MULS[0])) & u64(M32))
    u = u ^ (u >> u64(15))
    u = (u * u64(HASH_MULS[1])) & u64(M32)
    np.testing.assert_array_equal(u ^ (u >> u64(16)), _np_mix32(x))
    return k1, cterm, u


def _packed_body_words(state, threshold):
    """The packed body's compare and packing on `_packed_body_state`'s
    (K1, column terms, u): the compare on u ^ (threshold >> 16) as the carry
    of an add, the carries packed by Horner steps x 2 from row 31 down into
    word j, and the masked swaps that move column c0 + e's bits from word
    e ^ b to word e; asserts each identity it relies on and returns the
    words [w, cols] wrapped to int32."""
    u64 = np.uint64
    k1, cterm, u = state
    bits = u ^ (u >> u64(16))
    kx = u64(threshold >> 16)
    v = u ^ kx
    np.testing.assert_array_equal(v >= threshold, bits >= threshold)
    tie = (kx << u64(16)) + np.arange(2 ** 16, dtype=np.uint64)
    np.testing.assert_array_equal((tie ^ kx) >= threshold,   # its tie window
                                  (tie ^ (tie >> u64(16))) >= threshold)
    addend = 2 ** 32 - threshold                   # (hi, lo): hi is 1 only at 0
    lo, hi = u64(addend & M32), u64(addend >> 32)
    step = hi + ((v + lo) >> u64(32))              # the IADD3's carry, plus hi
    assert step.max() <= 1
    np.testing.assert_array_equal(step == 1, bits >= threshold)
    step = step.reshape(-1, 32, *step.shape[1:])   # [words, row i, threads, j]
    acc = step[:, 31]                              # row 31: hi + carry
    for i in range(30, -1, -1):                    # IMAD.X: acc * 2 + carry
        acc = ((acc * u64(2)) & u64(M32)) + step[:, i]
    shifts = np.arange(32, dtype=np.uint64)[None, :]
    m0, m1 = ((((k1.reshape(-1, 32) >> u64(s)) & u64(1)) << shifts).sum(
        axis=1)[:, None]                           # a warp's ballot of K1
        ^ ((u64(0) - ((cterm >> u64(s)) & u64(1))) & u64(M32))[None, :]
        for s in (0, 1))
    for (a, c), mask in (((0, 1), m0), ((2, 3), m0), ((0, 2), m1),
                         ((1, 3), m1)):
        t = (acc[..., a] ^ acc[..., c]) & mask
        acc[..., a] ^= t
        acc[..., c] ^= t
    assert acc.max() <= M32
    return acc.reshape(acc.shape[0], -1).astype(np.uint32).view(np.int32)


def test_packed_body_matches_packed_keep_mask_reference():
    """The packed body's arithmetic (the hoist, the compare on u ^ (threshold
    >> 16), the carries, the Horner x 2 packing and the swaps that undo the
    columns' order) gives `packed_keep_mask_reference`'s words exactly: at
    seeds 0, 2^32 - 1 and one between, thresholds 0, 1, 2^31 and 2^32 - 1
    and the rates 0.1 and 0.999, on a word row of columns past 2^16."""
    rates = (0.0, 2.0 ** -32, 0.5, 1 - 2.0 ** -32, 0.1, 0.999)
    assert [maskgen.maskgen_threshold(r) for r in rates[:4]] == [
        0, 1, 2 ** 31, 2 ** 32 - 1]
    m, c = 32, 65664
    for seed in (0, 2 ** 32 - 1, 20260202):
        state = _packed_body_state(_np_row_keys(seed, m), c)
        for rate in rates:
            want = maskgen.packed_keep_mask_reference(m, c, rate, seed, "cpu")
            np.testing.assert_array_equal(
                _packed_body_words(state, maskgen.maskgen_threshold(rate)),
                want.numpy())
