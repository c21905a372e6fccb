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
