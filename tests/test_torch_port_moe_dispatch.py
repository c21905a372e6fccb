"""The MoE capacity layouts of the port against the JAX package: the sort
routing bit for bit, the `sort` and `scatter` dispatches (forward, aux loss
and gradients, with capacity drops), `remat`, and the int8 serving legs of
the MoE FFN (calibrate through `ragged` and `sort`, int8_static through
`sort`), in fp32 on the CPU. The JAX grouped matmul runs its Pallas kernels
in interpret mode (tests/conftest.py); the port's runs its plain
versions."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models.moe import MoEFFN as JaxMoEFFN
from weathermodel_tpu.models.moe import _sort_routing
from weathermodel_tpu.models.moe import (
    expert_capacity as jax_expert_capacity,
)
from weathermodel_tpu_torch.models.blocks import TransformerEncoderLayer
from weathermodel_tpu_torch.models.moe import MoEFFN, sort_routing
from weathermodel_tpu_torch.models.transfer import (
    load_quant_scales,
    quant_scales_from_jax,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

E, K = 4, 2
B, T, H, F = 3, 16, 16, 64
# fp32, dropout off: the port against JAX at tests/test_torch_parity.py's
# bar (the router's logits and the expert matmuls sum in another order)
ATOL, RTOL = 2e-5, 1e-4
PARAMS = ("expert_w1", "expert_b1", "expert_w2", "expert_b2")


@pytest.mark.parametrize("e,k,t,capf", [
    (1, 1, 16, 1.0), (4, 4, 12, 2.0), (8, 2, 8, 0.25), (3, 2, 40, 1.5)])
def test_sort_routing_matches_jax_bit_for_bit(e, k, t, capf):
    """pos, keep, slot, tok, filled and n_e at tests/test_moe.py's edge
    shapes: one expert, k == e, a capacity that drops most tokens, a
    non-power-of-two expert count."""
    rng = np.random.default_rng(e * 100 + k)
    cap = jax_expert_capacity(t, e, k, capf)
    flat_idx = rng.integers(0, e, size=(3, t * k))
    want = _sort_routing(jnp.asarray(flat_idx, jnp.int32), e, cap)
    got = sort_routing(torch.from_numpy(flat_idx), e, cap)
    for name, a, w in zip(("pos", "keep", "slot", "tok", "filled", "n_e"),
                          got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                      err_msg=name)


def _x(seed=0, b=B, t=T):
    return np.random.default_rng(seed).normal(size=(b, t, H)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _init():
    """The JAX module's parameters for [B, T, H] inputs (they depend on
    neither the dispatch, the capacity nor the inputs' values)."""
    jmoe = JaxMoEFFN(H, F, E, top_k=K, dropout_rate=0.0, dispatch="sort")
    return jax.device_get(jax.jit(jmoe.init)(
        jax.random.PRNGKey(1), jnp.zeros((B, T, H)))["params"])


def _jax_params():
    """A fresh numpy copy of `_init`'s parameters."""
    return jax.tree.map(np.array, _init())


def _port(params, **kwargs):
    """The port's MoEFFN with the JAX module's parameters."""
    moe = MoEFFN(H, F, E, top_k=K, **kwargs)
    moe.load_state_dict({
        "router.weight": torch.tensor(np.asarray(params["router"]["kernel"]).T),
        "router.bias": torch.tensor(np.asarray(params["router"]["bias"])),
        **{name: torch.tensor(np.asarray(params[name])) for name in PARAMS}})
    return moe


def _loss_and_grads(moe, x, dy, rate=0.0, seed=None):
    xt = torch.from_numpy(x).requires_grad_()
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    out, aux = moe(xt, rate, gen)
    ((out * torch.from_numpy(dy)).sum() + aux).backward()
    grads = {name: p.grad.clone() for name, p in moe.named_parameters()}
    grads["x"] = xt.grad
    return out.detach(), aux.detach(), grads


@pytest.mark.parametrize("dispatch", ["sort", "scatter"])
def test_capacity_dispatch_matches_jax(dispatch):
    """capacity_factor 0.5 drops tokens (checked); the output, the aux loss
    and every gradient of out . dy + aux within the fp32 bar."""
    x = _x()
    dy = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    params = _jax_params()
    jmoe = JaxMoEFFN(H, F, E, top_k=K, capacity_factor=0.5, dropout_rate=0.0,
                     dispatch=dispatch)

    def jax_loss(p, xx):
        out, mvars = jmoe.apply({"params": p}, xx, deterministic=True,
                                mutable=["moe"])
        aux = mvars["moe"]["aux_loss"]
        return jnp.sum(out * dy) + aux, (out, aux)

    (_, (want, want_aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    port = _port(params, capacity_factor=0.5, dispatch=dispatch)
    idx = port.route(torch.from_numpy(x))[3].reshape(B, T * K)
    cap = jax_expert_capacity(T, E, K, 0.5)
    assert not sort_routing(idx, E, cap)[1].all()  # some tokens drop
    out, aux, grads = _loss_and_grads(port, x, dy)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(grads["x"].numpy(), np.asarray(gx),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(grads["router.weight"].numpy().T,
                               np.asarray(gp["router"]["kernel"]), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(grads["router.bias"].numpy(),
                               np.asarray(gp["router"]["bias"]), atol=ATOL,
                               rtol=RTOL)
    for name in PARAMS:
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(gp[name]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_port_sort_equals_scatter():
    """The two capacity layouts compute one function: with drops, the
    output, the aux loss and the gradients of the port's sort and scatter
    dispatches are equal."""
    x = _x(2)
    dy = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    params = _jax_params()
    got = {d: _loss_and_grads(_port(params, capacity_factor=0.5,
                                    dispatch=d), x, dy)
           for d in ("sort", "scatter")}
    (o1, a1, g1), (o2, a2, g2) = got["sort"], got["scatter"]
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6, rtol=1e-6)
    assert a1.item() == a2.item()
    for name in g1:
        np.testing.assert_allclose(g1[name].numpy(), g2[name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("impl", ["auto", "maskgen", "maskgen_bool"])
def test_window_dropout_keeps_the_one_process_entries(impl):
    """A rank's window of the experts under a 'model' split: its hidden
    dropout keeps, for each window, the entries that one process's dropout
    of the whole buffer keeps there, scaled the same, in both capacity
    layouts (sort's [E, M, F], expert dim 0; scatter's [B, E, cap, F],
    dim 1), for every impl; without a window it is that one dropout."""
    from weathermodel_tpu_torch.models.moe import window_dropout
    from weathermodel_tpu_torch.ops import dropout

    old = dropout.get_impl()
    dropout.set_impl(impl)
    try:
        rng = np.random.default_rng(4)
        for shape, dim in (((E, 6, F), 0), ((2, E, 3, F), 1)):
            h = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            whole = dropout.dropout(h, 0.1, 7)
            assert torch.equal(window_dropout(h, 0.1, 7, None, dim), whole)
            assert 0 < int((whole == 0).sum()) < h.numel() // 2
            for off in range(0, E, 2):
                got = window_dropout(h.narrow(dim, off, 2), 0.1, 7,
                                     (off, E), dim)
                assert torch.equal(got, whole.narrow(dim, off, 2)), off
            assert torch.equal(window_dropout(h, 0.0, 7, (0, E), dim), h)
    finally:
        dropout.set_impl(old)


@pytest.mark.parametrize("dispatch", ["sort", "scatter", "ragged"])
def test_remat_gradients_are_bitwise(dispatch):
    """Dropout 0.1 from one generator seed: the recomputed expert region
    draws the same mask (its seed is drawn outside it), so the remat'd
    step's output and gradients equal the saved-activation step's bit for
    bit."""
    x = _x(4)
    dy = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    params = _jax_params()
    runs = [_loss_and_grads(_port(params, capacity_factor=0.5,
                                  dispatch=dispatch, remat=remat), x, dy,
                            rate=0.1, seed=7)
            for remat in (False, True)]
    (o1, a1, g1), (o2, a2, g2) = runs
    assert torch.equal(o1, o2) and torch.equal(a1, a2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


def _calib_x():
    """Activations whose router (bias -100 on expert 3, set below) sends no
    token to expert 3: the expert that saw no calibration token."""
    return _x(6)


def _no_token_params():
    params = _jax_params()
    params["router"]["bias"][3] = -100.0
    return params


def _jax_stats(dispatch, params, x, cf):
    jmoe = JaxMoEFFN(H, F, E, top_k=K, capacity_factor=cf, dropout_rate=0.0,
                     dispatch=dispatch, quant_mode="calibrate")
    _, mut = jax.jit(lambda p, xx: jmoe.apply(
        {"params": p}, xx, deterministic=True,
        mutable=["moe", "quant_stats"]))(params, jnp.asarray(x))
    return {k: np.asarray(v) for k, v in mut["quant_stats"].items()}


@pytest.mark.parametrize("dispatch", ["ragged", "sort"])
def test_moe_calibrate_matches_jax(dispatch):
    """The calibration statistics of each layout (ragged: every routed
    assignment; sort: the rows kept by capacity 0.5, empty slots included),
    an expert that saw no token at 0 (the sort layout's hidden statistic
    holds relu(b1) there, from its empty slots, in both packages), two
    batches combined by a running max."""
    x, cf = _calib_x(), 0.5
    params = _no_token_params()
    x2 = 2.0 * _x(7)
    want = _jax_stats(dispatch, params, x, cf)
    want2 = _jax_stats(dispatch, params, x2, cf)
    port = _port(params, capacity_factor=cf, dispatch=dispatch,
                 quant_mode="calibrate")
    with torch.no_grad():
        port(torch.from_numpy(x))
        for name in want:
            got = getattr(port, name).numpy()
            if dispatch == "ragged" or name == "expert_in_amax":
                assert (got[3] == 0).all() and (want[name][3] == 0).all()
            np.testing.assert_allclose(got, want[name], atol=ATOL, rtol=RTOL,
                                       err_msg=name)
        port(torch.from_numpy(x2))
    for name in want:
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.maximum(want[name], want2[name]),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_moe_int8_static_matches_jax():
    """int8_static through `sort` with JAX's calibrated scales carried
    across (models/transfer.py), expert 3's input amax at 0 taking each
    channel's max across experts: the output within the fp32 bar (the expert rows are
    the JAX package's bit for bit, ops/quant.py; only the router's gates
    sum in another order)."""
    x, cf = _calib_x(), 1.25
    params = _no_token_params()
    stats = _jax_stats("sort", params, x, cf)
    jmoe = JaxMoEFFN(H, F, E, top_k=K, capacity_factor=cf, dropout_rate=0.0,
                     dispatch="sort", quant_mode="int8_static")
    want, _ = jax.jit(lambda v, xx: jmoe.apply(
        v, xx, deterministic=True, mutable=["moe"]))(
        {"params": params, "quant": stats}, jnp.asarray(x))
    quant = {"core": {"encoder": {"layer_0": {"moe": stats}}}}
    layer = TransformerEncoderLayer(H, 4, F, ffn_impl="int8_static",
                                    moe=dict(num_experts=E, top_k=K,
                                             capacity_factor=cf,
                                             dispatch="sort"))
    port = layer.moe
    port.load_state_dict(_port(params).state_dict())
    scales = quant_scales_from_jax(quant)
    assert set(scales) == {"transformer_encoder.layers.0.moe.expert_in_amax",
                           "transformer_encoder.layers.0.moe."
                           "expert_hidden_amax"}
    holder = torch.nn.Module()
    holder.transformer_encoder = torch.nn.Module()
    holder.transformer_encoder.layers = torch.nn.ModuleList([layer])
    load_quant_scales(holder, scales)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="serving/eval"):
        port(torch.from_numpy(x), 0.1, torch.Generator())


def test_moe_quant_guards():
    with pytest.raises(ValueError, match="dispatch='sort'"):
        MoEFFN(H, F, E, dispatch="ragged", quant_mode="int8_static")
    with pytest.raises(ValueError, match="calibrate requires"):
        MoEFFN(H, F, E, dispatch="scatter", quant_mode="calibrate")
    with pytest.raises(ValueError, match="dynamic int8"):
        TransformerEncoderLayer(H, 4, F, ffn_impl="int8",
                                moe=dict(num_experts=E))
    with pytest.raises(ValueError, match="dispatch must be"):
        MoEFFN(H, F, E, dispatch="dense")
    with pytest.raises(ValueError, match="no calibrated scale"):
        MoEFFN(H, F, E, dispatch="sort", quant_mode="int8_static")(
            torch.zeros(1, 8, H))
