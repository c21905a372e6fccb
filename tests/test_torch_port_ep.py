"""The port's expert-parallel pieces against the JAX package's, in one
process: the plain versions of kernels B4s and B4ts, the window forms of
B4 and B4t (`gmm_sharded`, `tgmm_sharded`, `GroupedMatmul` with a group
offset), against JAX `gmm_sharded` and
`_tgmm_pallas(..., group_offset=)` in interpret mode, on the template of
tests/test_pallas_gmm.py:115-180 (the shards sum to the full grouped matmul,
the gradients to the full one's, windows at the start, middle and end, empty
local groups, e_loc = 1); and the MoE layer's shard-local expert body, each
model index's output and input gradient summed over the indices here (what
the model group's all_reduce sums), against JAX's `_ep_ragged_experts` on the
8-device CPU mesh of tests/conftest.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models.moe import MoEFFN as JaxMoEFFN
from weathermodel_tpu.models.moe import (
    configure_expert_parallel as jax_configure_ep,
)
from weathermodel_tpu.models.moe import get_ep_mesh as jax_get_ep_mesh
from weathermodel_tpu.ops import pallas_gmm
from weathermodel_tpu.parallel.mesh import make_mesh as jax_make_mesh
from weathermodel_tpu.parallel.mesh import shard_batch as jax_shard_batch
from weathermodel_tpu_torch.models import moe
from weathermodel_tpu_torch.ops.gmm import (
    GroupedMatmul,
    gmm_reference,
    gmm_sharded,
    tgmm_reference,
    tgmm_sharded,
)
from weathermodel_tpu_torch.parallel import mesh as mesh_lib
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from test_torch_port_jax_params import (
    jax_params_from_state,
    moe_ffn_state_dict,
)

# (S, group sizes): boundaries inside a 128-row tile, empty first and last
# groups, an empty middle group with S off the tile, tiny groups sharing a
# tile (tests/test_pallas_gmm.py's GS_CASES)
GS_CASES = [(256, [100, 60, 96, 0]), (256, [0, 256, 0, 0]),
            (300, [128, 0, 44, 128]), (130, [1, 1, 1, 127])]
K, N = 16, 24


def _case(seed, s, gs):
    rng = np.random.default_rng(seed)
    e = len(gs)
    return (rng.normal(size=(s, K)).astype(np.float32),
            rng.normal(size=(e, K, N)).astype(np.float32),
            rng.normal(size=(s, N)).astype(np.float32),
            np.asarray(gs, np.int32))


def _windows(e):
    """(off, e_loc) of every shard of 2-way and e-way splits: windows at the
    start, middle and end, and e_loc = 1."""
    return [(j * (e // m), e // m) for m in (2, e) for j in range(m)]


@pytest.fixture(scope="module")
def jax_results():
    """JAX gmm_sharded (forward) and the interpret-mode B4t window
    (`_tgmm_pallas` with group_offset) on each case and window."""
    forward = jax.jit(pallas_gmm.gmm_sharded)
    wgrad = jax.jit(lambda lhs, dy, g, o, e_loc: pallas_gmm._tgmm_pallas(
        lhs, dy, g, jnp.float32, group_offset=o, e_local=e_loc),
        static_argnums=4)
    out = {}
    for i, (s, gs) in enumerate(GS_CASES):
        lhs, rhs, dy, g = (jnp.asarray(a) for a in _case(i, s, gs))
        for off, e_loc in _windows(len(gs)):
            o = jnp.asarray(off, jnp.int32)
            out[i, off, e_loc] = (
                np.asarray(forward(lhs, rhs[off:off + e_loc], g, o)),
                np.asarray(wgrad(lhs, dy, g, o, e_loc)))
    return out


@pytest.mark.parametrize("case", range(len(GS_CASES)))
def test_window_forms_match_jax_and_sum_to_full(jax_results, case):
    s, gs = GS_CASES[case]
    lhs, rhs, dy, g = (torch.from_numpy(a) for a in _case(case, s, gs))
    e = len(gs)
    for m in (2, e):
        e_loc = e // m
        outs, wgrads = [], []
        for j in range(m):
            off = j * e_loc
            y = gmm_sharded(lhs, rhs[off:off + e_loc], g, off)
            dw = tgmm_sharded(lhs, dy, g, off, e_loc)
            want_y, want_dw = jax_results[case, off, e_loc]
            np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-5,
                                       atol=1e-5)
            # an empty local group's weight gradient is zeros
            for gi in range(e_loc):
                if gs[off + gi] == 0:
                    assert not dw[gi].any()
            outs.append(y)
            wgrads.append(dw)
        # each row is non-zero on one shard at most, and the shards' sum is
        # the full grouped matmul bit for bit (a sum of a value and zeros)
        nz = sum((o.abs().amax(dim=1) > 0).int() for o in outs)
        assert int(nz.max()) <= 1
        assert torch.equal(sum(outs), gmm_reference(lhs, rhs, g))
        assert torch.equal(torch.cat(wgrads), tgmm_reference(lhs, dy, g))


def test_window_form_gradients_sum_to_full():
    """d_lhs and d_rhs of GroupedMatmul over each window, summed and stacked over the
    shards, are the full grouped matmul's, and JAX's gmm_sharded's custom
    VJP's (pallas_gmm.py:389-409) in interpret mode."""
    s, gs = GS_CASES[2]
    lhs_np, rhs_np, dy_np, g_np = _case(7, s, gs)
    e, e_loc = len(gs), 2
    g = torch.from_numpy(g_np)

    def loss_jax(lhs, rhs):
        y = sum(pallas_gmm.gmm_sharded(
            lhs, rhs[j * e_loc:(j + 1) * e_loc], jnp.asarray(g_np),
            jnp.asarray(j * e_loc, jnp.int32)) for j in range(e // e_loc))
        return jnp.sum(y * dy_np)

    jl, jr = jax.jit(jax.grad(loss_jax, argnums=(0, 1)))(
        jnp.asarray(lhs_np), jnp.asarray(rhs_np))
    lhs = torch.from_numpy(lhs_np).requires_grad_()
    rhs = torch.from_numpy(rhs_np).requires_grad_()
    y = sum(GroupedMatmul.apply(lhs, rhs[j * e_loc:(j + 1) * e_loc], g,
                                j * e_loc)
            for j in range(e // e_loc))
    (y * torch.from_numpy(dy_np)).sum().backward()
    lhs_full = torch.from_numpy(lhs_np).requires_grad_()
    rhs_full = torch.from_numpy(rhs_np).requires_grad_()
    (gmm_reference(lhs_full, rhs_full, g)
     * torch.from_numpy(dy_np)).sum().backward()
    for got, full, want in ((lhs.grad, lhs_full.grad, jl),
                            (rhs.grad, rhs_full.grad, jr)):
        assert torch.equal(got, full)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_window_forms_reject_a_window_outside_the_groups():
    lhs, rhs, dy, g = (torch.from_numpy(a) for a in _case(0, *GS_CASES[0]))
    with pytest.raises(ValueError, match="window"):
        gmm_sharded(lhs, rhs[:2], g, 3)
    with pytest.raises(ValueError, match="window"):
        tgmm_sharded(lhs, dy, g, -1, 2)
    with pytest.raises(ValueError, match="window"):
        gmm_reference(lhs, rhs[:3], g, group_offset=2)


H, F, E, B, T = 8, 16, 4, 8, 16


@pytest.fixture
def _restore_ep_meshes():
    """JAX's EP mesh restored after the test; JAX's grouped matmul through
    its plain reference (`_gmm_offset_ref`, as off the TPU without
    interpret mode: the kernel is held above) for the test's duration."""
    before = jax_get_ep_mesh()
    pallas_gmm.set_interpret(False)
    try:
        yield
    finally:
        pallas_gmm.set_interpret(True)
        jax_configure_ep(before)


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4)])
def test_shard_local_expert_body_matches_jax_ep(_restore_ep_meshes, n_data,
                                                n_model):
    """The port's MoE layer on each (data, model) shard with its expert
    slice, outputs and input gradients summed over the model indices, equals
    JAX's shard_mapped EP forward and its gradient on the CPU mesh: the
    local sort per data rank changes no row's products, and the summed
    partial row gradients are the full ones."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, T, H)).astype(np.float32)
    cot = rng.normal(size=(B, T, H)).astype(np.float32)
    jm = JaxMoEFFN(hidden_dim=H, ffn_dim=F, num_experts=E, top_k=2,
                   dropout_rate=0.0, dispatch="ragged")
    seeded = moe.MoEFFN(H, F, E, top_k=2)
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    # the port's init as the flax tree (test_torch_port_jax_params.py)
    params = jax_params_from_state(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        deterministic=True),
        moe_ffn_state_dict, seeded.state_dict())
    mesh = jax_make_mesh(n_data, n_model)
    jax_configure_ep(mesh)

    def f(xi):
        out, _ = jm.apply(params, xi, deterministic=True, mutable=["moe"])
        return jnp.sum(out * cot), out

    xs = jax.device_put(jnp.asarray(x), jax_shard_batch(mesh, x).sharding)
    (_, want), want_dx = jax.jit(jax.value_and_grad(f, has_aux=True))(xs)

    p = jax.tree.map(np.asarray, params["params"])
    full = {"router.weight": p["router"]["kernel"].T,
            "router.bias": p["router"]["bias"],
            **{k: p[k] for k in ("expert_w1", "expert_b1", "expert_w2",
                                 "expert_b2")}}
    rows = B // n_data
    got = np.zeros_like(x)
    got_dx = np.zeros_like(x)
    for di in range(n_data):
        sl = slice(di * rows, (di + 1) * rows)
        for mi in range(n_model):
            shard = mesh_lib.Mesh(n_data, n_model, rank=di * n_model + mi)
            layer = moe.MoEFFN(H, F, E, top_k=2)
            layer.load_state_dict({k: torch.from_numpy(np.array(v))
                                   for k, v in full.items()})
            mesh_lib.shard_params(layer, shard)
            xi = torch.from_numpy(x[sl]).requires_grad_()
            with mesh_lib.activate(shard):
                out, _ = layer(xi)
            (out * torch.from_numpy(cot[sl])).sum().backward()
            got[sl] += out.detach().numpy()
            got_dx[sl] += xi.grad.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_dx, np.asarray(want_dx), rtol=2e-5,
                               atol=2e-5)
