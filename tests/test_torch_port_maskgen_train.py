"""The maskgen dropout impls through the port's train step and its MoE
layer on the CPU, where the mask kernels B9p / B9b run as their plain
versions: at hidden 128 and FFN 512 with 4 x 16 rows every plain dropout
site takes the kernel path. The MoE layer's hidden site is also held
against the JAX MoEFFN under `maskgen_bool` with the port's mask injected
(its ragged grouped matmuls in interpret mode), in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import weathermodel_tpu.ops.dropout as jax_dropout
import weathermodel_tpu.ops.pallas_maskgen as jax_maskgen
from weathermodel_tpu.models.moe import MoEFFN as JaxMoEFFN
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models.moe import MoEFFN
from weathermodel_tpu_torch.ops import dropout, maskgen
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.steps import Batch, make_train_step
from weathermodel_tpu_torch.utils.config import ModelConfig

CFG = ModelConfig(num_heads=4, hidden_dim_factor=32, num_layers=2,
                  max_len=16)
B, T, F = 4, 16, 31
IMPLS = ("auto", "maskgen", "maskgen_bool")
REFERENCE = {"maskgen": "packed_keep_mask_reference",
             "maskgen_bool": "bool_keep_mask_reference"}


@pytest.fixture
def impl():
    """Set a dropout impl for one test; restores the one before."""
    old = dropout.get_impl()
    yield dropout.set_impl
    dropout.set_impl(old)


def _counting(monkeypatch, name):
    """Wrap maskgen's plain mask generator `name`: returns the list of the
    (m, c) of each call."""
    calls = []
    fn = getattr(maskgen, name)

    def counted(m, c, *args):
        calls.append((m, c))
        return fn(m, c, *args)

    monkeypatch.setattr(maskgen, name, counted)
    return calls


def _step(rate):
    """One seeded WeatherBERT train step at dropout `rate`: (loss, the
    gradients, the CPU generator's state after the step)."""
    model = make_model("weatherbert", CFG, "fused_qkv")
    model.reset_parameters(torch.Generator().manual_seed(0))
    step = make_train_step(model, make_optimizer(model), "weatherbert")
    rng = np.random.default_rng(0)
    batch = Batch(*(torch.tensor(a, dtype=torch.float32) for a in (
        rng.normal(size=(B, T, F)), rng.uniform(-90, 90, (B, 2)),
        np.full((B, T), 1995.0), np.full((B, 1), 7.0))))
    mask = torch.tensor(rng.random((B, T, F)) < 0.15)
    gen = torch.Generator().manual_seed(0)
    out = step(batch, gen, 1e-4, 1, mask=mask, dropout_rate=rate)
    return (out["total_loss"].item(),
            [p.grad.clone() for p in model.parameters()], gen.get_state())


@pytest.mark.parametrize("name", ["maskgen", "maskgen_bool"])
def test_train_step_runs_every_site_through_the_mask_kernel(monkeypatch,
                                                            impl, name):
    """Dropout 0.1: a finite loss, and the mask generator called at the
    three plain sites of each layer (attention out [64, 128], FFN hidden
    [64, 512], FFN out [64, 128]) in the forward and never in the
    backward."""
    calls = _counting(monkeypatch, REFERENCE[name])
    impl(name)
    loss, grads, _ = _step(0.1)
    assert np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    h, f, m = CFG.hidden_dim, CFG.ffn_dim, B * T
    assert calls == [(m, h), (m, f), (m, h)] * CFG.num_layers


def test_impls_agree_at_dropout_0_and_draw_the_same_seeds(impl):
    """At dropout 0 every impl gives the `auto` step bitwise; at 0.1 the
    CPU generator ends in the same state whatever the impl (each site draws
    one seed), so later seeds do not depend on it."""
    runs = {}
    for name in IMPLS:
        impl(name)
        runs[name] = (_step(0.0), _step(0.1))
    (loss0, grads0, _), (_, _, state) = runs["auto"]
    for name in IMPLS[1:]:
        (loss, grads, _), (_, _, other) = runs[name]
        assert loss == loss0
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
        assert torch.equal(other, state)


def test_moe_hidden_site_takes_the_bool_kernel_and_matches_jax(monkeypatch,
                                                               impl):
    """A MoE-mini layer (H=32, F=128, E=4, top-2, x [2, 16, 32]) under
    `maskgen_bool`: its expert hidden [64, 128] goes through B9b's plain
    version once; the JAX MoEFFN under `maskgen_bool` with that mask
    injected gives the same output (2e-5) and gradients (1e-4), the bars
    of tests/test_torch_port_moe.py."""
    h, f, e, k, rate = 32, 128, 4, 2, 0.1
    rng = np.random.default_rng(0)
    x, dy = rng.normal(size=(2, 2, 16, h)).astype(np.float32)
    jmoe = JaxMoEFFN(h, f, e, top_k=k, dropout_rate=rate, dispatch="ragged")
    params = jmoe.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]

    port = MoEFFN(h, f, e, top_k=k)
    router = {key: np.asarray(a) for key, a in params["router"].items()}
    port.load_state_dict({
        "router.weight": torch.tensor(router["kernel"].T),
        "router.bias": torch.tensor(router["bias"]),
        **{name: torch.tensor(np.asarray(params[name]))
           for name in ("expert_w1", "expert_b1", "expert_w2",
                        "expert_b2")}})
    masks = []
    fn = maskgen.bool_keep_mask_reference

    def recorded(*args):
        masks.append(fn(*args))
        return masks[-1]

    monkeypatch.setattr(maskgen, "bool_keep_mask_reference", recorded)
    impl("maskgen_bool")
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = port(xt, rate, torch.Generator().manual_seed(0))
    (out * torch.from_numpy(dy)).sum().backward()
    assert [tuple(m.shape) for m in masks] == [(2 * 16 * k, f)]

    monkeypatch.setattr(jax_maskgen, "bool_keep_mask",
                        lambda m, c, r, s: jnp.asarray(masks[0].numpy()))
    old = jax_dropout.get_impl()
    jax_dropout.set_impl("maskgen_bool")
    try:
        def jax_loss(p, xx):
            y = jmoe.apply({"params": p}, xx, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(2)},
                           mutable=["moe"])[0]
            return jnp.sum(y * dy), y

        (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
            jax_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    finally:
        jax_dropout.set_impl(old)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4,
                               rtol=1e-4)
    for name in ("expert_w1", "expert_b1", "expert_w2", "expert_b2"):
        np.testing.assert_allclose(getattr(port, name).grad.numpy(),
                                   np.asarray(gp[name]), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
