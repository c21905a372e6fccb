"""The port's variational losses against weathermodel_tpu.ops.losses on the
same arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.ops import losses as jax_losses
from weathermodel_tpu_torch.ops import losses
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401


B, K, T, F = 3, 4, 11, 7


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    x, mu_x, mu_p = (rng.normal(size=(B, T, F)).astype(np.float32)
                     for _ in range(3))
    var_x, var_p = (rng.uniform(1e-3, 1.0, (B, T, F)).astype(np.float32)
                    for _ in range(2))
    mask = rng.random((B, T, F)) < 0.4
    mu_k = rng.normal(size=(B, K, T, F)).astype(np.float32)
    var_k = rng.uniform(1e-3, 1.0, (B, K, T, F)).astype(np.float32)
    logits = rng.normal(size=(1, K)).astype(np.float32)
    log_w_k = np.broadcast_to(
        logits - np.log(np.exp(logits).sum(axis=1, keepdims=True)), (B, K))
    return dict(x=x, mu_x=mu_x, var_x=var_x, mu_p=mu_p, var_p=var_p,
                mask=mask, mu_k=mu_k, var_k=var_k,
                log_w_k=np.ascontiguousarray(log_w_k))


def _call(fn, names, a, to):
    return np.asarray(fn(*(to(a[n]) for n in names)))


# fp32, the same formulas, sums in another order
@pytest.mark.parametrize("name,args", [
    ("gaussian_log_likelihood", ("x", "mu_x", "var_x", "mask")),
    ("gaussian_kl_divergence", ("mask", "mu_x", "var_x", "mu_p", "var_p")),
    ("mixture_kl_divergence", ("x", "mask", "mu_x", "var_x", "mu_k", "var_k",
                               "log_w_k")),
])
def test_losses_match_jax(name, args):
    a = _arrays()
    want = _call(getattr(jax_losses, name), args, a, jnp.asarray)
    got = _call(getattr(losses, name), args, a, torch.from_numpy)
    assert got.shape == want.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
