"""Variational loss primitives (port of weathermodel_tpu/ops/losses.py,
reference losses.py:10-87):

* masked diagonal-Gaussian log-likelihood
    log N(x; mu, var) = -0.5*log(2*pi*var) - 0.5*(x-mu)^2/var
* diagonal-Gaussian KL
    KL(q||p) = 0.5*[log(var_p/var_x) + var_x/var_p + (mu_x-mu_p)^2/var_p - 1]
* mixture-prior KL from one sample z:
    KL ~= log q(z|x) - logsumexp_k(log w_k + log N(z; mu_k, var_k))

Each reduces over every non-batch axis and returns [batch]. Masks select the
(timestep, feature) positions that count (True = counts).
"""

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_log_likelihood(x, mu, var, mask, dims=None):
    """Masked Gaussian log-likelihood summed over `dims` (default: every
    non-batch dim)."""
    if dims is None:
        dims = tuple(range(1, x.dim()))
    ll = -0.5 * (_LOG_2PI + torch.log(var)) - 0.5 * (x - mu).square() / var
    return (ll * mask).sum(dim=dims)


def gaussian_kl_divergence(mask, mu_x, var_x, mu_p, var_p):
    """KL between diagonal Gaussians at the masked positions, summed over
    the (time, feature) dims: [batch]."""
    kl = 0.5 * (torch.log(var_p / var_x) + var_x / var_p
                + (mu_x - mu_p).square() / var_p - 1.0)
    return (kl * mask).sum(dim=(1, 2))


def mixture_kl_divergence(z, mask, mu_x, var_x, mu_k, var_k, log_w_k):
    """One-sample KL estimate between q(z|x) = N(mu_x, var_x) and a mixture
    of diagonal Gaussians. z, mask, mu_x, var_x [B, T, F]; mu_k, var_k
    [B, K, T, F]; log_w_k [B, K]."""
    log_q_z_x = gaussian_log_likelihood(z, mu_x, var_x, mask, dims=(1, 2))
    log_components = gaussian_log_likelihood(
        z[:, None], mu_k, var_k, mask[:, None], dims=(2, 3))     # [B, K]
    return log_q_z_x - torch.logsumexp(log_w_k + log_components, dim=1)
