"""The plain reference of the ARD Matern 5/2 emulator, which decides
`correct` in its cells.

Universal kriging as `gp.py` states it, with the Matern nu = 5/2
correlation of one length an input (Rasmussen & Williams, Gaussian
Processes for Machine Learning, 2006, eq. 4.17; GPyTorch's
MaternKernel(nu=2.5, ard_num_dims=d)) in place of the Gaussian:

  r(x, x')  = sqrt(sum_l ((x_l - x'_l) / delta_l)^2),   s = sqrt(5) r
  c(x, x')  = (1 + s + s^2 / 3) exp(-s)
  A         = c(X, X) + nugget I,   G = H^T A^-1 H,   beta = G^-1 H^T A^-1 y
  e         = A^-1 (y - H beta),    sigma2 = |L^-1 (y - H beta)|^2 / (n - q - 2)
  mean(x*)  = h(x*)^T beta + c(x*, X) e
  var(x*)   = sigma2 (1 - |L^-1 t|^2 + R G^-1 R^T),  t = c(X, x*),
              R = h(x*)^T - t^T A^-1 H

Plain torch, by default in float64 under `precision(False)` (TF32 off); it
imports nothing of the program under test. Run in float32 under
`precision(True)`, `whitened_predict` is the lower-precision control.
"""
from __future__ import annotations

import math

import torch

from gpbench.reference.gp import Fit, linear_basis, precision  # noqa: F401

SQRT5 = math.sqrt(5.0)


def corr(x1: torch.Tensor, x2: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Matern 5/2 correlation c(x1, x2) from exact differences (no product,
    so TF32 never touches it). x1 (m, d), x2 (n, d), delta (d,) -> (m, n)."""
    d2 = 0.0
    for k in range(x1.shape[-1]):
        d2 = d2 + ((x1[:, k, None] - x2[None, :, k]) / delta[k]) ** 2
    s = SQRT5 * torch.sqrt(d2)
    return (1.0 + s + s * s / 3.0) * torch.exp(-s)


def fit(x, y, delta, nugget: float) -> Fit:
    """The posterior's sufficient statistics at fixed hyperparameters."""
    h = linear_basis(x)
    n, q = h.shape
    a = corr(x, x, delta)
    a.diagonal().add_(nugget)
    l = torch.linalg.cholesky(a)
    del a
    w = torch.linalg.solve_triangular(l, torch.cat([y[:, None], h], 1),
                                      upper=False)
    wy, wh = w[:, 0], w[:, 1:]
    lg = torch.linalg.cholesky(wh.T @ wh)
    beta = torch.cholesky_solve((wh.T @ wy)[:, None], lg)[:, 0]
    white = wy - wh @ beta
    sigma2 = (white @ white) / (n - q - 2)
    back = torch.linalg.solve_triangular(
        l.T, torch.cat([white[:, None], wh], 1), upper=True)
    return Fit(l, lg, beta, back[:, 0], sigma2, back[:, 1:])


def _var(f: Fit, quad_t, r):
    lr = torch.linalg.solve_triangular(f.lg, r.T, upper=False)
    return f.sigma2 * torch.clamp(1.0 - quad_t + (lr * lr).sum(0), min=0.0)


def predict(f: Fit, x, xs, delta, block: int = 2048):
    """Posterior mean and variance at xs, computed in blocks of rows."""
    means, variances = [], []
    for s in range(0, xs.shape[0], block):
        xb = xs[s:s + block]
        hb = linear_basis(xb)
        c = corr(xb, x, delta)
        means.append(hb @ f.beta + c @ f.e)
        t = torch.linalg.solve_triangular(f.l, c.T, upper=False)
        variances.append(_var(f, (t * t).sum(0), hb - c @ f.ainv_h))
    return torch.cat(means), torch.cat(variances)


def whitened_predict(f: Fit, x, xs, delta, block: int = 2048):
    """`predict` in the serving form that the program computes: W = L^-1
    once, then products (c e for the mean, |W c|^2 for the variance). Run
    under TF32 it is the control: the serving products in one TF32 pass."""
    w = torch.linalg.solve_triangular(
        f.l, torch.eye(f.l.shape[0], dtype=f.l.dtype, device=f.l.device),
        upper=False)
    means, variances = [], []
    for s in range(0, xs.shape[0], block):
        xb = xs[s:s + block]
        hb = linear_basis(xb)
        c = corr(xb, x, delta)
        means.append(hb @ f.beta + c @ f.e)
        u = c @ w.T
        variances.append(_var(f, (u * u).sum(1), hb - c @ f.ainv_h))
    return torch.cat(means), torch.cat(variances)
