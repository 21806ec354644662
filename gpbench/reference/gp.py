"""The plain Gaussian-process reference that decides `correct`.

Universal kriging with a Gaussian correlation, written from its equations
in plain PyTorch, by default in float64:

  A         = c(X, X) + nugget I,   c(x, x') = exp(-sum_l ((x_l - x'_l) / delta_l)^2)
  beta      = G^-1 H^T A^-1 y,      G = H^T A^-1 H
  e         = A^-1 (y - H beta),    sigma2 = |L^-1 (y - H beta)|^2 / (n - q - 2)
  mean(x*)  = h(x*)^T beta + c(x*, X) e
  var(x*)   = sigma2 (1 - |L^-1 t|^2 + R G^-1 R^T),  t = c(X, x*),
              R = h(x*)^T - t^T A^-1 H
  NLL       = (n - q)/2 log sigma2 + 1/2 log|A| + 1/2 log|G|   (MUCM, sigma2 profiled)

Gradients come from autograd. It imports nothing of the program under
test. Run in float32 under `precision(tf32=True)`, it is the lower-precision
control: the same arithmetic with TF32 products.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

PRIOR_SCALE = 3.0          # N(0, 3^2) prior on each log hyperparameter
REJECT_LOGDENSITY = -1e12  # log density where the factorization fails


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 products on or off for the block, the caller's setting restored."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = tf32
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def linear_basis(x: torch.Tensor) -> torch.Tensor:
    """h(x) = (1, x_1, ..., x_d): the constant column first."""
    return torch.cat([torch.ones_like(x[..., :1]), x], -1)


def corr(x1: torch.Tensor, x2: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Gaussian correlation c(x1, x2) over leading batch axes of delta,
    from exact differences (no product, so TF32 never touches it).

    x1 (m, d), x2 (n, d), delta (..., d) -> (..., m, n)."""
    d2 = 0.0
    for k in range(x1.shape[-1]):
        diff2 = (x1[:, k, None] - x2[None, :, k]) ** 2
        d2 = d2 + diff2 / delta[..., k, None, None] ** 2
    return torch.exp(-d2)


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
        r = hb - c @ f.ainv_h
        lr = torch.linalg.solve_triangular(f.lg, r.T, upper=False)
        quad = 1.0 - (u * u).sum(1) + (lr * lr).sum(0)
        variances.append(f.sigma2 * torch.clamp(quad, min=0.0))
    return torch.cat(means), torch.cat(variances)


class Fit(NamedTuple):
    l: torch.Tensor        # (n, n) lower Cholesky factor of A
    lg: torch.Tensor       # (q, q) lower Cholesky factor of G
    beta: torch.Tensor     # (q,)
    e: torch.Tensor        # (n,)
    sigma2: torch.Tensor   # ()
    ainv_h: torch.Tensor   # (n, q)


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


def predict(f: Fit, x, xs, delta, block: int = 2048):
    """Posterior mean and variance at xs, computed in blocks of rows."""
    means, variances = [], []
    for s in range(0, xs.shape[0], block):
        xb = xs[s:s + block]
        hb = linear_basis(xb)
        c = corr(xb, x, delta)
        means.append(hb @ f.beta + c @ f.e)
        t = torch.linalg.solve_triangular(f.l, c.T, upper=False)
        r = hb - c @ f.ainv_h
        lr = torch.linalg.solve_triangular(f.lg, r.T, upper=False)
        quad = 1.0 - (t * t).sum(0) + (lr * lr).sum(0)
        variances.append(f.sigma2 * torch.clamp(quad, min=0.0))
    return torch.cat(means), torch.cat(variances)


def nll_mucm(log_delta: torch.Tensor, x, y, nugget: float) -> torch.Tensor:
    """The concentrated NLL at each row of log_delta (B, d); +inf where A or
    G does not factor. Differentiable in log_delta."""
    h = linear_basis(x)
    n, q = h.shape
    a = corr(x, x, torch.exp(log_delta))
    a = a + nugget * torch.eye(n, dtype=a.dtype, device=a.device)
    l, info = torch.linalg.cholesky_ex(a)
    ok = info == 0
    # a failed factor is replaced by the identity, so that its row stays
    # finite through the solves and autograd; its NLL is +inf below
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    l = torch.where(ok[:, None, None], l, eye)
    yh = torch.cat([y[:, None], h], 1).expand(a.shape[0], n, q + 1)
    w = torch.linalg.solve_triangular(l, yh, upper=False)
    wy, wh = w[..., 0], w[..., 1:]
    g = wh.mT @ wh
    lg, info_g = torch.linalg.cholesky_ex(g)
    ok = ok & (info_g == 0)
    lg = torch.where(ok[:, None, None], lg,
                     torch.eye(q, dtype=a.dtype, device=a.device))
    beta = torch.cholesky_solve((wh.mT @ wy[..., None]), lg)[..., 0]
    white = wy - (wh @ beta[..., None])[..., 0]
    resid = (white * white).sum(-1)
    logdet_a = 2.0 * torch.log(torch.diagonal(l, dim1=-2, dim2=-1)).sum(-1)
    logdet_g = 2.0 * torch.log(torch.diagonal(lg, dim1=-2, dim2=-1)).sum(-1)
    value = (0.5 * (n - q) * torch.log(resid / (n - q - 2)) + 0.5 * logdet_a
             + 0.5 * logdet_g)
    return torch.where(ok & torch.isfinite(value), value,
                       torch.full_like(value, float("inf")))


def nll_and_grad(log_delta, x, y, nugget: float):
    """(NLL (B,), d NLL / d log_delta (B, d))."""
    with torch.enable_grad():
        z = log_delta.detach().clone().requires_grad_(True)
        v = nll_mucm(z, x, y, nugget)
        (g,) = torch.autograd.grad(torch.where(torch.isfinite(v), v, 0.0).sum(),
                                   z)
    return v.detach(), g


def logdensity_and_grad(z, x, y, nugget: float):
    """The hyperparameter posterior over z = log delta (B, d): -NLL plus
    the N(0, PRIOR_SCALE^2) log prior, with REJECT_LOGDENSITY in place of
    -NLL and a NaN gradient where the NLL is not finite. Returns (values
    (B,), gradients (B, d))."""
    v, g = nll_and_grad(z, x, y, nugget)
    ok = torch.isfinite(v)
    lp = -0.5 * ((z / PRIOR_SCALE) ** 2).sum(-1)
    value = torch.where(ok, -v, torch.full_like(v, REJECT_LOGDENSITY)) + lp
    grad = torch.where(ok[:, None], -g - z / PRIOR_SCALE ** 2,
                       torch.full_like(g, float("nan")))
    return value, grad
