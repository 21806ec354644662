"""GP core: likelihoods, fit state, universal-kriging posterior (forward code).

Port of `gp_emu_uqsa_tpu.gp`. Mathematical spec (SURVEY.md S7, MUCM toolkit):

  model      y(x) = h(x)^T beta + Z(x),  cov[Z] = sigma^2 c(x,x'),
             c the Gaussian correlation (kernels.py) + nugget nu on the diag.
  beta       GLS:  beta_hat = G^{-1} H^T A^{-1} y,  G = H^T A^{-1} H.
  sigma^2    MUCM mode: profiled analytically,
             sigma2_hat = y^T (A^{-1} - A^{-1} H G^{-1} H^T A^{-1}) y / (n-q-2).
  NLL mucm   (n-q)/2 log sigma2_hat + 1/2 log|A| + 1/2 log|G|   (+const).
  NLL gp4ml  1/2 [ resid/sigma^2 + n log sigma^2 + log|A| + n log 2pi ].
  posterior  m*(x)  = h(x)^T beta_hat + t(x)^T e,  e = A^{-1}(y - H beta_hat)
             v*(x,x') = sigma2 [ c(x,x') - t(x)^T A^{-1} t(x')
                                 + R(x) G^{-1} R(x')^T ],
             R(x) = h(x)^T - t(x)^T A^{-1} H.
  validation standardized errors; Mahalanobis D = err^T V*^{-1} err with
             E[D] = n_V, Var[D] = 2 n_V (n_V + n - q - 2)/(n - q - 4).

Everything goes through one Cholesky of A (and of the q x q G) and
triangular solves. Failed factorizations give +inf likelihoods, never NaN.
Every product runs in full fp32 or fp64 (`fp32_exact`: TF32 off).

The likelihoods take hyperparameters with a leading batch axis (the
restarts of a multi-restart fit: log_delta (B, d), log_sigma2 and
log_nugget (B,)) and return one NLL per restart; y is one (n,) for all,
or (B, n), one a restart (`multi.MultiEmulator`). They are differentiable:
`nll_mucm` through `_NllMucm`, whose backward is the analytic,
factor-reusing adjoint `_nll_mucm_bwd`; `nll_gp4ml` and `nll_mucm_ad`
through autograd (the K1 adjoint and the ladder's `_chol_rev`).

`sample_posterior` draws from the predictive distribution through an
explicit `torch.Generator`; its deterministic half,
`sample_posterior_from_draws`, takes the normals and chi-square draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gp_emu_uqsa_torch.kernels import (
    GPParams, corr, corr_self, sq_diff_contraction,
)
from gp_emu_uqsa_torch.ops.cholesky import (
    cho_solve_refined, cholesky_or_nan, cholesky_with_jitter, tri_inverse,
    tri_solve, tri_solve_auto,
)
from gp_emu_uqsa_torch.ops.precision import fp32_exact

_LOG2PI = 1.8378770664093453


class FitState(NamedTuple):
    """Sufficient statistics of a fitted GP, reused by posterior & UQSA.

    Shapes: n training points, q basis functions, d active dims.
    """

    params: GPParams
    l: torch.Tensor          # (n, n) lower Cholesky of A (+jitter)
    lg: torch.Tensor         # (q, q) lower Cholesky of G = H^T A^-1 H
    beta: torch.Tensor       # (q,)   GLS beta_hat
    e: torch.Tensor          # (n,)   A^-1 (y - H beta_hat)
    sigma2: torch.Tensor     # ()     sigma2_hat (mucm) or explicit sigma2 (gp4ml)
    ainv_h: torch.Tensor     # (n, q) A^-1 H
    jitter: torch.Tensor     # ()     jitter added to factorize A
    nll: torch.Tensor        # ()     NLL at these params


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.mT)


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product over leading batch axes: a (..., m, k), v (..., k)."""
    return (a @ v[..., None])[..., 0]


def _logdet(l: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), -1)


@fp32_exact
def _common(params: GPParams, x, y, h, noise_diag=None, ladder=True,
            family: str = "gaussian"):
    """Shared pipeline: factorize A, whiten y and H, GLS beta, residual.

    noise_diag: optional per-point noise variances added to the diagonal
    (heteroscedastic nugget, in correlation units). ladder=False uses a
    single plain Cholesky (NaN factor on failure) instead of the ladder.
    One restart or a batch of them: every result gains the params' batch
    axes. y is (n,), or (B, n) with the params' batch axis, one y a restart
    (the outputs of a multi-output fit).
    """
    a = corr_self(x, params, family)
    if noise_diag is not None:
        a = a + torch.diag(torch.as_tensor(noise_diag, dtype=a.dtype,
                                           device=a.device))
    if ladder:
        l, jitter = cholesky_with_jitter(a)
    else:
        l = cholesky_or_nan(a)
        jitter = torch.zeros(a.shape[:-2], dtype=a.dtype, device=a.device)
    yh = torch.cat([y[..., None], h.expand(*y.shape[:-1], *h.shape)], -1)
    linv_yh = tri_solve_auto(l, yh)
    linv_y = linv_yh[..., 0]                         # L^-1 y
    linv_h = linv_yh[..., 1:]                        # L^-1 H
    g = linv_h.mT @ linv_h                           # H^T A^-1 H
    lg = cholesky_or_nan(_sym(g))
    hty = _mv(linv_h.mT, linv_y)                     # H^T A^-1 y
    lg_inv_hty = tri_solve(lg, hty[..., None])[..., 0]   # Lg^-1 H^T A^-1 y
    beta = tri_solve(lg, lg_inv_hty[..., None], trans=True)[..., 0]
    # y^T A^-1 y - (H^T A^-1 y)^T G^-1 (H^T A^-1 y) = |L^-1 (y - H beta)|^2.
    # The JAX package takes the difference of the first two terms, which
    # cancel where the basis explains most of y; the sum of squares of the
    # whitened residual does not.
    white = linv_y - _mv(linv_h, beta)               # L^-1 (y - H beta)
    resid = torch.sum(white * white, -1)
    return (a, l, jitter, white, linv_h, lg, beta, resid, _logdet(l),
            _logdet(lg))


def _guard(nll: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(nll), nll,
                       torch.full_like(nll, float("inf")))


def _mucm_value(n, q, resid, logdet_a, logdet_g):
    sigma2_hat = resid / (n - q - 2)
    return (0.5 * (n - q) * torch.log(sigma2_hat) + 0.5 * logdet_a
            + 0.5 * logdet_g)


def nll_mucm_ad(params: GPParams, x, y, h, noise_diag=None,
                ladder: bool = True, family: str = "gaussian") -> torch.Tensor:
    """Concentrated NLL through plain autograd (the reference for the
    analytic adjoint, and the path of noise_diag and other families)."""
    n, q = h.shape[0], h.shape[1]
    (_, _, _, _, _, _, _, resid, logdet_a, logdet_g) = _common(
        params, x, y, h, noise_diag, ladder, family)
    return _guard(_mucm_value(n, q, resid, logdet_a, logdet_g))


@fp32_exact
def _nll_mucm_fwd(params: GPParams, x, y, h, ladder: bool):
    """The concentrated NLL and what its adjoint reuses: (nll, saved)."""
    n, q = h.shape[0], h.shape[1]
    (a, l, _, white, linv_h, lg, _, resid, logdet_a, logdet_g) = _common(
        params, x, y, h, None, ladder)
    nll = _guard(_mucm_value(n, q, resid, logdet_a, logdet_g))
    e = tri_solve_auto(l, white[..., None], trans=True)[..., 0]
    return nll, (a, l, linv_h, lg, e, resid)


@fp32_exact
def _nll_mucm_bwd(params: GPParams, x, saved, nll, ct):
    """Analytic adjoint, reusing the forward's factor and A.

    dNLL/dA = 1/2 A^-1 - 1/2 (A^-1 H) G^-1 (A^-1 H)^T
              - (n-q)/(2 resid) e e^T
    then chained through A(delta, nugget):
      dA_ij/dlog delta_l = A_ij * 2 ((x_il-x_jl)/delta_l)^2
      dA/dlog nugget     = nugget * I
    so grad_log_delta_l = 2/delta_l^2 sum_ij M_ij (x_il-x_jl)^2 with
    M = W (*) A, summed over exact differences
    (`kernels.sq_diff_contraction`; the JAX package's rank-1 collapse of
    this sum cancels in fp32): O(n^2 d).
    A^-1 = L^-T L^-1 as in the JAX package: one triangular solve with n
    right-hand sides and one product. Rows whose NLL is not finite get zero
    gradients. Returns (grad_log_delta, grad_log_nugget, grad_y per row).
    """
    a, l, linv_h, lg, e, resid = saved
    n = x.shape[0]
    q = linv_h.shape[-1]
    linv = tri_inverse(l)
    ainv = linv.mT @ linv
    del linv
    ainv_h = tri_solve_auto(l, linv_h, trans=True)            # (..., n, q)
    lg_inv_ah = tri_solve(lg, ainv_h.mT)                      # (..., q, n)
    w = (0.5 * ainv - 0.5 * (lg_inv_ah.mT @ lg_inv_ah)
         - ((n - q) / (2.0 * resid))[..., None, None]
         * (e[..., :, None] * e[..., None, :]))
    delta2 = torch.exp(2.0 * params.log_delta)
    sq = sq_diff_contraction(w * a, x, x)                     # (..., d)
    ok = torch.isfinite(nll)
    zero = torch.zeros((), dtype=nll.dtype, device=nll.device)
    ct = torch.where(ok, ct, zero)
    grad_log_delta = torch.where(
        ok[..., None], (2.0 / delta2) * sq * ct[..., None], zero)
    grad_log_nugget = torch.where(
        ok, params.nugget * torch.diagonal(w, dim1=-2, dim2=-1).sum(-1) * ct,
        zero)
    # dNLL/dy = (n-q)/resid * P y = (n-q)/resid * e
    grad_y = torch.where(ok[..., None],
                         ((n - q) / resid)[..., None] * e * ct[..., None], zero)
    return grad_log_delta, grad_log_nugget, grad_y


class _NllMucm(torch.autograd.Function):
    """The concentrated NLL with the analytic adjoint (the JAX package's
    `_nll_mucm_cvjp`). Gradients flow to log_delta, log_nugget and y;
    log_sigma2 (profiled out) gets zero, x and h none."""

    @staticmethod
    def forward(ctx, log_delta, log_sigma2, log_nugget, x, y, h, ladder):
        params = GPParams(log_delta, log_sigma2, log_nugget)
        nll, saved = _nll_mucm_fwd(params, x, y, h, ladder)
        ctx.save_for_backward(log_delta, log_sigma2, log_nugget, x, nll,
                              *saved)
        ctx.y_shape = y.shape
        return nll

    @staticmethod
    def backward(ctx, ct):
        log_delta, log_sigma2, log_nugget, x, nll, *saved = ctx.saved_tensors
        params = GPParams(log_delta, log_sigma2, log_nugget)
        g_delta, g_nugget, g_y = _nll_mucm_bwd(params, x, saved, nll, ct)
        g_y = g_y.reshape((-1,) + ctx.y_shape).sum(0)
        return (g_delta, torch.zeros_like(log_sigma2), g_nugget, None,
                g_y if ctx.needs_input_grad[4] else None, None, None)


def nll_mucm(params: GPParams, x, y, h, noise_diag=None,
             ladder: bool = True, family: str = "gaussian") -> torch.Tensor:
    """Concentrated (MUCM) negative log-likelihood; sigma^2 profiled out.

    Reference: `Optimize.loglikelihood_mucm`. The gaussian family without
    noise_diag takes the analytic adjoint (`_NllMucm`); other cases take
    autograd (`nll_mucm_ad`), as in the JAX package.
    """
    if noise_diag is None and family == "gaussian":
        return _NllMucm.apply(params.log_delta, params.log_sigma2,
                              params.log_nugget, x, y, h, ladder)
    return nll_mucm_ad(params, x, y, h, noise_diag, ladder, family)


def nll_gp4ml(params: GPParams, x, y, h, noise_diag=None,
              ladder: bool = True, family: str = "gaussian") -> torch.Tensor:
    """Full marginal NLL with explicit sigma^2 (beta profiled via GLS).

    Reference: `Optimize.loglikelihood_gp4ml`.
    """
    n = h.shape[0]
    (_, _, _, _, _, _, _, resid, logdet_a, _) = _common(
        params, x, y, h, noise_diag, ladder, family)
    s2 = params.sigma2
    nll = 0.5 * (resid / s2 + n * torch.log(s2) + logdet_a + n * _LOG2PI)
    return _guard(nll)


def nll(params: GPParams, x, y, h, *, mode: str = "mucm",
        noise_diag=None, ladder: bool = True,
        family: str = "gaussian") -> torch.Tensor:
    if mode == "mucm":
        return nll_mucm(params, x, y, h, noise_diag, ladder, family)
    if mode == "gp4ml":
        return nll_gp4ml(params, x, y, h, noise_diag, ladder, family)
    raise ValueError(f"unknown likelihood mode {mode!r}")


@fp32_exact
def fit(params: GPParams, x, y, h, *, mode: str = "mucm",
        noise_diag=None, family: str = "gaussian",
        refine: int = 0) -> FitState:
    """Build the posterior sufficient statistics at fixed hyperparameters.

    `family` is not stored in the fit state: pass the same family to
    predict()/validate() (the Emulator facade does this).

    `refine`: iterative-refinement sweeps on the A-solves for e and
    A^-1 H (`cho_solve_refined`). Each sweep forms the residual
    [y - H beta | H] - (A + jitter I) [e | A^-1 H] as an fp64 product (the
    card has fp64 units, so the JAX package's compensated-fp32 residual is
    not needed) and corrects through the fp64 factor of A + jitter I, so
    that for fp32 one sweep leaves the rounding of the fp32 result. beta,
    the factor and the NLL are those of the unrefined fit.
    """
    n, q = h.shape[0], h.shape[1]
    (a, l, jitter, white, linv_h, lg, beta, resid, logdet_a, logdet_g) = _common(
        params, x, y, h, noise_diag, True, family)
    if mode == "mucm":
        sigma2 = resid / (n - q - 2)
        nll_val = 0.5 * (n - q) * torch.log(sigma2) + 0.5 * logdet_a + 0.5 * logdet_g
    else:
        sigma2 = params.sigma2
        nll_val = 0.5 * (resid / sigma2 + n * torch.log(sigma2) + logdet_a
                         + n * _LOG2PI)
    # e = A^-1 (y - H beta) = L^-T (L^-1 y - L^-1 H beta), fused with the
    # A^-1 H backward solve (one multi-RHS solve)
    back = tri_solve_auto(l, torch.cat([white[:, None], linv_h], dim=1),
                          trans=True)
    if refine:
        # A_eff [e | A^-1 H] = [y - H beta | H], A_eff = a + jitter I (what
        # the factor factorizes), the right-hand side formed in fp64
        rt = torch.float64
        h_r = h.to(rt)
        rhs = torch.cat([(y.to(rt) - h_r @ beta.to(rt))[:, None], h_r], dim=1)
        back = cho_solve_refined(l, a, rhs, iters=refine, jitter=jitter,
                                 x=back)
    e = back[:, 0]
    ainv_h = back[:, 1:]
    return FitState(params, l, lg, beta, e, sigma2, ainv_h, jitter,
                    _guard(nll_val))


@fp32_exact
def _posterior_pieces(state: FitState, x, h, xstar, hstar,
                      family: str = "gaussian"):
    """Cross-correlation and whitened solves shared by mean/var paths."""
    c_star = corr(xstar, x, state.params, family)        # (m, n)
    mean = hstar @ state.beta + c_star @ state.e
    linv_t = tri_solve_auto(state.l, c_star.T)           # (n, m) = L^-1 t(x*)
    r = hstar - c_star @ state.ainv_h                    # (m, q) R(x*)
    lg_inv_r = tri_solve(state.lg, r.T)                  # (q, m)
    return c_star, mean, linv_t, r, lg_inv_r


@fp32_exact
def predict(state: FitState, x, h, xstar, hstar, *, full_cov: bool = False,
            include_nugget: bool = False, family: str = "gaussian"):
    """Universal-kriging posterior mean and (co)variance at xstar.

    Returns (mean (m,), var (m,) or cov (m, m)). In MUCM mode state.sigma2
    already carries the n-q-2 divisor, so `var` is the Student-t predictive
    variance with n-q degrees of freedom, matching the reference.
    """
    _, mean, linv_t, _, lg_inv_r = _posterior_pieces(
        state, x, h, xstar, hstar, family)
    if full_cov:
        c_ss = corr(xstar, xstar, state.params, family)
        if include_nugget:
            c_ss = c_ss + state.params.nugget * torch.eye(
                xstar.shape[0], dtype=c_ss.dtype, device=c_ss.device)
        cov = c_ss - linv_t.T @ linv_t + lg_inv_r.T @ lg_inv_r
        return mean, state.sigma2 * _sym(cov)
    prior_diag = 1.0 + (state.params.nugget if include_nugget else 0.0)
    var = (prior_diag - torch.sum(linv_t * linv_t, dim=0)
           + torch.sum(lg_inv_r * lg_inv_r, dim=0))
    return mean, state.sigma2 * torch.clamp(var, min=0.0)


class Predictor(NamedTuple):
    """Serving-path state: everything prediction needs, GEMM-only.

    W = L^-1 (one O(n^3) cost at fit time) turns the variance term
    t(x)^T A^-1 t(x) into the WHITENED quadratic |W t(x)|^2, a product plus
    a sum of squares that cannot cancel. The c @ A^-1 form cancels
    1/nugget-scale entries and carried O(100%) variance error at n=16384 in
    fp32 (docs/numerics.md), so the port keeps only the whitened form.
    """

    params: GPParams
    beta: torch.Tensor       # (q,)
    e: torch.Tensor          # (n,)
    linv: torch.Tensor       # (n, n) lower-triangular W = L^-1
    ainv_h_w: torch.Tensor   # (n, q) A^-1 H G^-1 (half of the R-term quadratic)
    ainv_h: torch.Tensor     # (n, q)
    w_chol: torch.Tensor     # (q, q) lower chol of G^-1
    sigma2: torch.Tensor


@fp32_exact
def predictor(state: FitState, x=None, h=None) -> Predictor:
    """Build the GEMM-only serving predictor from a fit state."""
    linv = torch.tril(tri_inverse(state.l))
    q = state.lg.shape[0]
    lg_inv = tri_solve(state.lg, torch.eye(q, dtype=state.lg.dtype,
                                           device=state.lg.device))
    w = lg_inv.T @ lg_inv                      # G^-1
    w_chol = cholesky_or_nan(_sym(w))
    return Predictor(state.params, state.beta, state.e, linv,
                     state.ainv_h @ w, state.ainv_h, w_chol, state.sigma2)


@fp32_exact
def predict_fast(pred: Predictor, x, xstar, hstar, *, include_nugget=False,
                 family: str = "gaussian", quad_precision: str = "highest"):
    """Batched posterior mean/var via products only (the "gemm" serving tier).

    The variance quadratic runs in whitened form |W c|^2 (see Predictor).
    quad_precision: "highest" or "high". torch has no 3-pass fp32 matmul,
    so both run exact fp32 here (TF32 off); "high" only grants the JAX
    package's looser error bound.
    """
    if quad_precision not in ("highest", "high"):
        raise ValueError(f"unknown quad_precision {quad_precision!r}")
    c_star = corr(xstar, x, pred.params, family)           # (m, n)
    mean = hstar @ pred.beta + c_star @ pred.e
    u = c_star @ pred.linv.T                               # (m, n) = (W c)^T
    quad_t = torch.sum(u * u, dim=1)
    r = hstar - c_star @ pred.ainv_h                       # (m, q)
    rw = r @ pred.w_chol                                   # (m, q)
    quad_r = torch.sum(rw * rw, dim=1)
    prior = 1.0 + (pred.params.nugget if include_nugget else 0.0)
    var = pred.sigma2 * torch.clamp(prior - quad_t + quad_r, min=0.0)
    return mean, var


def predict_batched(pred: Predictor, x, xstar, hstar, *, batch: int = 65536,
                    include_nugget: bool = False, family: str = "gaussian",
                    quad_precision: str = "highest"):
    """predict_fast over query chunks: bounds peak memory at O(batch * n).

    A host loop over chunks, where the JAX package runs lax.map.
    """
    m = xstar.shape[0]
    if m <= batch:
        return predict_fast(pred, x, xstar, hstar,
                            include_nugget=include_nugget, family=family,
                            quad_precision=quad_precision)
    means, variances = [], []
    for s in range(0, m, batch):
        mean, var = predict_fast(pred, x, xstar[s:s + batch],
                                 hstar[s:s + batch],
                                 include_nugget=include_nugget, family=family,
                                 quad_precision=quad_precision)
        means.append(mean)
        variances.append(var)
    return torch.cat(means), torch.cat(variances)


@fp32_exact
def sample_posterior_from_draws(mean, cov, dof: int, z, g=None, *,
                                student_t: bool = True):
    """The deterministic half of `sample_posterior`: mean (m,), cov (m, m)
    the predictive covariance, z (n_draws, m) standard normals, g
    (n_draws, 1) chi-square draws with dof degrees of freedom (unused when
    student_t is False). Returns (n_draws, m)."""
    scale = cov * ((dof - 2.0) / dof) if student_t else cov
    ls, _ = cholesky_with_jitter(scale)
    colored = z @ ls.T
    if student_t:
        colored = torch.sqrt(dof / g) * colored
    return mean[None, :] + colored


@fp32_exact
def sample_posterior(generator: torch.Generator, state: FitState, x, h,
                     xstar, hstar, n_draws: int = 1, *,
                     include_nugget: bool = False, student_t: bool = True,
                     family: str = "gaussian"):
    """Joint draws from the predictive distribution at xstar, shape (n_draws, m).

    MUCM-mode fits have a multivariate Student-t predictive with dof = n - q
    (SURVEY.md S7 'Student-t posterior with n-q dof'); draws use the scale-
    mixture form  y* = mean + sqrt(dof/g) * Ls z,  z ~ N(0, I),
    g ~ chi^2_dof, with Ls the Cholesky (with the jitter ladder) of the t
    *scale* matrix Sigma_scale = cov * (dof-2)/dof (predict() returns the t
    covariance, which already carries the n-q-2 divisor through
    state.sigma2). `student_t=False` gives plain Gaussian draws (gp4ml-mode
    fits). z and g come from `generator`, on the state's device.
    """
    n, q = state.l.shape[0], state.lg.shape[0]
    dof = n - q
    if student_t and dof <= 2:
        raise ValueError(
            f"student_t draws need n - q > 2 (got n={n}, q={q}: the t scale "
            "matrix (dof-2)/dof * cov would be non-positive). Pass "
            "student_t=False (gp4ml-mode Gaussian draws) or add data."
        )
    mean, cov = predict(
        state, x, h, xstar, hstar, full_cov=True,
        include_nugget=include_nugget, family=family,
    )
    kw = dict(dtype=mean.dtype, device=mean.device)
    z = torch.randn((n_draws, mean.shape[0]), generator=generator, **kw)
    g = None
    if student_t:
        g = 2.0 * torch._standard_gamma(
            torch.full((n_draws, 1), 0.5 * dof, **kw), generator=generator)
    return sample_posterior_from_draws(mean, cov, dof, z, g,
                                       student_t=student_t)


@fp32_exact
def validate(state: FitState, x, h, xv, hv, yv, family: str = "gaussian"):
    """Held-out validation diagnostics (reference `Posterior` diagnostics).

    Returns dict with standardized errors, Mahalanobis distance and its
    theoretical mean/sd under the Student-t reference distribution.
    """
    mean, cov = predict(state, x, h, xv, hv, full_cov=True,
                        include_nugget=True, family=family)
    err = yv - mean
    sd = torch.sqrt(torch.clamp(torch.diagonal(cov), min=1e-30))
    lv, _ = cholesky_with_jitter(cov)
    white = tri_solve(lv, err[:, None])[:, 0]
    mahal = torch.sum(white * white)
    n, q = h.shape[0], h.shape[1]
    nv = yv.shape[0]
    denom = max(n - q - 4, 1)
    mahal_var = 2.0 * nv * (nv + n - q - 2) / denom
    return {
        "mean": mean,
        "std_err": err / sd,
        "mahalanobis": mahal,
        "mahalanobis_mean": torch.tensor(float(nv), dtype=mean.dtype,
                                         device=mean.device),
        "mahalanobis_sd": torch.sqrt(torch.tensor(mahal_var, dtype=mean.dtype,
                                                  device=mean.device)),
    }


@fp32_exact
def loo_diagnostics(state: FitState, x, h, y):
    """Leave-one-out cross-validation means/variances from one factorization.

    Closed-form LOO identities on K = sigma2 * A (beta held at the
    full-data GLS estimate):
      mu_i = y_i - [K^-1 (y - H beta)]_i / [K^-1]_ii,   v_i = 1 / [K^-1]_ii
    """
    linv = tri_inverse(state.l)
    kinv_diag = torch.sum(linv * linv, dim=0) / state.sigma2
    kinv_resid = state.e / state.sigma2
    loo_mean = y - kinv_resid / kinv_diag
    loo_var = 1.0 / kinv_diag
    return loo_mean, loo_var
