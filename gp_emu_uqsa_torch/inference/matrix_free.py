"""Matrix-free MLE: BBMM-style training past the Cholesky memory wall.

Port of `gp_emu_uqsa_tpu.inference.matrix_free`. It completes the iterative
stack (ops/cg.py solves, ops/slq.py logdets) with the concentrated (MUCM)
NLL and its gradient, computed from kernel matvecs only: A is never
materialized. This is the GPyTorch "blackbox matrix-matrix inference"
recipe (PAPERS.md).

Estimator structure (mirrors gp.py::_nll_mucm_bwd's exact adjoint):

  dNLL/dA = W = 1/2 A^-1 - 1/2 C C^T - c e e^T
      C = (A^-1 H) Lg^-T,  c = (n-q)/(2 resid),  e = A^-1 (y - H beta)

  * the LOW-RANK part of W (C, e from CG solves) is contracted against
    dA/dtheta EXACTLY in one chunked O(n^2 (q + d)) pass;
  * the 1/2 A^-1 part needs tr(A^-1 dA/dtheta): Hutchinson probes Z with
    CG solves W_z = A^-1 Z, contracted in the same pass;
  * log|A| for the value: SLQ on the same matvec.

On the card every CG iteration and every Lanczos step is one K3 launch
(ops/cg.py), and every (chunk, n) block of the gradient pass is built by
K2 (`kernels.corr`, chunk >= 256, fp32). The pass sums
sum_ij M_ij (x_il - x_jl)^2 over exact differences
(`kernels.sq_diff_contraction`), where the JAX package expands it as
t1 - 2 quad, whose two terms cancel in fp32 (ROADMAP.md "Facts").

Each evaluation is split into its draws (`matrix_free_probes`: the CG's
Rademacher probes (n, p) and the SLQ's (p, n), from a `torch.Generator`)
and a deterministic part that takes them (`nll_and_grad_from_probes`),
so the JAX package's own draws can be fed in. Gradients are stochastic
(probe noise ~1/sqrt(p)); `mle_fit_matrix_free` fixes the probes per fit
(sample-average approximation) so Adam sees a smooth deterministic
objective.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from gp_emu_uqsa_torch.kernels import GPParams, corr, sq_diff_contraction
from gp_emu_uqsa_torch.ops.cg import (
    cg_solve, make_corr_matvec, pivoted_cholesky, woodbury_ops,
)
from gp_emu_uqsa_torch.ops.precision import fp32_exact
from gp_emu_uqsa_torch.ops.slq import (
    rademacher, slq_logdet_from_probes, slq_logdet_preconditioned_from_probes,
)

# optax.adam's defaults (optax 0.2.6): b1, b2, eps, eps_root 0
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class MFConfig:
    num_probes: int = 16
    lanczos_k: int = 32
    cg_tol: float = 1e-8
    cg_maxiter: int = 512
    chunk: int = 1024
    precond_rank: int = 0        # >0: pivoted-Cholesky PCG (ops/cg.py)


def matrix_free_probes(generator: torch.Generator, n: int, cfg: MFConfig,
                       dtype=torch.float64):
    """(z (n, p), z_slq (p, n)): the Hutchinson probes solved with the CG
    and the SLQ's, Rademacher, drawn in this order on the generator's
    device (the JAX package's split of the key into kz, kl)."""
    z = rademacher(generator, (n, cfg.num_probes), dtype)
    z_slq = rademacher(generator, (cfg.num_probes, n), dtype)
    return z, z_slq


def nll_and_grad_matrix_free(params: GPParams, x, y, h,
                             generator: torch.Generator,
                             cfg: MFConfig = MFConfig()):
    """Concentrated NLL estimate + stochastic gradient, matrix-free.

    Draws the probes from `generator` (on x's device) and returns
    `nll_and_grad_from_probes` of them.
    """
    probes = matrix_free_probes(generator, x.shape[0], cfg, x.dtype)
    return nll_and_grad_from_probes(params, x, y, h, probes, cfg)


@fp32_exact
def nll_and_grad_from_probes(params: GPParams, x, y, h, probes,
                             cfg: MFConfig = MFConfig()):
    """The deterministic part of `nll_and_grad_matrix_free`.

    probes = (z (n, p), z_slq (p, n)). Returns (nll, GPParams cotangents
    for (log_delta, log_sigma2=0, log_nugget), aux dict). Cost: one batched
    CG over q + 1 + p right-hand sides, p Lanczos runs in lockstep, and one
    chunked O(n^2 (q + d + p)) contraction pass.
    """
    z, z_slq = probes
    n, q = h.shape
    p = z.shape[1]
    matvec = make_corr_matvec(x, params, chunk=cfg.chunk)

    # ---- solves: A^-1 [y | H | Z] in ONE batched CG ----------------------
    rhs = torch.cat([y[:, None], h, z], dim=1)
    wops = None
    precond = None
    if cfg.precond_rank > 0:
        l_piv, _ = pivoted_cholesky(x, params, cfg.precond_rank)
        wops = woodbury_ops(l_piv, params.nugget.expand(n))
        precond = wops["apply_minv"]
    sol, cg_info = cg_solve(matvec, rhs, tol=cfg.cg_tol,
                            maxiter=cfg.cg_maxiter, precond=precond)
    ainv_y, ainv_h, wz = sol[:, 0], sol[:, 1: 1 + q], sol[:, 1 + q:]

    g = h.T @ ainv_h
    g = 0.5 * (g + g.T)
    lg = torch.linalg.cholesky(g)
    beta = torch.linalg.solve(g, h.T @ ainv_y)
    e = ainv_y - ainv_h @ beta
    resid = torch.clamp(y @ e, min=1e-30)
    sigma2 = resid / (n - q - 2)

    # ---- value: SLQ logdet (operator-preconditioned when PCG is on) -------
    if wops is not None:
        logdet_a = slq_logdet_preconditioned_from_probes(
            matvec, wops, z_slq, k=cfg.lanczos_k)
    else:
        logdet_a = slq_logdet_from_probes(matvec, z_slq, k=cfg.lanczos_k)
    logdet_g = 2.0 * torch.sum(torch.log(torch.clamp(torch.diagonal(lg),
                                                     min=1e-30)))
    nll = 0.5 * (n - q) * torch.log(sigma2) + 0.5 * logdet_a + 0.5 * logdet_g

    # ---- gradient: one chunked contraction pass ---------------------------
    # C = (A^-1 H) Lg^-T, so C C^T = (A^-1 H) G^-1 (A^-1 H)^T
    c_mat = torch.linalg.solve_triangular(lg, ainv_h.T, upper=False).T
    c_coef = (n - q) / (2.0 * resid)
    # the chunk's rows of W' = -1/2 C C^T - c e e^T + (1/2p) W_z Z^T (the
    # Hutchinson estimate of 1/2 A^-1, rank p, never formed) as one product
    left = torch.cat([c_mat, e[:, None], wz], dim=1)           # (n, q+1+p)
    right = torch.cat([-0.5 * c_mat, -c_coef * e[:, None],
                       (0.5 / p) * z], dim=1)                 # (n, q+1+p)
    grad_log_delta = _grad_log_delta(params, x, left, right, cfg.chunk)

    # nugget: nugget * tr(W); tr(A^-1) by Hutchinson, low-rank traces exact
    tr_ainv = torch.sum(z * wz) / p
    tr_w = (0.5 * tr_ainv - 0.5 * torch.sum(c_mat * c_mat)
            - c_coef * torch.sum(e * e))
    grad_log_nugget = params.nugget * tr_w

    grads = GPParams(grad_log_delta, torch.zeros_like(params.log_sigma2),
                     grad_log_nugget)
    aux = {"sigma2": sigma2, "beta": beta, "e": e, "resid": resid,
           "logdet_a": logdet_a, "cg_info": cg_info}
    return nll, grads, aux


@fp32_exact
def _grad_log_delta(params: GPParams, x, left, right, chunk: int):
    """d NLL / d log delta_l = (2 / delta_l^2) sum_ij M_ij (x_il - x_jl)^2,
    M = A o (left right^T), one (chunk, n) block of rows at a time: the
    block of A by `kernels.corr` (K2 on the card) and the sum over exact
    differences (`kernels.sq_diff_contraction`)."""
    contraction = torch.zeros_like(params.log_delta)
    for i in range(0, x.shape[0], chunk):
        x_c = x[i:i + chunk]
        m_c = corr(x_c, x, params) * (left[i:i + chunk] @ right.T)
        contraction = contraction + sq_diff_contraction(m_c, x_c, x)
    return (2.0 / torch.exp(2.0 * params.log_delta)) * contraction


def mle_fit_matrix_free(generator: torch.Generator, x, y, h, *,
                        steps: int = 150, learning_rate: float = 0.05,
                        init: GPParams | None = None,
                        train_nugget: bool = True,
                        min_nugget: float = 1e-5,
                        delta_bounds: tuple = (1e-3, 1e3),
                        cfg: MFConfig = MFConfig()):
    """Adam on the matrix-free concentrated NLL (SAA: probes fixed per fit).

    For n where gp.fit/mle_fit are feasible prefer those (exact, faster);
    this is the path for n past the factorization wall. Draws the probes
    once from `generator` (on x's device) and returns
    `mle_fit_from_probes` of them: (GPParams, {"nll_trace": (steps,)}).
    Initialize from a subset MLE (mle_fit on a few thousand points) when
    possible.
    """
    probes = matrix_free_probes(generator, x.shape[0], cfg, x.dtype)
    return mle_fit_from_probes(
        probes, x, y, h, steps=steps, learning_rate=learning_rate,
        init=init, train_nugget=train_nugget, min_nugget=min_nugget,
        delta_bounds=delta_bounds, cfg=cfg)


@fp32_exact
def mle_fit_from_probes(probes, x, y, h, *, steps: int = 150,
                        learning_rate: float = 0.05,
                        init: GPParams | None = None,
                        train_nugget: bool = True,
                        min_nugget: float = 1e-5,
                        delta_bounds: tuple = (1e-3, 1e3),
                        cfg: MFConfig = MFConfig()):
    """The deterministic part of `mle_fit_matrix_free`: Adam from the probes.

    `optax.adam(learning_rate)` step for step (b1 0.9, b2 0.999, eps 1e-8,
    bias-corrected, eps_root 0), one `nll_and_grad_from_probes` a step.
    Iterates are PROJECTED into [min_nugget, inf) x delta_bounds after
    every update: CG/SLQ need the conditioning the nugget provides, and an
    unconstrained step into a tiny nugget stalls CG, corrupts the gradient
    estimate and sends the optimizer off the rails. The NLL trace stays on
    the device.
    """
    d = x.shape[1]
    dtype, dev = x.dtype, x.device
    if init is None:
        init = GPParams(torch.zeros(d, dtype=dtype, device=dev),
                        torch.zeros((), dtype=dtype, device=dev),
                        torch.full((), math.log(1e-4), dtype=dtype,
                                   device=dev))
    lo_d = math.log(delta_bounds[0])
    hi_d = math.log(delta_bounds[1])
    lo_n = math.log(min_nugget)

    def project(pp):
        return GPParams(torch.clamp(pp.log_delta, lo_d, hi_d), pp.log_sigma2,
                        torch.clamp(pp.log_nugget, min=lo_n))

    p = project(GPParams(*(torch.as_tensor(v, dtype=dtype, device=dev)
                           for v in init)))
    mu = [torch.zeros_like(v) for v in p]
    nu = [torch.zeros_like(v) for v in p]
    trace = torch.empty((steps,), dtype=dtype, device=dev)
    for t in range(1, steps + 1):
        nll, grads, _ = nll_and_grad_from_probes(p, x, y, h, probes, cfg)
        if not train_nugget:
            grads = GPParams(grads.log_delta,
                             torch.zeros_like(grads.log_sigma2),
                             torch.zeros_like(grads.log_nugget))
        new = []
        for i, (v, g) in enumerate(zip(p, grads)):
            mu[i] = (1 - ADAM_B1) * g + ADAM_B1 * mu[i]
            nu[i] = (1 - ADAM_B2) * g ** 2 + ADAM_B2 * nu[i]
            mu_hat = mu[i] / (1 - ADAM_B1 ** t)
            nu_hat = nu[i] / (1 - ADAM_B2 ** t)
            new.append(v + (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
                       * -learning_rate)
        p = project(GPParams(*new))
        trace[t - 1] = nll
    return p, {"nll_trace": trace}
