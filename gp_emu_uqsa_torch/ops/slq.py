"""Stochastic Lanczos quadrature: matrix-free log-determinants.

Port of `gp_emu_uqsa_tpu.ops.slq`. The concentrated NLL needs log|A|, which
the CG path (ops/cg.py) cannot give. SLQ estimates

    log|A| = tr(log A) ~= (n/p) sum_z  e1^T log(T_z) e1 * ||z||^2/n

with T_z the k-step Lanczos tridiagonalization of A started at probe z:
each probe costs k matvecs plus an eigh of a k x k tridiagonal. Rademacher
probes, full reorthogonalization.

The JAX package runs one Lanczos per probe under `vmap`; here the p probes
run in lockstep as the columns of one (n, p) block, so each step is one
matvec with p right-hand sides (K3 with r = p on the card) and the two
reorthogonalization passes are batched products. Breakdown, the `alive`
flag and the padding are kept per probe. The loop is a host loop of k
steps with no host read.

The probes come from a `torch.Generator` (`rademacher`); the estimators'
deterministic halves (`slq_logdet_from_probes`,
`slq_logdet_preconditioned_from_probes`) take them, so the same probes as
the JAX package's `jax.random.rademacher` can be fed in.
"""
from __future__ import annotations

import torch

from gp_emu_uqsa_torch.ops.precision import fp32_exact


def rademacher(generator: torch.Generator, shape, dtype=torch.float64):
    """+-1 entries of `shape` in `dtype`, drawn on the generator's device."""
    bits = torch.randint(0, 2, shape, generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


@fp32_exact
def lanczos(matvec, v0, k: int):
    """k-step Lanczos with full reorthogonalization, probes in lockstep.

    v0: (n,) or (n, p), one start a column. Returns (alphas (k,), betas
    (k-1,), q_basis (k, n)) for a vector start, and (alphas (p, k), betas
    (p, k-1), q_basis (p, k, n)) for p columns. Breakdown (an invariant
    subspace hit early) zeroes that probe's beta and pads the rest of its
    diagonal with 1.0: the padded block decouples from e1, so the
    quadrature weights of its spurious eigenpairs vanish and log(1) = 0.
    """
    squeeze = v0.ndim == 1
    v = (v0[:, None] if squeeze else v0).T             # (p, n)
    p, n = v.shape
    dtype, dev = v.dtype, v.device
    eps = 1e-12 if dtype == torch.float64 else 1e-6
    qs = torch.zeros((p, k, n), dtype=dtype, device=dev)
    qs[:, 0] = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    alphas = torch.ones((p, k), dtype=dtype, device=dev)   # padding: log 1 = 0
    betas = torch.zeros((p, k), dtype=dtype, device=dev)   # couples j -> j+1
    alive = torch.ones((p,), dtype=torch.bool, device=dev)
    for j in range(k):
        q = qs[:, j]                                   # (p, n)
        w = matvec(q.T).T
        alpha = torch.sum(q * w, dim=1)
        w = w - alpha[:, None] * q
        # full reorthogonalization: rows >= j+1 of each basis are zero, so
        # the full-basis projection is exact for the first j+1 vectors;
        # twice is enough (Parlett)
        for _ in range(2):
            w = w - torch.bmm(qs.mT, torch.bmm(qs, w[:, :, None]))[:, :, 0]
        beta = torch.linalg.vector_norm(w, dim=1)
        ok = alive & (beta > eps)
        alphas[:, j] = torch.where(alive, alpha, torch.ones_like(alpha))
        betas[:, j] = torch.where(ok, beta, torch.zeros_like(beta))
        if j + 1 < k:
            qs[:, j + 1] = torch.where(
                ok[:, None], w / torch.clamp(beta, min=eps)[:, None],
                torch.zeros_like(w))
        alive = ok
    betas = betas[:, : k - 1]
    if squeeze:
        return alphas[0], betas[0], qs[0]
    return alphas, betas, qs


def _logdet_quadrature(alphas, betas, znorm2):
    """e1-weighted Gauss quadrature of log on each Lanczos tridiagonal:
    alphas (..., k), betas (..., k-1), znorm2 (...)."""
    t = (torch.diag_embed(alphas) + torch.diag_embed(betas, 1)
         + torch.diag_embed(betas, -1))
    lam, u = torch.linalg.eigh(t)
    w1 = u[..., 0, :] ** 2
    lam_safe = torch.clamp(lam, min=1e-30)
    return znorm2 * torch.sum(w1 * torch.log(lam_safe), dim=-1)


@fp32_exact
def slq_logdet_from_probes(matvec, z, *, k: int = 32):
    """log|A| estimated from the probes z (p, n), one a row."""
    alphas, betas, _ = lanczos(matvec, z.T, k)
    return torch.mean(_logdet_quadrature(alphas, betas,
                                         torch.sum(z * z, dim=1)))


def slq_logdet(matvec, n: int, generator: torch.Generator, *,
               num_probes: int = 16, k: int = 32, dtype=torch.float64):
    """Estimate log|A| for SPD A given only matvecs.

    Standard error scales ~ 1/sqrt(num_probes); k bounds the quadrature
    bias (k = 32 is ample for nugget-regularized correlation matrices).
    The probes are drawn from `generator`, on its device.
    """
    z = rademacher(generator, (num_probes, n), dtype)
    return slq_logdet_from_probes(matvec, z, k=k)


@fp32_exact
def slq_logdet_preconditioned_from_probes(matvec, wops: dict, z, *,
                                          k: int = 32):
    """log|M| + the SLQ estimate of log|B^-1 A B^-T| from the probes z."""
    binv, binv_t = wops["apply_binv"], wops["apply_binv_t"]

    def mv_bar(v):
        return binv(matvec(binv_t(v)))

    return wops["logdet_m"] + slq_logdet_from_probes(mv_bar, z, k=k)


def slq_logdet_preconditioned(matvec, wops: dict, n: int,
                              generator: torch.Generator, *,
                              num_probes: int = 16, k: int = 32,
                              dtype=torch.float64):
    """log|A| = log|M| (exact) + SLQ estimate of log|B^-1 A B^-T|.

    wops comes from ops.cg.woodbury_ops on a pivoted-Cholesky
    preconditioner M = L L^T + shift I with B B^T = M. The residual
    operator B^-1 A B^-T has its dominant spectrum compressed toward 1, so
    both the Lanczos quadrature bias (small k suffices) and the probe
    variance drop sharply against plain SLQ at small nuggets.
    """
    z = rademacher(generator, (num_probes, n), dtype)
    return slq_logdet_preconditioned_from_probes(matvec, wops, z, k=k)
