"""Matrix-free kernel matvecs and batched conjugate gradients.

Port of `gp_emu_uqsa_tpu.ops.cg` (GPyTorch-style "blackbox matrix-matrix"
inference, PAPERS.md). A v needs the correlation of X with itself only
through its product with v, never as an (n, n) matrix: at n = 131072 the
fp32 A alone is 64 GiB, and its Cholesky factor another 64 GiB, past one
80 GB H100, while the matvec needs O(n r) memory. With batched CG it gives
A^-1 B without a factorization, so the GLS estimate and the serving weights
reach past the Cholesky wall.

On the card, for fp32 inputs with d <= 20, the matvec is kernel K3
(`ops.serve.corr_matvec`, the port of `corr_matvec_pallas`) with x as both
sides: one launch over all n rows for up to MAX_RHS right-hand sides (wider
blocks go in slabs). K3 tiles n for itself and ignores `chunk`. Every other
case (fp64, the CPU, d > 20) takes the chunked plain path: `chunk` rows of
`kernels.gaussian_corr` at a time, then a product.

The JAX package runs CG as one compiled `lax.while_loop`; here it is a host
loop whose stop test is one host sync an iteration, counted in
`info["host_syncs"]`. The pivoted Cholesky keeps its pivot on the device.
`ops/slq.py` and `inference/matrix_free.py` build on these.
"""
from __future__ import annotations

import functools

import torch

from gp_emu_uqsa_torch.kernels import GPParams, gaussian_corr
from gp_emu_uqsa_torch.ops.kernel_matrix import MAX_D
from gp_emu_uqsa_torch.ops.precision import fp32_exact, fp32_exact_matmul
from gp_emu_uqsa_torch.ops.serve import MAX_RHS, corr_matvec


def _on_columns(fn, work_dtype=None):
    """fn on (n, k) blocks, applied to (n,) or (n, k), with TF32 off; fed
    `work_dtype` when given, and returned in v's dtype."""

    @functools.wraps(fn)
    def wrapped(v):
        with fp32_exact_matmul():
            vv = v[:, None] if v.ndim == 1 else v
            out = fn(vv if work_dtype is None else vv.to(work_dtype))
            out = out.to(v.dtype)
            return out[:, 0] if v.ndim == 1 else out

    return wrapped


def _wide(t: torch.Tensor) -> torch.Tensor:
    """fp32 as fp64: the precision of the preconditioner's algebra."""
    return t.double() if t.dtype == torch.float32 else t


def _k3_ok(*xs: torch.Tensor) -> bool:
    """Whether c(x1, x2) @ v takes K3: fp32 inputs on the card, d <= MAX_D."""
    return all(x.is_cuda and x.dtype == torch.float32 and x.ndim == 2
               and x.shape[1] <= MAX_D for x in xs)


@fp32_exact
def corr_times_chunked(x1, x2, params: GPParams, v, chunk: int = 4096):
    """c(x1, x2) @ v for v (n2, k), `chunk` rows of x1 at a time (plain)."""
    return torch.cat([gaussian_corr(x1[i:i + chunk], x2, params) @ v
                      for i in range(0, x1.shape[0], chunk)])


def corr_times(x1, x2, params: GPParams, v, chunk: int = 4096):
    """c(x1, x2) @ v for v (n2, k): K3 where `_k3_ok`, one launch a slab of
    MAX_RHS columns; the chunked plain path elsewhere."""
    if not _k3_ok(x1, x2):
        return corr_times_chunked(x1, x2, params, v, chunk)
    delta = params.delta
    return torch.cat([corr_matvec(x1, x2, delta, v[:, s:s + MAX_RHS])
                      for s in range(0, v.shape[1], MAX_RHS)], dim=1)


def make_corr_matvec(x, params: GPParams, *, noise_diag=None,
                     chunk: int = 4096):
    """Matvec closure v -> (c(x, x) + (nugget + noise) I) v, O(n r) memory.

    v may be (n,) or (n, k). K3 on the card (one launch over all n rows a
    slab of up to MAX_RHS columns; `chunk` unused), `chunk` rows of the
    plain build at a time elsewhere.
    """
    nugget = params.nugget
    shift = nugget if noise_diag is None else nugget + torch.as_tensor(
        noise_diag, dtype=x.dtype, device=x.device)
    shift = shift[:, None] if shift.ndim else shift

    @_on_columns
    def matvec(v):
        return corr_times(x, x, params, v, chunk) + shift * v

    return matvec


@fp32_exact
def cg_solve(matvec, b, *, tol: float = 1e-6, maxiter: int = 256,
             precond=None):
    """Batched (preconditioned) conjugate gradients, column-independent.

    b: (n,) or (n, k). `precond`, if given, applies M^-1 (e.g. from
    `pivoted_chol_precond`). Every column iterates until all columns'
    relative residuals are below tol, or maxiter, as in the JAX loop.
    Returns (x, info) with info = {"iters", "rel_resid" (k,), "host_syncs"}:
    the stop test reads the residuals on the host once an iteration.
    """
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b
    bnorm = torch.clamp(torch.linalg.vector_norm(bb, dim=0), min=1e-30)
    apply_m = precond if precond is not None else (lambda v: v)

    x = torch.zeros_like(bb)
    r = bb.clone()                 # b - A x0 with x0 = 0, bit for bit
    z = apply_m(r)
    p = z
    rz = torch.sum(r * z, dim=0)
    rs = torch.sum(r * r, dim=0)
    iters = syncs = 0
    while iters < maxiter:
        syncs += 1
        if not bool(torch.any(torch.sqrt(rs) / bnorm > tol)):
            break
        ap = matvec(p)
        denom = torch.sum(p * ap, dim=0)
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=1e-30),
                            torch.zeros_like(denom))
        x = x + alpha * p
        r = r - alpha * ap
        z = apply_m(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
        rs = torch.sum(r * r, dim=0)
        iters += 1
    info = {"iters": iters, "rel_resid": torch.sqrt(rs) / bnorm,
            "host_syncs": syncs}
    return (x[:, 0] if squeeze else x), info


@fp32_exact
def pivoted_cholesky(x, params: GPParams, rank: int):
    """Rank-r pivoted (partial) Cholesky of the correlation matrix.

    Greedy max-residual-diagonal pivoting; each step builds one correlation
    COLUMN, (n, 1), which is below K2's 256-row gate and runs the plain
    build: O(n r (d + r)) in all, no n^2 object. The pivot stays on the
    device (no host read). Returns (l (n, rank), pivots (rank,) int32), the
    GPyTorch preconditioner construction for CG on kernel systems. fp32
    inputs are factored in fp64 (the residual diagonal 1 - sum l^2 cancels
    to 1e-6 and below) and l is returned in fp32.
    """
    dtype = x.dtype
    x = _wide(x)
    params = GPParams(*(_wide(v) for v in params))
    n = x.shape[0]
    l = torch.zeros((n, rank), dtype=x.dtype, device=x.device)
    diag_res = torch.ones((n,), dtype=x.dtype, device=x.device)  # c(x_i, x_i)
    pivots = []
    for j in range(rank):
        i_star = torch.argmax(diag_res).reshape(1)
        col = gaussian_corr(x, x.index_select(0, i_star), params)[:, 0]
        proj = l @ l.index_select(0, i_star)[0]
        d_star = torch.clamp(diag_res.index_select(0, i_star), min=1e-30)
        l_new = (col - proj) / torch.sqrt(d_star)
        l[:, j] = l_new
        # numerically clean: the pivot row of the residual must vanish
        diag_res = torch.clamp(diag_res - l_new * l_new, min=0.0)
        diag_res = diag_res.index_fill(0, i_star, 0.0)
        pivots.append(i_star)
    if not pivots:
        return l.to(dtype), torch.zeros((0,), dtype=torch.int32,
                                        device=x.device)
    return l.to(dtype), torch.cat(pivots).to(torch.int32)


@fp32_exact
def woodbury_ops(l, d):
    """Factored operators for M = L L^T + diag(d) (preconditioner algebra).

    Writing M = D^1/2 (I + W W^T) D^1/2 with W = D^-1/2 L, and
    W^T W = V diag(s) V^T (r x r eigh), any power of (I + W W^T) is
    I + W V diag((1+s)^a - 1)/s V^T W^T, the identity off range(W). Returns:

      apply_minv(v)   : M^-1 v                      (Woodbury)
      apply_binv(v)   : B^-1 v,  B = D^1/2 (I+WW^T)^1/2  (so B B^T = M)
      apply_binv_t(v) : B^-T v
      logdet_m        : log|M| = sum log d + sum log(1+s)

    B^-1 A B^-T is SPD and similar to M^-1 A, the operator preconditioned
    SLQ runs Lanczos on. All applies are O(n r).

    For fp32 l the algebra runs in fp64 and each apply returns its input's
    dtype: with d the nugget, s reaches n / nugget (1e8 and more), and
    the applies subtract from v its component in range(W) up to a factor
    1/s, which fp32 rounds away (the JAX package computes in l's dtype).
    """
    dtype = l.dtype
    l = _wide(l)
    d = _wide(torch.as_tensor(d, device=l.device)).to(l.dtype)
    sqrt_d = torch.sqrt(d)[:, None]
    w = l / sqrt_d
    s, v = torch.linalg.eigh(w.T @ w)                  # (r,), (r, r)
    s = torch.clamp(s, min=0.0)
    logdet_m = torch.sum(torch.log(d)) + torch.sum(torch.log1p(s))

    def _pow_apply(vv, a):
        # (I + W W^T)^a vv
        coef = (torch.pow(1.0 + s, a) - 1.0) / torch.clamp(s, min=1e-30)
        t = v.T @ (w.T @ vv)                           # (r, k)
        return vv + w @ (v @ (coef[:, None] * t))

    def apply_minv(u):
        return _pow_apply(u / sqrt_d, -1.0) / sqrt_d

    def apply_binv(u):
        return _pow_apply(u / sqrt_d, -0.5)

    def apply_binv_t(u):
        return _pow_apply(u, -0.5) / sqrt_d

    return {"apply_minv": _on_columns(apply_minv, l.dtype),
            "apply_binv": _on_columns(apply_binv, l.dtype),
            "apply_binv_t": _on_columns(apply_binv_t, l.dtype),
            "logdet_m": logdet_m.to(dtype)}


@fp32_exact
def pivoted_chol_precond(x, params: GPParams, rank: int = 64,
                         *, noise_diag=None):
    """M^-1 closure for cg_solve, M = L_r L_r^T + (nugget + noise) I.

    Woodbury: M^-1 v = D^-1 v - D^-1 L (I + L^T D^-1 L)^-1 L^T D^-1 v
    with D the diagonal shift; O(n r) per apply after an O(n r^2) setup.
    fp32 inputs take fp64 algebra, as in `woodbury_ops`.
    """
    l, _ = pivoted_cholesky(x, params, rank)
    l = _wide(l)
    n = l.shape[0]
    d = _wide(params.nugget)
    if noise_diag is not None:
        d = d + torch.as_tensor(noise_diag, dtype=l.dtype, device=l.device)
    d = torch.broadcast_to(d, (n,))[:, None]
    dinv_l = l / d                                            # (n, r)
    small = torch.eye(rank, dtype=l.dtype, device=l.device) + l.T @ dinv_l
    small_chol = torch.linalg.cholesky(small)

    def apply_m(vv):
        t = torch.cholesky_solve(dinv_l.T @ vv, small_chol)   # (r, k)
        return vv / d - dinv_l @ t

    return _on_columns(apply_m, l.dtype)


@fp32_exact
def fit_matrix_free(params: GPParams, x, y, h, *, noise_diag=None,
                    chunk: int = 4096, tol: float = 1e-6, maxiter: int = 512,
                    precond_rank: int = 0):
    """Factorization-free GP 'fit' at fixed hyperparameters.

    Computes by CG: A^-1 [y | H], the GLS beta, the serving weights
    e = A^-1 (y - H beta) and the MUCM sigma2-hat, everything the
    mean-serving path needs, with A never materialized. No logdet, so no
    NLL: use the factorized paths (gp.fit, mle_fit) or `inference.
    matrix_free` to CHOOSE hyperparameters, this to APPLY them past the
    Cholesky wall. The default tol is the JAX package's; an fp32 K3 matvec
    (about 5e-6 from its plain version) may not reach it, and CG then runs
    to maxiter: read info["rel_resid"].

    Returns dict(beta, e, sigma2, g, info, ainv_h).
    """
    n, q = h.shape
    matvec = make_corr_matvec(x, params, noise_diag=noise_diag, chunk=chunk)
    rhs = torch.cat([y[:, None], h], dim=1)
    precond = (pivoted_chol_precond(x, params, rank=precond_rank,
                                    noise_diag=noise_diag)
               if precond_rank > 0 else None)
    sol, info = cg_solve(matvec, rhs, tol=tol, maxiter=maxiter,
                         precond=precond)
    ainv_y, ainv_h = sol[:, 0], sol[:, 1:]
    g = h.T @ ainv_h
    g = 0.5 * (g + g.T)
    beta = torch.linalg.solve(g, h.T @ ainv_y)
    e = ainv_y - ainv_h @ beta
    resid = torch.clamp(y @ e, min=0.0)     # y^T A^-1 (y - H beta) = e-form
    sigma2 = resid / (n - q - 2)
    return {"beta": beta, "e": e, "sigma2": sigma2, "g": g, "info": info,
            "ainv_h": ainv_h}


@fp32_exact
def predict_mean_matrix_free(fit: dict, x, xstar, hstar, params: GPParams,
                             *, chunk: int = 65536):
    """Posterior mean at xstar from a fit_matrix_free result.

    c(xstar, x) e through K3 with rhs = e on the card (one launch; `chunk`
    unused), `chunk` query rows of the plain build at a time elsewhere.
    """
    ce = corr_times(xstar, x, params, fit["e"][:, None], chunk)[:, 0]
    return hstar @ fit["beta"] + ce
