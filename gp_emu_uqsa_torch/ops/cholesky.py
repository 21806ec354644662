"""Cholesky factorization with a jitter ladder, and triangular solves.

Port of `gp_emu_uqsa_tpu.ops.cholesky` on `torch.linalg.cholesky_ex` and
`torch.linalg.solve_triangular`.

Failure is read from `info`, not from NaN: XLA's Cholesky returns NaN below
the first failing pivot, but `cholesky_ex` returns a partial factor with no
NaN and `info > 0`. A factor whose diagonal is not finite (NaN input) also
counts as a failure. On total failure the returned factor is NaN, as in the
JAX package, so the likelihood guards turn it into +inf.

`cholesky_with_jitter` takes a leading batch axis (the restarts of a
multi-restart fit): each matrix climbs its own ladder, as under the JAX
package's `vmap`, and its gradient is the Cholesky adjoint `_chol_rev` of
the factor returned, never a gradient through a failed probe.

The blocked triangular solves of the JAX package work around an XLA:TPU
out-of-memory failure and are not ported: `tri_solve_auto` is a plain
`solve_triangular`.
"""
from __future__ import annotations

import torch

from gp_emu_uqsa_torch.ops.precision import fp32_exact


@fp32_exact
def _chol_rev(l: torch.Tensor, l_bar: torch.Tensor) -> torch.Tensor:
    """Reverse-mode Cholesky adjoint: cotangent of A given (L, L_bar).

    Transpose of the Cholesky JVP dL = L Phi(L^-1 dA L^-T), Phi = lower
    triangle with halved diagonal (Murray 2016):

        A_bar = L^-T Phi(L^T L_bar) L^-1

    left unsymmetrized, as the JAX package leaves it (the producer of A
    symmetrizes). Batched over leading axes.
    """
    s = l.mT @ l_bar
    p = torch.tril(s) - 0.5 * torch.diag_embed(
        torch.diagonal(s, dim1=-2, dim2=-1))
    t = torch.linalg.solve_triangular(l.mT, p, upper=True)
    return torch.linalg.solve_triangular(l, t, upper=False, left=False)


def _attempt(a: torch.Tensor, jitter: torch.Tensor):
    """chol(a + jitter I) for a batch (B, n, n), jitter (B,): (L, ok (B,))."""
    b = a.clone()
    b.diagonal(dim1=-2, dim2=-1).add_(jitter[:, None])
    l, info = torch.linalg.cholesky_ex(b)
    ok = (info == 0) & torch.isfinite(l.diagonal(dim1=-2, dim2=-1)).all(-1)
    return l, ok


def _ladder(a: torch.Tensor, initial_jitter, growth: float, max_tries: int):
    """The probe and per-matrix ladder on a (B, n, n) batch: (L, jitter (B,)).

    Matrices that factor at the probe are not refactored; each failing one
    climbs from its own first rung, one batched factorization of the still
    failing matrices per rung. One host read of the success mask a rung.
    """
    batch, n = a.shape[0], a.shape[-1]
    dtype, dev = a.dtype, a.device
    init = torch.as_tensor(initial_jitter, dtype=dtype, device=dev)
    jit = init.expand(batch).clone()
    l, ok = _attempt(a, jit)
    bad = torch.nonzero(~ok).flatten().tolist()
    if not bad:
        return l, jit
    idx = torch.tensor(bad, device=dev)
    sub = a[idx]
    g = torch.as_tensor(growth, dtype=dtype, device=dev)
    eps = torch.as_tensor(1e-12 if dtype == torch.float64 else 1e-6,
                          dtype=dtype, device=dev)
    # n-scaled first rung: the ladder runs only after the probe failed, and
    # the rounding of an n-term pivot update is about n eps diag
    base = torch.mean(sub.diagonal(dim1=-2, dim2=-1), dim=-1) * eps * n
    rung = torch.where(init == 0.0, base, init * g)
    for k in range(max_tries + 1):
        if k:
            rung = rung * g
        l_sub, ok_sub = _attempt(sub, rung)
        l[idx] = l_sub
        jit[idx] = rung
        keep = torch.nonzero(~ok_sub).flatten()
        if keep.numel() == 0:
            return l, jit
        idx, sub, rung = idx[keep], sub[keep], rung[keep]
    l[idx] = float("nan")
    return l, jit


class _CholeskyJitter(torch.autograd.Function):
    """The ladder as one differentiable op; the backward is `_chol_rev` on
    the returned factor (the JAX package's `_chol_jitter_bwd`). The jitter
    is a constant for autograd."""

    @staticmethod
    def forward(ctx, a, initial_jitter, growth, max_tries):
        l, jit = _ladder(a, initial_jitter, growth, max_tries)
        ctx.save_for_backward(l)
        ctx.mark_non_differentiable(jit)
        return l, jit

    @staticmethod
    def backward(ctx, l_bar, _jit_bar):
        (l,) = ctx.saved_tensors
        return _chol_rev(l, l_bar), None, None, None


def cholesky_with_jitter(a: torch.Tensor, initial_jitter=0.0,
                         growth: float = 10.0, max_tries: int = 8):
    """Lower Cholesky factor of `a` (+ jitter*I as needed): (L, jitter_used).

    A probe at `initial_jitter` first; if it fails, the ladder starts at
    mean(diag(a)) * eps * n (eps 1e-6 in fp32, 1e-12 in fp64; or at
    initial_jitter * growth when that is non-zero) and multiplies by
    `growth` up to `max_tries` more times. The factor of the successful rung
    is the one returned. On total failure L is NaN and jitter_used the last
    rung. `a` is (..., n, n); each matrix of the batch takes its own rung
    and jitter_used has the batch shape. Differentiable in `a`.
    """
    n = a.shape[-1]
    batch = a.shape[:-2]
    l, jit = _CholeskyJitter.apply(a.reshape(-1, n, n), initial_jitter,
                                   float(growth), int(max_tries))
    return l.reshape(a.shape), jit.reshape(batch)


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Plain lower Cholesky; NaN factor on failure (XLA's convention).

    Batched over leading axes; no host read of `info`.
    """
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], l,
                       torch.full_like(l, float("nan")))


def tri_solve(l: torch.Tensor, b: torch.Tensor, *,
              trans: bool = False) -> torch.Tensor:
    """Solve L x = b (or L^T x = b when trans) with L lower-triangular.

    Leading batch axes broadcast."""
    if trans:
        return torch.linalg.solve_triangular(l.mT, b, upper=True)
    return torch.linalg.solve_triangular(l, b, upper=False)


def tri_solve_auto(l: torch.Tensor, b: torch.Tensor, *,
                   trans: bool = False) -> torch.Tensor:
    """`tri_solve` (the JAX package's blocked form is a TPU workaround)."""
    return tri_solve(l, b, trans=trans)


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b."""
    return tri_solve(l, tri_solve(l, b), trans=True)


def tri_inverse(l: torch.Tensor) -> torch.Tensor:
    """L^-1 for lower-triangular L."""
    n = l.shape[-1]
    return tri_solve(l, torch.eye(n, dtype=l.dtype, device=l.device))


@fp32_exact
def spd_inverse_from_chol(l: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 = L^-T L^-1 through `tri_inverse`, the product in full
    fp32 or fp64 (TF32 off)."""
    linv = tri_inverse(l)
    return linv.mT @ linv


@fp32_exact
def cho_solve_refined(l: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                      iters: int = 1, jitter=0.0,
                      x: torch.Tensor | None = None) -> torch.Tensor:
    """Solve (A + jitter I) x = b from its factor l, then `iters` sweeps of
    iterative refinement; the result in l's dtype.

    Each sweep forms r = b - (A + jitter I) x as an fp64 product and adds
    the correction solved with the fp64 factor of A + jitter I: l itself
    when it is fp64; for an fp32 l, one fp64 factorization of the same
    matrix (the card runs it about as fast as the fp32 one,
    `tools/train_linalg.py calls`), or l where that one fails. The JAX
    package solves the correction with the fp32 factor, as a TPU has no
    fp64; a sweep then contracts the error by kappa(A) times the factor's
    backward error, which on the card (cuSOLVER) is about twice the CPU's
    (`tools/train_linalg.py factors`). With the fp64 factor one sweep
    leaves the rounding of the fp32 result. `x` is a starting solve
    (default cho_solve(l, b)); `b` may be fp64. a (n, n), b (n, k).
    """
    if x is None:
        x = cho_solve(l, b.to(l.dtype))
    rt = torch.float64
    a_r = a.to(rt)
    jit = torch.as_tensor(jitter, dtype=rt, device=a.device)
    b_r = b.to(rt)
    if l.dtype == rt:
        l_r = l
    else:
        a_eff = a_r.clone()
        a_eff.diagonal().add_(jit)
        l_r, info = torch.linalg.cholesky_ex(a_eff)
        del a_eff
        l_r = torch.where(info == 0, l_r, l.to(rt))
    x_r = x.to(rt)
    for _ in range(iters):
        r = b_r - (a_r @ x_r + jit * x_r)
        x_r = x_r + cho_solve(l_r, r)
    return x_r.to(l.dtype)

