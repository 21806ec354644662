"""Cholesky factorization with a jitter ladder, and triangular solves.

Port of `gp_emu_uqsa_tpu.ops.cholesky` on `torch.linalg.cholesky_ex` and
`torch.linalg.solve_triangular`.

Failure is read from `info`, not from NaN: XLA's Cholesky returns NaN below
the first failing pivot, but `cholesky_ex` returns a partial factor with no
NaN and `info > 0`. A factor whose diagonal is not finite (NaN input) also
counts as a failure. On total failure the returned factor is NaN, as in the
JAX package, so the likelihood guards turn it into +inf.

The blocked triangular solves of the JAX package work around an XLA:TPU
out-of-memory failure and are not ported: `tri_solve_auto` is a plain
`solve_triangular`.
"""
from __future__ import annotations

import torch


def _attempt(a: torch.Tensor, jitter: torch.Tensor):
    """chol(a + jitter I) and whether it succeeded."""
    b = a.clone()
    b.diagonal().add_(jitter)
    l, info = torch.linalg.cholesky_ex(b)
    ok = bool(info.item() == 0) and bool(torch.isfinite(l.diagonal()).all())
    return l, ok


def cholesky_with_jitter(a: torch.Tensor, initial_jitter=0.0,
                         growth: float = 10.0, max_tries: int = 8):
    """Lower Cholesky factor of `a` (+ jitter*I as needed): (L, jitter_used).

    A probe at `initial_jitter` first; if it fails, the ladder starts at
    mean(diag(a)) * eps * n (eps 1e-6 in fp32, 1e-12 in fp64; or at
    initial_jitter * growth when that is non-zero) and multiplies by
    `growth` up to `max_tries` more times. The factor of the successful rung
    is the one returned. On total failure L is NaN and jitter_used the last
    rung. `a` is a single (n, n) matrix.
    """
    dtype, dev = a.dtype, a.device
    init = torch.as_tensor(initial_jitter, dtype=dtype, device=dev)
    l, ok = _attempt(a, init)
    if ok:
        return l, init
    n = a.shape[-1]
    g = torch.as_tensor(growth, dtype=dtype, device=dev)
    if float(init) == 0.0:
        eps = torch.as_tensor(1e-12 if dtype == torch.float64 else 1e-6,
                              dtype=dtype, device=dev)
        jit = torch.mean(a.diagonal()) * eps * n
    else:
        jit = init * g
    l, ok = _attempt(a, jit)
    k = 0
    while k < max_tries and not ok:
        k += 1
        jit = jit * g
        l, ok = _attempt(a, jit)
    if not ok:
        l = torch.full_like(l, float("nan"))
    return l, jit


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Plain lower Cholesky; NaN factor on failure (XLA's convention)."""
    l, info = torch.linalg.cholesky_ex(a)
    if info.item() != 0:
        return torch.full_like(l, float("nan"))
    return l


def tri_solve(l: torch.Tensor, b: torch.Tensor, *,
              trans: bool = False) -> torch.Tensor:
    """Solve L x = b (or L^T x = b when trans) with L lower-triangular."""
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
