"""Distributed large-n GP fit and serving predictor (BASELINE config 5).

Port of `gp_emu_uqsa_tpu.parallel.large_fit`. Everything n x n stays split
by rows over mesh axis `axis`, block-cyclic with blocks of
b = min(block, ceil(n / p)) rows (`parallel.mesh.RowBlocks`; padded to
n_pad, a multiple of p b, with an identity tail):

  rows of A (`sharded_gp.corr_block`, K2 on the card)
    -> distributed Cholesky ("recursive", "panel" or "block2d")
    -> distributed solves for L^-1 [y | H] (gathered: n (1 + q) words)
    -> G, beta, sigma2 and the NLL, replicated (q is small)
    -> distributed solves for [e | A^-1 H], gathered.

The fit state is a `gp.FitState`. Its `l` is this rank's rows of the
padded factor, (n_pad / p, n_pad); with one rank on the axis (or no mesh)
it is the (n, n) factor, and the state is the port's `gp.fit` at the same
parameters. `predictor_large` builds W = L^-1 by the same rows, and
`ring.ring_predict` serves from it.

Two departures from the JAX function, both to match the port's `gp.fit`:
- resid is |L^-1 (y - H beta)|^2 (`gp._common`), not the difference of
  two terms, which cancels where the basis explains most of y;
- `refine` takes the residual of this rank's rows of A in fp64 (the card
  has fp64 units), not the JAX package's compensated fp32
  (`ops/compensated.py::residual_compensated_sharded`), and solves the
  correction with an fp64 distributed factor of the same A, as
  `gp.fit(refine)` does: for fp32 a second factorization, whose rows
  (and those of A in fp64) take 2 n_pad^2 / p fp64 words a rank.
A factor that fails on any rank gives a non-finite (inf) NLL, as
`gp.fit` does.
"""
from __future__ import annotations

import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.kernels import GPParams
from gp_emu_uqsa_torch.ops.block_cyclic import (
    block_cyclic_cholesky, block_cyclic_rows, blocks_from_rows, grid,
    padded_size,
)
from gp_emu_uqsa_torch.ops.cholesky import cholesky_or_nan, tri_solve
from gp_emu_uqsa_torch.ops.distributed_cholesky import (
    distributed_cholesky, distributed_cholesky_recursive,
    distributed_tri_inverse, distributed_tri_solve, pad_identity,
)
from gp_emu_uqsa_torch.ops.precision import fp32_exact
from gp_emu_uqsa_torch.parallel.mesh import (
    RowBlocks, all_reduce, axis_group, gather_group_rows, group_size,
    padded_rows,
)
from gp_emu_uqsa_torch.parallel.sharded_gp import corr_block, padded_x

_LOG2PI = 1.8378770664093453
FACTORIZATIONS = ("recursive", "panel", "block2d")


def row_block(n: int, p: int, block: int) -> int:
    """The rows of a layout block: min(block, ceil(n / p))."""
    return min(block, -(-n // p))


def _factor(x, params, n, mesh, axis, col_axis, b, factorization, leaf,
            dtype=None):
    """(this rank's rows of the padded factor, their RowBlocks); `dtype`
    factors the same A (built in x's dtype) in another precision."""
    group = axis_group(mesh, axis)
    if factorization == "block2d":
        p_r, p_c, my_r, my_c, _, _ = grid(mesh, (axis, col_axis))
        n_pad = padded_size(n, b, p_r, p_c)
        x_pad = padded_x(x, n_pad)
        ri = RowBlocks(n_pad, p_r, my_r, b).index_tensor(x.device)
        ci = RowBlocks(n_pad, p_c, my_c, b).index_tensor(x.device)
        a = blocks_from_rows(corr_block(x_pad, n, params, ri, ci).to(dtype),
                             b)
        l = block_cyclic_cholesky(a, mesh, axes=(axis, col_axis), block=b)
        del a
        l = block_cyclic_rows(l, mesh, axes=(axis, col_axis))
        return l, RowBlocks(n_pad, p_r, my_r, b)
    n_pad = padded_rows(n, group_size(group), b)
    rows = RowBlocks.of(n_pad, group, b)
    a = corr_block(padded_x(x, n_pad), n, params,
                   rows.index_tensor(x.device),
                   torch.arange(n_pad, device=x.device)).to(dtype)
    if factorization == "recursive":
        l = distributed_cholesky_recursive(a, mesh, axis=axis, leaf=leaf,
                                           block=b)
    elif factorization == "panel":
        l = distributed_cholesky(a, mesh, axis=axis, block=b)
    else:
        raise ValueError(f"unknown factorization {factorization!r}; one of "
                         f"{FACTORIZATIONS}")
    return l, rows


@fp32_exact
def fit_large(params: GPParams, x, y, h, mesh, *, axis: str = "mr",
              block: int = 512, mode: str = "mucm",
              factorization: str = "recursive", col_axis: str = "mc",
              refine: int = 0, leaf: int = 2048) -> gp.FitState:
    """Distributed counterpart of gp.fit for n too large for one card.

    x, y, h are replicated on every rank. factorization: "recursive"
    (default; about n^2 words gathered in all, `leaf` the largest node
    factored whole), "panel" (one (n, B) all-gather a step) or "block2d"
    (the 2-D block-cyclic scheme over (`axis`, `col_axis`); per-rank memory
    n^2 / P during the factorization, then rows over `axis`). refine:
    refinement sweeps on [e | A^-1 H] (the module docstring).
    """
    n, q = h.shape
    group = axis_group(mesh, axis)
    p = group_size(group)
    b = row_block(n, p, block)
    l, rows = _factor(x, params, n, mesh, axis, col_axis, b, factorization,
                      leaf)
    n_pad = rows.n_pad
    idx = rows.index_tensor(x.device)

    def solve(rhs_rows, trans=False):
        out = distributed_tri_solve(l, rhs_rows, mesh, axis=axis, block=b,
                                    trans=trans)
        return gather_group_rows(out, group, b, n_pad)

    def rows_of(t):
        return torch.cat([t, t.new_zeros((n_pad - n, t.shape[1]))])[idx]

    linv = solve(rows_of(torch.cat([y[:, None], h], 1)))[:n]
    linv_y, linv_h = linv[:, 0], linv[:, 1:]
    lg = cholesky_or_nan(gp._sym(linv_h.mT @ linv_h))
    hty = linv_h.mT @ linv_y
    lg_inv_hty = tri_solve(lg, hty[:, None])[:, 0]
    beta = tri_solve(lg, lg_inv_hty[:, None], trans=True)[:, 0]
    white = linv_y - linv_h @ beta
    resid = torch.sum(white * white)
    # the padded diagonal is 1: log 1 = 0
    logdet_a = 2.0 * all_reduce(
        torch.sum(torch.log(l[torch.arange(rows.rows, device=l.device),
                              idx])), group)
    logdet_g = gp._logdet(lg)
    if mode == "mucm":
        sigma2 = resid / (n - q - 2)
        nll_val = (0.5 * (n - q) * torch.log(sigma2) + 0.5 * logdet_a
                   + 0.5 * logdet_g)
    else:
        sigma2 = params.sigma2
        nll_val = 0.5 * (resid / sigma2 + n * torch.log(sigma2) + logdet_a
                         + n * _LOG2PI)
    sol = solve(rows_of(torch.cat([white[:, None], linv_h], 1)), trans=True)
    if refine:
        rt = torch.float64
        h_r = h.to(rt)
        rhs = rows_of(torch.cat([(y.to(rt) - h_r @ beta.to(rt))[:, None],
                                 h_r], 1))
        a_rows = corr_block(padded_x(x, n_pad), n, params, idx,
                            torch.arange(n_pad, device=x.device)).to(rt)
        # the correction goes through the fp64 factor of the same A, as
        # gp.fit's cho_solve_refined does: through the fp32 factor a sweep
        # contracts the error by kappa(A) times its backward error, which
        # leaves config 5 (n = 16384, nugget 1e-4) at 0.22 from 0.30
        l_r = l if l.dtype == rt else _factor(
            x, params, n, mesh, axis, col_axis, b, factorization, leaf,
            dtype=rt)[0]
        sol_r = sol.to(rt)
        for _ in range(refine):
            r = rhs - a_rows @ sol_r
            fwd = distributed_tri_solve(l_r, r, mesh, axis=axis, block=b)
            corr = distributed_tri_solve(
                l_r, gather_group_rows(fwd, group, b, n_pad)[idx], mesh,
                axis=axis, block=b, trans=True)
            sol_r = sol_r + gather_group_rows(corr, group, b, n_pad)
        sol = sol_r.to(l.dtype)
        del a_rows, l_r
    l_out = l[:n, :n] if p == 1 else l
    return gp.FitState(params, l_out, lg, beta, sol[:n, 0], sigma2,
                       sol[:n, 1:], torch.zeros((), dtype=x.dtype,
                                                device=x.device),
                       gp._guard(nll_val))


@fp32_exact
def predictor_large(state: gp.FitState, mesh, *, axis: str = "mr",
                    block: int = 512) -> gp.Predictor:
    """Serving Predictor with W = L^-1 built by rows over `axis`.

    `state` comes from `fit_large` with the same mesh, axis and block.
    Every rank builds its rows of the identity and solves them against the
    distributed factor (`distributed_tri_inverse`): no (n, n) tensor
    exists on any rank, and the Predictor's `linv` is this rank's rows of
    the padded W, which `ring.ring_predict` serves from (the (n, n) W with
    one rank on the axis). The q-sized parts are replicated.
    """
    n = state.e.shape[0]
    group = axis_group(mesh, axis)
    p = group_size(group)
    b = row_block(n, p, block)
    if p == 1:
        l = pad_identity(state.l, padded_rows(n, 1, b))
        w = distributed_tri_inverse(l, mesh, axis=axis, block=b)[:n, :n]
    else:
        w = distributed_tri_inverse(state.l, mesh, axis=axis, block=b)
    q = state.lg.shape[0]
    lg_inv = tri_solve(state.lg, torch.eye(q, dtype=state.lg.dtype,
                                           device=state.lg.device))
    wg = lg_inv.mT @ lg_inv                       # G^-1
    return gp.Predictor(state.params, state.beta, state.e, w,
                        state.ainv_h @ wg, state.ainv_h,
                        cholesky_or_nan(gp._sym(wg)), state.sigma2)
