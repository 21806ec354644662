"""Distributed Cholesky factorizations and triangular solves over row blocks.

Port of `gp_emu_uqsa_tpu.ops.distributed_cholesky`. The matrix is split by
rows over one mesh axis (`parallel.mesh.RowBlocks`): every rank holds its
rows (n_pad / p of them) with all n_pad columns, and no rank holds the
whole matrix. The rows are dealt block-cyclically in blocks of `block`,
the width of a panel or solve step (the JAX package's contiguous rows are
the layout with block = n_pad / p). The JAX package writes these as
global-array programs that GSPMD partitions, or as `shard_map` bodies;
here each is an SPMD loop with its collectives written out.

* `distributed_cholesky` (panel, right-looking): per step of B columns one
  all-gather of the (n_pad, B) panel; every rank factors the B x B
  diagonal block and solves the panel's lower rows (the same values
  everywhere), keeps its own rows and updates its trailing rows. The JAX
  body masks a full-width update to keep its shapes static; PyTorch has
  dynamic shapes, so the update is the trailing block itself, the same
  values at a third of the operations.
* `distributed_cholesky_recursive`: L11 = rec(A11), L21 = A21 L11^-T,
  L22 = rec(A22 - L21 L21^T). GSPMD re-spreads each half over all devices;
  the port instead keeps the rows block-cyclic (block b, b < n / p), so
  every half of every node (aligned to p b rows) is spread over all ranks
  already and no reshard is needed. A node gathers its L11 (for the TRSM)
  and its L21 (for the update): two all-gathers a node, each of the
  half-node's square, about n^2 words in all; the leaves (at most `leaf`
  rows) are gathered and factored on every rank.
* `distributed_tri_solve`: the manual substitution of the JAX package's
  `_tri_solve_shard_map_local`. L stays (n_pad / p, n_pad) per rank; each
  step the owner of the diagonal block solves it and broadcasts the solved
  (B, k) block, which the others fold into their running sums (forward);
  for L^T x = b each step all-reduces the (B, k) partial sums first. The
  JAX package's GSPMD `_tri_solve_loop` exists only because XLA gathered
  the factor, and has no counterpart here.
* `distributed_tri_inverse`: W = L^-1 row-sharded, the identity built per
  rank (the forward substitution with the solved blocks' columns cut to
  the lower triangle).

A factor that fails (`cholesky_ex` info > 0 on a leaf or a diagonal
block, which leaves a partial factor with no NaN) is all-reduced over the
ranks and the whole factor is returned as NaN, as `ops.cholesky.
cholesky_or_nan` does: a failure on any rank is visible on every rank.
Products and solves run with TF32 off (`fp32_exact`), as the JAX package
pins Precision.HIGHEST.
"""
from __future__ import annotations

from typing import Optional

import torch

from gp_emu_uqsa_torch.ops.precision import fp32_exact
from gp_emu_uqsa_torch.parallel.mesh import (
    RowBlocks, all_gather, all_reduce, axis_group, broadcast, group_rank,
    group_size, padded_rows,
)


def pad_identity(a: torch.Tensor, n_pad: int) -> torch.Tensor:
    """a (n, n) embedded in an (n_pad, n_pad) matrix with an identity tail."""
    n = a.shape[0]
    if n_pad == n:
        return a
    big = torch.zeros((n_pad, n_pad), dtype=a.dtype, device=a.device)
    big[:n, :n] = a
    big[n:, n:].diagonal().fill_(1.0)
    return big


def _lower_solve_right(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X with X L^T = b, L lower."""
    return torch.linalg.solve_triangular(l.mT, b, upper=True, left=False)


def _nan_on_failure(l: torch.Tensor, info: torch.Tensor, group):
    info = all_reduce(info, group, op="max")
    return torch.where(info == 0, l, torch.full_like(l, float("nan")))


def _fail(info: torch.Tensor, step_info: torch.Tensor) -> torch.Tensor:
    return torch.maximum(info, (step_info > 0).to(info.dtype))


def _gather_span(part: torch.Tensor, group, rows: RowBlocks) -> torch.Tensor:
    """Rows [s, e) of the matrix, in global order, from every rank's local
    rows of that span (s and e aligned to p * block, so every rank holds
    the same number of them)."""
    parts = all_gather(part, group)
    p, cnt = parts.shape[0], part.shape[0]
    b = rows.block
    return (parts.reshape(p, cnt // b, b, *part.shape[1:]).transpose(0, 1)
            .reshape(p * cnt, *part.shape[1:]))


def _panel(a: torch.Tensor, rows: RowBlocks, block: int, group):
    n = a.shape[1]
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    for off in range(0, n, block):
        end = off + block
        panel = _gather_span(a[:, off:end], group, rows)     # (n, B)
        lkk, step_info = torch.linalg.cholesky_ex(panel[off:end])
        info = _fail(info, step_info)
        lo, mid = rows.local_from(off), rows.local_from(end)
        lcol = _lower_solve_right(lkk, panel[end:])           # rows >= end
        a[:lo, off:end] = 0.0
        if mid > lo:                              # this rank's diagonal block
            a[lo:mid, off:end] = lkk
        mine = lcol[torch.as_tensor(rows.index[mid:] - end, device=a.device)]
        a[mid:, off:end] = mine
        a[mid:, end:] -= mine @ lcol.mT
    return a, info


@fp32_exact
def distributed_cholesky(a: torch.Tensor, mesh=None, *, axis: str = "mr",
                         block: int = 512):
    """Lower Cholesky factor by the right-looking panel scheme.

    With a mesh, `a` is this rank's rows (n_pad / p, n_pad) of the padded
    matrix in the block-cyclic `RowBlocks` layout of `axis` with `block`
    rows a block (n_pad a multiple of p * block; `shard_rows(a, mesh,
    axis, block)`), and B = block is the panel width. Returns this rank's
    rows of L. Without a mesh `a` is the (n, n) matrix, padded here to a
    multiple of `block` with an identity tail, and the (n, n) factor is
    returned. NaN on failure.
    """
    group = axis_group(mesh, axis)
    n = a.shape[-1]
    if group is None:
        a = pad_identity(a, padded_rows(n, 1, block))
    rows = RowBlocks.of(a.shape[1], group, block)
    l, info = _panel(a.clone(), rows, block, group)
    l = _nan_on_failure(l, info, group)
    return l[:n, :n] if group is None else l


def _rec(a, rows: RowBlocks, s: int, e: int, leaf: int, group, info):
    ls, le = rows.local_from(s), rows.local_from(e)
    span = rows.p * rows.block
    half = -(-(e - s) // (2 * span)) * span
    if e - s <= leaf or half >= e - s:
        blk = _gather_span(a[ls:le, s:e], group, rows)
        lkk, step_info = torch.linalg.cholesky_ex(blk)
        a[ls:le, s:e] = lkk[torch.as_tensor(rows.index[ls:le] - s,
                                            device=a.device)]
        return _fail(info, step_info)
    h = s + half
    lh = rows.local_from(h)
    info = _rec(a, rows, s, h, leaf, group, info)
    l11 = _gather_span(a[ls:lh, s:h], group, rows)
    a[lh:le, s:h] = _lower_solve_right(l11, a[lh:le, s:h])
    del l11
    l21 = _gather_span(a[lh:le, s:h], group, rows)
    a[lh:le, h:e] -= a[lh:le, s:h] @ l21.mT
    del l21
    a[ls:lh, h:e] = 0.0
    return _rec(a, rows, h, e, leaf, group, info)


def recursive_block(leaf: int, p: int) -> int:
    """The block-cyclic row block that `distributed_cholesky_recursive`
    takes by default: leaf / p, so a node splits in halves of p blocks."""
    return max(1, leaf // p)


@fp32_exact
def distributed_cholesky_recursive(a: torch.Tensor, mesh=None, *,
                                   axis: str = "mr", leaf: int = 2048,
                                   block: Optional[int] = None):
    """Recursive distributed Cholesky (see the module docstring).

    With a mesh, `a` is this rank's rows of the padded matrix in the
    block-cyclic `RowBlocks` layout of `axis` with `block` rows a block
    (default `recursive_block(leaf, p)`); the padded size must be a
    multiple of p * block. Returns this rank's rows of L. Without a mesh
    `a` is the (n, n) matrix and the (n, n) factor is returned. Nodes of at
    most `leaf` rows (or that cannot split in halves of whole p-block rows)
    are factored whole on every rank. NaN on failure.
    """
    group = axis_group(mesh, axis)
    n = a.shape[-1]
    if block is None:
        block = recursive_block(leaf, group_size(group))
    if group is None:
        a = pad_identity(a, padded_rows(n, 1, block))
    rows = RowBlocks.of(a.shape[1], group, block)
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    l = a.clone()
    info = _rec(l, rows, 0, rows.n_pad, leaf, group, info)
    l = _nan_on_failure(l, info, group)
    return l[:n, :n] if group is None else l


def _solve_layout(l, b, mesh, axis, block):
    group = axis_group(mesh, axis)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n = l.shape[-1]
    if group is None:
        n_pad = padded_rows(n, 1, block)
        l = pad_identity(l, n_pad)
        b = torch.cat([b, b.new_zeros((n_pad - n, b.shape[1]))])
    rows = RowBlocks.of(l.shape[1], group, block)
    return group, rows, l, b, squeeze, n


@fp32_exact
def distributed_tri_solve(l: torch.Tensor, b: torch.Tensor, mesh=None, *,
                          axis: str = "mr", block: int = 512,
                          trans: bool = False):
    """Solve L x = b (or L^T x = b), L lower, by rows over `axis`.

    With a mesh, l and b are this rank's rows (layout as in
    `distributed_cholesky`) and so is the result. Without a mesh l is
    (n, n), b (n,) or (n, k), and the solution has b's shape.
    """
    group, rows, l, b, squeeze, n = _solve_layout(l, b, mesh, axis, block)
    me = group_rank(group)
    x = torch.zeros_like(b)
    steps = range(0, rows.n_pad, block)
    if not trans:
        acc = torch.zeros_like(b)
        for off in steps:
            owner, loc = rows.owner(off)
            xk = torch.empty((block, b.shape[1]), dtype=b.dtype,
                             device=b.device)
            if me == owner:
                xk = torch.linalg.solve_triangular(
                    l[loc:loc + block, off:off + block],
                    b[loc:loc + block] - acc[loc:loc + block], upper=False)
                x[loc:loc + block] = xk
            xk = broadcast(xk, owner, group)
            mid = rows.local_from(off + block)
            acc[mid:] += l[mid:, off:off + block] @ xk
    else:
        for off in reversed(steps):
            owner, loc = rows.owner(off)
            mid = rows.local_from(off + block)
            part = all_reduce(l[mid:, off:off + block].mT @ x[mid:], group)
            if me == owner:
                x[loc:loc + block] = torch.linalg.solve_triangular(
                    l[loc:loc + block, off:off + block].mT,
                    b[loc:loc + block] - part, upper=True)
    if group is None:
        x = x[:n]
    return x[:, 0] if squeeze else x


@fp32_exact
def distributed_tri_inverse(l: torch.Tensor, mesh=None, *, axis: str = "mr",
                            block: int = 512):
    """W = L^-1 by rows over `axis` (layout as in `distributed_cholesky`):
    the forward substitution of `distributed_tri_solve` with the identity's
    rows built on each rank and each solved block's columns cut to the
    lower triangle (columns < off + B), so no (n, n) tensor exists on any
    rank. Without a mesh, the (n, n) inverse."""
    group = axis_group(mesh, axis)
    n = l.shape[-1]
    if group is None:
        l = pad_identity(l, padded_rows(n, 1, block))
    rows = RowBlocks.of(l.shape[1], group, block)
    me = group_rank(group)
    n_pad = rows.n_pad
    w = torch.zeros((rows.rows, n_pad), dtype=l.dtype, device=l.device)
    acc = torch.zeros_like(w)
    for off in range(0, n_pad, block):
        end = off + block
        owner, loc = rows.owner(off)
        xk = torch.empty((block, end), dtype=l.dtype, device=l.device)
        if me == owner:
            rhs = -acc[loc:loc + block, :end]
            rhs[:, off:end] += torch.eye(block, dtype=l.dtype,
                                         device=l.device)
            xk = torch.linalg.solve_triangular(l[loc:loc + block, off:end],
                                               rhs, upper=False)
            w[loc:loc + block, :end] = xk
        xk = broadcast(xk, owner, group)
        mid = rows.local_from(end)
        acc[mid:, :end] += l[mid:, off:end] @ xk
    del acc
    w = torch.tril(w, diagonal=0) if group is None else _tril_rows(w, rows)
    return w[:n, :n] if group is None else w


def _tril_rows(w: torch.Tensor, rows: RowBlocks) -> torch.Tensor:
    """Zero the entries of local rows right of the global diagonal."""
    cols = torch.arange(w.shape[1], device=w.device)
    keep = cols[None, :] <= rows.index_tensor(w.device)[:, None]
    return torch.where(keep, w, torch.zeros((), dtype=w.dtype,
                                            device=w.device))
