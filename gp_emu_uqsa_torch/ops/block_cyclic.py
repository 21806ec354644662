"""2-D block-cyclic distributed Cholesky on an (mr, mc) mesh.

Port of `gp_emu_uqsa_tpu.ops.block_cyclic` (ScaLAPACK pdpotrf-shaped). The
matrix is tiled into B x B blocks; block (i, j) lives on rank (i mod P_r,
j mod P_c) of the (P_r, P_c) mesh, which keeps every rank busy in every
step (a plain 2-D tiling would idle the top-left ranks as the panel sweeps
down). Each rank holds a dense (G/P_r, G/P_c, B, B) stack of its blocks,
local block (a, b) being global block (r + P_r a, c + P_c b): the JAX
package's owner-major layout after `_cyclic_order`, built here on each rank
(`to_block_cyclic`, or directly by `parallel.large_fit`).

Per step k (right-looking, the collectives of the JAX body's psums):
  1. the owner of (k, k) sends its diagonal block to every rank (a
     broadcast along mr, then along mc: B^2 words), and every rank
     factors it;
  2. the owner column solves its panel blocks L_ik = A_ik L_kk^-T (the
     row blocks i > k, one batched TRSM);
  3. the panel goes along mc from the owner column (each rank's row
     blocks, G/P_r B^2 words), then along mr only the blocks at this
     rank's column indices gj (an all-reduce of G/P_c B^2 words): the
     volume fix of the JAX package (`block_cyclic.py:72-84`);
  4. the trailing update: one product over the local blocks with i > k
     and j > k. The JAX body masks a full-stack update to keep its shapes
     static; here the update is the trailing stack itself.
Per-rank memory is n^2 / P. Products and solves run with TF32 off.
"""
from __future__ import annotations

import math

import torch

from gp_emu_uqsa_torch.ops.distributed_cholesky import (
    _fail, _lower_solve_right, pad_identity,
)
from gp_emu_uqsa_torch.ops.precision import fp32_exact
from gp_emu_uqsa_torch.parallel.mesh import (
    RowBlocks, all_gather, all_reduce, axis_group, broadcast, group_rank,
    group_size,
)


def grid(mesh, axes=("mr", "mc")):
    """(P_r, P_c, my row, my column, row group, column group)."""
    gr, gc = axis_group(mesh, axes[0]), axis_group(mesh, axes[1])
    return (group_size(gr), group_size(gc), group_rank(gr), group_rank(gc),
            gr, gc)


def padded_size(n: int, block: int, p_r: int, p_c: int) -> int:
    """n rounded up to a block grid that both mesh axes divide."""
    step = block * math.lcm(p_r, p_c)
    return -(-n // step) * step


def to_block_cyclic(a: torch.Tensor, mesh, *, axes=("mr", "mc"),
                    block: int = 256) -> torch.Tensor:
    """This rank's (G/P_r, G/P_c, B, B) stack of the (n, n) matrix a,
    padded with an identity tail."""
    p_r, p_c, my_r, my_c, _, _ = grid(mesh, axes)
    n_pad = padded_size(a.shape[0], block, p_r, p_c)
    a = pad_identity(a, n_pad)
    ri = RowBlocks(n_pad, p_r, my_r, block).index_tensor(a.device)
    ci = RowBlocks(n_pad, p_c, my_c, block).index_tensor(a.device)
    return blocks_from_rows(a[ri][:, ci], block)


def blocks_from_rows(t: torch.Tensor, block: int) -> torch.Tensor:
    """(R, C) local rows x columns -> the (R/B, C/B, B, B) block stack."""
    r, c = t.shape
    return (t.reshape(r // block, block, c // block, block)
            .permute(0, 2, 1, 3).contiguous())


def block_cyclic_rows(l: torch.Tensor, mesh, *,
                      axes=("mr", "mc")) -> torch.Tensor:
    """The factor's stack -> this rank's rows in the block-cyclic row
    layout of axes[0] (`RowBlocks` with block B), all n_pad columns: one
    all-gather along mc. Ranks of one mc group hold the same rows."""
    p_r, p_c, my_r, my_c, _, gc = grid(mesh, axes)
    g_lr, g_lc, b = l.shape[0], l.shape[1], l.shape[2]
    parts = all_gather(l, gc)                       # (P_c, Glr, Glc, B, B)
    full = parts.permute(1, 2, 0, 3, 4).reshape(g_lr, g_lc * p_c, b, b)
    return full.permute(0, 2, 1, 3).reshape(g_lr * b, g_lc * p_c * b)


@fp32_exact
def block_cyclic_cholesky(a: torch.Tensor, mesh, *, axes=("mr", "mc"),
                          block: int = 256) -> torch.Tensor:
    """Lower Cholesky factor of an SPD matrix on a 2-D mesh.

    `a` is this rank's (G/P_r, G/P_c, B, B) stack (`to_block_cyclic`);
    returns the factor's stack in the same layout, with the blocks above
    the diagonal zero. NaN everywhere if a diagonal block fails on any
    rank.
    """
    p_r, p_c, my_r, my_c, gr, gc = grid(mesh, axes)
    g_lr, g_lc, b = a.shape[0], a.shape[1], a.shape[2]
    if b != block:
        raise ValueError(f"the stack has {b} x {b} blocks, not {block}")
    g = g_lr * p_r
    dev = a.device
    gi = my_r + p_r * torch.arange(g_lr, device=dev)
    gj = my_c + p_c * torch.arange(g_lc, device=dev)
    own = (gj % p_r) == my_r
    slot = torch.clamp(gj // p_r, max=g_lr - 1)
    a = a.clone()
    info = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(g):
        owner_r, owner_c = k % p_r, k % p_c
        li, lj = k // p_r, k // p_c
        # first local row / column block with global index >= k, > k
        a0 = -(-(k - my_r) // p_r)
        a1 = -(-(k + 1 - my_r) // p_r)
        b1 = -(-(k + 1 - my_c) // p_c)
        # 1. the diagonal block from its owner, factored everywhere
        akk = (a[li, lj] if (my_r, my_c) == (owner_r, owner_c)
               else torch.empty((b, b), dtype=a.dtype, device=dev))
        if my_c == owner_c:
            akk = broadcast(akk, owner_r, gr)
        akk = broadcast(akk, owner_c, gc)
        lkk, step_info = torch.linalg.cholesky_ex(akk)
        info = _fail(info, step_info)
        # 2. the panel TRSM on the owner column
        prow = torch.zeros((g_lr, b, b), dtype=a.dtype, device=dev)
        if my_c == owner_c:
            a[:a0, lj] = 0.0
            if a1 > a0:                       # this rank's diagonal block
                a[a0, lj] = lkk
                prow[a0] = lkk
            a[a1:, lj] = _lower_solve_right(lkk, a[a1:, lj])
            prow[a1:] = a[a1:, lj]
        # 3. the panel along mc, then the blocks at my columns along mr
        prow = broadcast(prow, owner_c, gc)
        contrib = torch.where(own[:, None, None], prow[slot],
                              torch.zeros((), dtype=a.dtype, device=dev))
        pcol = all_reduce(contrib, gr)
        # 4. the trailing update, local blocks with i > k and j > k
        na, nb = g_lr - a1, g_lc - b1
        if na > 0 and nb > 0:
            upd = (prow[a1:].reshape(na * b, b)
                   @ pcol[b1:].reshape(nb * b, b).mT)
            a[a1:, b1:] -= upd.reshape(na, b, nb, b).permute(0, 2, 1, 3)
    upper = gj[None, :] > gi[:, None]
    a = torch.where(upper[:, :, None, None],
                    torch.zeros((), dtype=a.dtype, device=dev), a)
    diag = gj[None, :] == gi[:, None]
    a = torch.where(diag[:, :, None, None], torch.tril(a), a)
    info = all_reduce(all_reduce(info, gr, op="max"), gc, op="max")
    return torch.where(info == 0, a, torch.full_like(a, float("nan")))
