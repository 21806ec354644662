"""Row-sharded training-matrix construction for large-n fits.

Port of `gp_emu_uqsa_tpu.parallel.sharded_gp` (BASELINE config 5's first
half). X is (n, d), small, and every rank holds all of it; each rank builds
only its rows of A = c(X, X) + nugget I, so no rank holds the whole
matrix. The rows come from `kernels.corr` (kernel K2 on the card in fp32
with d <= 20 and at least 256 rows a side), which computes the plain
build's exact-difference function bit for bit; the JAX body calls the
plain `gaussian_corr`. K2 scales by a rounded 1/delta where K1 divides, so
a K2-built A equals K1's within their tolerance, not bit for bit; it is
exactly symmetric across rank blocks, since every entry sums the same
squared differences in the same order.

The nugget goes on the global diagonal; rows and columns past n (the
padding that makes the blocks divide) are zero with an identity tail, so
a Cholesky of the padded matrix restricts to the factor of A.
"""
from __future__ import annotations

from typing import Optional

import torch

from gp_emu_uqsa_torch import kernels
from gp_emu_uqsa_torch.kernels import GPParams
from gp_emu_uqsa_torch.parallel.mesh import (
    RowBlocks, axis_group, group_size, padded_rows,
)


def padded_x(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """x with zero rows appended up to n_pad rows."""
    return torch.cat([x, x.new_zeros((n_pad - x.shape[0], x.shape[1]))])


def corr_block(x_pad: torch.Tensor, n: int, params: GPParams,
               rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Entries (rows, cols) of the padded A: c(x_rows, x_cols) through
    `kernels.corr`, the nugget where row == col < n, zero past n, one on the
    padded diagonal. rows and cols are global indices on x's device."""
    c = kernels.corr(x_pad[rows], x_pad[cols], params)
    valid = (rows < n)[:, None] & (cols < n)[None, :]
    diag = rows[:, None] == cols[None, :]
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    c = torch.where(valid, c, zero)
    c = torch.where(diag & valid, c + params.nugget.to(c.dtype), c)
    return torch.where(diag & ~valid, torch.ones_like(c), c)


def build_corr_sharded(x: torch.Tensor, params: GPParams, mesh, *,
                       axis: str = "mr", block: Optional[int] = None):
    """This rank's rows of A = c(X, X) + nugget I, padded to n_pad rows, n
    rounded up to a multiple of p (times block).

    Rows in the `RowBlocks` layout of `axis`: contiguous (block None) or
    block-cyclic blocks of `block` rows. Returns (rows (n_pad / p, n_pad),
    n). Without a mesh, the whole padded matrix.
    """
    group = axis_group(mesh, axis)
    n = x.shape[0]
    n_pad = padded_rows(n, group_size(group), block or 1)
    rows = RowBlocks.of(n_pad, group, block)
    cols = torch.arange(n_pad, device=x.device)
    return corr_block(padded_x(x, n_pad), n, params,
                      rows.index_tensor(x.device), cols), n
