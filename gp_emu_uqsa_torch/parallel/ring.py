"""Ring-streamed batched prediction with a sharded training set.

Port of `gp_emu_uqsa_tpu.parallel.ring`. For n too large to replicate,
the query points and the training set are both split over one mesh axis.
Each rank keeps its queries and the training-side blocks rotate around the
ring (send to rank + 1, receive from rank - 1, `mesh.shift`):

  pass 1: rotate (x, e, A^-1 H) shards; each visit builds the (m/p, n/p)
          block of t = c(X*, X) with `kernels.corr` (kernel K2 on the
          card) and places e and A^-1 H; the mean and the R-term follow.
  pass 2: rotate the rows of W = L^-1; each visit adds |t W_rows^T|^2 to
          the variance quadratic |W t|^2. The row blocks' terms are
          independent sums of squares, so no cancellation crosses a hop.
          W is lower triangular: a row with global index g is zero past
          column g. So each visiting block is multiplied by runs of
          `SUB_ROWS` rows, each only over its first columns up to its last
          nonzero one (`row_extents`). The extents are read from W itself,
          on the card, once a call (one all-gather of a small integer table
          and one copy to the host, so no visit waits on the host): they
          hold for the contiguous rows of a whole W and for
          `predictor_large`'s block-cyclic rows alike, and never cut a
          nonzero. This skips about half the dense product; `pass2` counts
          the multiply-add pairs issued and the dense product's. The
          products run with TF32 off (`fp32_exact`); the JAX package
          computes this product outside Pallas too.
The rotation after the last visit is skipped, so one rank sends nothing.
"""
from __future__ import annotations

import torch

from gp_emu_uqsa_torch import gp, kernels
from gp_emu_uqsa_torch.ops.precision import fp32_exact
from gp_emu_uqsa_torch.parallel.mesh import (
    all_gather, axis_group, gather_group_rows, group_rank, group_size, shift,
)
from gp_emu_uqsa_torch.parallel.predict import pad_to_multiple, query_shard

# rows of a pass-2 run: at m = 65536, n = 16384 on an H100, runs of 256
# rows beat 512 and 1024 in every layout `tools/ring_pass2.py` times
SUB_ROWS = 256


class Pass2Pairs:
    """Multiply-add pairs of pass 2 on this rank: `issued` by the products
    over the runs' extents, `dense` by one product over every row and
    column of each visiting block."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.issued = 0
        self.dense = 0

    @property
    def share(self):
        return self.issued / self.dense if self.dense else None


pass2 = Pass2Pairs()


def row_extents(w_rows: torch.Tensor, sub: int) -> torch.Tensor:
    """For each run of `sub` consecutive rows of w_rows (the last may be
    shorter), one past the index of its last nonzero column (int32); 0 for
    a run of zeros."""
    r, c = w_rows.shape
    nz = w_rows != 0
    full = r - r % sub
    cols = nz[:full].view(full // sub, sub, c).any(1)
    if full < r:
        cols = torch.cat([cols, nz[full:].any(0, keepdim=True)])
    idx = torch.arange(1, c + 1, dtype=torch.int32, device=w_rows.device)
    return torch.where(cols, idx, 0).amax(1)


def add_quad(quad: torch.Tensor, t: torch.Tensor, rows: torch.Tensor,
             extents, sub: int) -> None:
    """quad += |t rows^T|^2 along t's rows, each run j of `sub` rows of
    `rows` multiplied over its first extents[j] columns only (strided
    views, no copies)."""
    m = t.shape[0]
    pass2.dense += m * rows.shape[0] * rows.shape[1]
    for j, e in enumerate(extents):
        if e == 0:
            continue
        blk = rows[j * sub:(j + 1) * sub, :e]
        pass2.issued += m * blk.shape[0] * e
        u = t[:, :e] @ blk.mT
        quad += torch.sum(u * u, 1)


def _rotations(first: torch.Tensor, p: int, group):
    """The p visiting tensors: first, then each one shifted once more."""
    vis = first
    for i in range(p):
        yield i, vis
        if i + 1 < p:
            vis = shift(vis, group)


@fp32_exact
def ring_predict(pred: gp.Predictor, x, xstar, hstar, mesh, *,
                 axis: str = "data", include_nugget: bool = False):
    """Posterior mean/var at xstar with X, e, A^-1 H and W split over
    `axis`; the whole (mean, var) of len(xstar) on every rank.

    pred.linv is either the whole (n, n) W (`gp.predictor`), of which each
    rank serves its contiguous rows, or this rank's rows of the padded W
    from `large_fit.predictor_large` on a mesh axis of the same size.
    """
    group = axis_group(mesh, axis)
    p, me = group_size(group), group_rank(group)
    n = x.shape[0]
    q = pred.ainv_h.shape[1]
    whole = pred.linv.shape[0] == n
    x_p, _ = pad_to_multiple(x, p)
    s = x_p.shape[0] // p
    if whole:
        w_rows, _ = query_shard(pred.linv, group)
        ncols = p * s
        w_rows = torch.cat([w_rows, w_rows.new_zeros(
            (s, ncols - n))], 1)
    else:
        w_rows = pred.linv
        ncols = w_rows.shape[1]
    # every visitor's extents, on the host only once pass 1 is queued
    extents = all_gather(row_extents(w_rows, SUB_ROWS), group)
    train = torch.cat([x, pred.e[:, None], pred.ainv_h], 1)
    train, _ = query_shard(train, group)          # (s, d + 1 + q)
    xq, m = query_shard(xstar, group)
    hq, _ = query_shard(hstar, group)
    d = x.shape[1]
    params = pred.params
    t = torch.zeros((xq.shape[0], ncols), dtype=xq.dtype, device=xq.device)
    e_full = torch.zeros(ncols, dtype=xq.dtype, device=xq.device)
    ainvh_full = torch.zeros((ncols, q), dtype=xq.dtype, device=xq.device)
    # pass 1: t's blocks, e and A^-1 H from the visiting shards
    for i, vis in _rotations(train, p, group):
        src = (me - i) % p
        lo, hi = src * s, min((src + 1) * s, n)
        if hi > lo:
            k = hi - lo
            t[:, lo:hi] = kernels.corr(xq, vis[:k, :d].contiguous(), params)
            e_full[lo:hi] = vis[:k, d]
            ainvh_full[lo:hi] = vis[:k, d + 1:]
    mean = hq @ pred.beta + t @ e_full
    rw = (hq - t @ ainvh_full) @ pred.w_chol
    quad_r = torch.sum(rw * rw, 1)
    # pass 2: the rows of W visit; |W t|^2 = sum over row blocks
    quad_t = torch.zeros(xq.shape[0], dtype=xq.dtype, device=xq.device)
    extents = extents.tolist()
    for i, rows in _rotations(w_rows, p, group):
        add_quad(quad_t, t, rows, extents[(me - i) % p], SUB_ROWS)
    prior = 1.0 + (params.nugget if include_nugget else 0.0)
    var = pred.sigma2 * torch.clamp(prior - quad_t + quad_r, min=0.0)
    out = gather_group_rows(torch.stack([mean, var], 1), group)
    return out[:m, 0], out[:m, 1]
