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
          This product runs with TF32 off (`fp32_exact`); the JAX package
          computes it outside Pallas too.
The rotation after the last visit is skipped, so one rank sends nothing.
"""
from __future__ import annotations

import torch

from gp_emu_uqsa_torch import gp, kernels
from gp_emu_uqsa_torch.ops.precision import fp32_exact
from gp_emu_uqsa_torch.parallel.mesh import (
    axis_group, gather_group_rows, group_rank, group_size, shift,
)
from gp_emu_uqsa_torch.parallel.predict import pad_to_multiple, query_shard


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
    for _, rows in _rotations(w_rows, p, group):
        u = t @ rows.mT
        quad_t += torch.sum(u * u, 1)
    prior = 1.0 + (params.nugget if include_nugget else 0.0)
    var = pred.sigma2 * torch.clamp(prior - quad_t + quad_r, min=0.0)
    out = gather_group_rows(torch.stack([mean, var], 1), group)
    return out[:m, 0], out[:m, 1]
