"""Sharded batched prediction over the `data` mesh axis.

Port of `gp_emu_uqsa_tpu.parallel.predict`. Prediction is row-parallel in
the query points: each rank takes a contiguous shard of X*, runs the port's
`gp.predict` on it against the replicated fit state (on the card in fp32
that builds c(X*, X) with kernel K2), and the shards' means and variances
are gathered. No other collective is needed.

Replicating the fit state, and its (n, n) factor, on every rank is this
function's trade-off and holds while the training set fits on one card.
Past that the serving path is `large_fit.predictor_large` (W = L^-1 by
rows) with `ring.ring_predict` (training blocks rotating around the ring).
"""
from __future__ import annotations

import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.ops.precision import fp32_exact
from gp_emu_uqsa_torch.parallel.mesh import (
    axis_group, gather_group_rows, group_rank, group_size,
)


def pad_to_multiple(a: torch.Tensor, mult: int, axis: int = 0):
    """Pad with zeros along `axis` so `mult` divides it; (padded, n_orig)."""
    n = a.shape[axis]
    rem = (-n) % mult
    if rem == 0:
        return a, n
    shape = list(a.shape)
    shape[axis] = rem
    return torch.cat([a, a.new_zeros(shape)], dim=axis), n


def query_shard(t: torch.Tensor, group):
    """This rank's contiguous shard of t's rows, t padded so the ranks
    divide it; (shard, n_orig)."""
    p = group_size(group)
    t_p, n = pad_to_multiple(t, p)
    s = t_p.shape[0] // p
    me = group_rank(group)
    return t_p[me * s:(me + 1) * s], n


@fp32_exact
def predict_sharded(state: gp.FitState, x, h, xstar, hstar, mesh, *,
                    axis: str = "data", include_nugget: bool = False,
                    family: str = "gaussian"):
    """Posterior mean/var at xstar, the query rows sharded over `axis`.

    The training arrays and the fit state are replicated. Returns the whole
    (mean, var) of len(xstar) on every rank.
    """
    group = axis_group(mesh, axis)
    xs, m = query_shard(xstar, group)
    hs, _ = query_shard(hstar, group)
    mean, var = gp.predict(state, x, h, xs, hs,
                           include_nugget=include_nugget, family=family)
    out = gather_group_rows(torch.stack([mean, var], 1), group)
    return out[:m, 0], out[:m, 1]
