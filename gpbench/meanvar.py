"""The comparison of served posterior means and variances with the
reference, shared by the serving drivers.

`outputs` holds the training inputs x and y (on the device), the compared
queries (host float64) and what the program served there (host arrays).
"""
from __future__ import annotations

import torch

from gpbench.reference import gp as ref


def numbers(outputs: dict, cfg: dict, dev, control: bool = False) -> dict:
    """mean_err: the largest gap of a served mean from the reference's, over
    the largest reference mean; var_err: the largest gap of a served
    variance, over the reference's sigma2. With control=True the answers
    are the reference's own in float32 with its serving products in TF32
    (`reference.gp.whitened_predict`)."""
    if len(outputs["mean"]) == 0:
        return {"mean_err": float("nan"), "var_err": float("nan")}
    delta = torch.full((cfg["d"],), cfg["delta"], dtype=torch.float64,
                       device=dev)
    x, y = outputs["x"].double(), outputs["y"].double()
    queries = torch.as_tensor(outputs["queries"], dtype=torch.float64,
                              device=dev)
    with ref.precision(False):
        f = ref.fit(x, y, delta, cfg["nugget"])
        mean_r, var_r = ref.predict(f, x, queries, delta)
        sigma2 = float(f.sigma2)
        del f
    if control:
        with ref.precision(True):
            f32 = ref.fit(x.float(), y.float(), delta.float(), cfg["nugget"])
            mean_p, var_p = ref.whitened_predict(f32, x.float(),
                                                 queries.float(), delta.float())
            del f32
        mean_p, var_p = mean_p.double(), var_p.double()
    else:
        mean_p = torch.as_tensor(outputs["mean"], dtype=torch.float64, device=dev)
        var_p = torch.as_tensor(outputs["var"], dtype=torch.float64, device=dev)
    return {
        "mean_err": float((mean_p - mean_r).abs().max() / mean_r.abs().max()),
        "var_err": float((var_p - var_r).abs().max() / sigma2),
    }
