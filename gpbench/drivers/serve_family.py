"""Closed-loop serving of mean and variance through `Emulator.predict`, for
an emulator of any correlation family.

`serve_closed` with the configuration's `correlation` passed to the
emulator and its fit, and the configuration's `reference` (a file of
gpbench/reference/ with `fit`, `predict`, `whitened_predict` and
`precision`, as `reference/gp.py`) in the comparison. The schedule, the
window and the sample that is compared are `serve_closed`'s, with the same
traffic parameters. The record also holds the window's K3 and K4 launches
and rebuilt (query, training point) pairs by family (`launches`: the
wrappers' `family_launches` and `family_pairs` counters, empty where the
program has none), which also go to standard error, so each run shows the
tier that served it.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from gpbench.drivers import serve_closed
from gpbench.harness import load_module, seed_words, synchronize
from gpbench.reference import data

ROOT = Path(__file__).resolve().parents[2]
layer_timings = serve_closed.layer_timings
release = serve_closed.release
WRAPPERS = ("corr_matvec", "corr_quad")
COUNTERS = ("family_launches", "family_pairs")


def setup(ctx):
    from gp_emu_uqsa_torch import Emulator, gp
    from gp_emu_uqsa_torch.kernels import make_params

    cfg, dev = ctx.config, ctx.device
    x, y = data.training_set(cfg, ctx.seed, dev)
    emul = Emulator.from_arrays(
        x.cpu().numpy(), y.cpu().numpy(), tv_config=(1, 0, 0), shuffle=False,
        scale_inputs=False, kernel=cfg["correlation"], nugget=cfg["nugget"],
        dtype=data.DTYPES[cfg["dtype"]], device=dev)
    emul.params = make_params(np.full(cfg["d"], cfg["delta"]),
                              nugget=cfg["nugget"], dtype=emul.dtype,
                              device=dev)
    xt, yt, ht = emul.train_view()
    emul.state = gp.fit(emul.params, xt, yt, ht, mode=cfg["likelihood"],
                        family=cfg["correlation"])
    rng = np.random.default_rng(seed_words(ctx.seed, serve_closed.STREAM_POOL))
    pool = rng.uniform(size=(ctx.traffic["pool"], cfg["d"]))
    for m in ctx.traffic["warm"]:
        mean, var = emul.predict(pool[:m])
        mean.cpu().numpy(), var.cpu().numpy()
    synchronize(dev)
    return {"emul": emul, "pool": pool, "x": x, "y": y,
            "schedule": serve_closed.Schedule(ctx.traffic, ctx.seed)}


def launch_counts() -> dict:
    """{"corr_quad.family_pairs": {family: count}, ...} from the serving
    wrappers' counters; {} for a program without them."""
    from gp_emu_uqsa_torch.ops import serve

    out = {}
    for name in WRAPPERS:
        for key in COUNTERS:
            counts = getattr(getattr(serve, name, None), key, None)
            if isinstance(counts, dict):
                out[f"{name}.{key}"] = dict(counts)
    return out


def window(state, ctx):
    before = launch_counts()
    record = serve_closed.window(state, ctx)
    after = launch_counts()
    record["launches"] = {
        key: {f: n - before[key].get(f, 0) for f, n in counts.items()}
        for key, counts in after.items()}
    print(f"launches in the window: {record['launches']}", file=sys.stderr)
    return record


def numbers(outputs: dict, cfg: dict, dev, ref, control: bool = False) -> dict:
    """`meanvar.numbers` against the reference module `ref`: mean_err, the
    largest gap of a served mean from the reference's over the largest
    reference mean; var_err, the largest gap of a served variance over the
    reference's sigma2. With control=True the answers are the reference's
    own in float32 with its serving products in TF32."""
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


def check(outputs, ctx, control=False):
    ref = load_module(ROOT / ctx.config["reference"])
    return numbers(outputs, ctx.config, ctx.device, ref, control)
