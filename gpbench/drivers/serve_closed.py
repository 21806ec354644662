"""Closed-loop serving of mean and variance through `Emulator.predict`.

One client sends a request, waits until its mean and variance are on the
host, and sends the next. The mix's parameters (traffic/<name>.json):

  m_min, m_max     request sizes: `sizes` values log-uniform over
                   [m_min, m_max] (the quantiles (i + 1/2) / sizes), the
                   same set for every seed, visited in an order drawn from
                   the seed and again in a new order when used up
  pool             queries are slices of one pool of that many points
                   U[0, 1]^d, drawn from the seed on the host in set-up; a
                   request takes m consecutive points at an offset drawn
                   from the seed (host float64 arrays, as a user holds them)
  warm             request sizes served once in set-up
  sample_requests, sample_points
                   the comparison: that many completed requests drawn from
                   the seed (the largest always among them), that many
                   points of each

The emulator is fitted in set-up at the configuration's hyperparameters
(`gp.fit`); its first request builds the serving predictor (W = L^-1).
"""
from __future__ import annotations

import sys
import time

import numpy as np

from gpbench.harness import seed_words, synchronize
from gpbench import meanvar
from gpbench.reference import data

STREAM_SCHEDULE, STREAM_POOL, STREAM_SAMPLE = 1, 2, 3


def _sizes(traffic: dict) -> np.ndarray:
    k = traffic["sizes"]
    q = (np.arange(k) + 0.5) / k
    lo, hi = np.log(traffic["m_min"]), np.log(traffic["m_max"])
    return np.floor(np.exp(lo + (hi - lo) * q)).astype(np.int64)


class Schedule:
    """Request sizes and offsets, drawn from the seed."""

    def __init__(self, traffic: dict, seed: int):
        self.sizes = _sizes(traffic)
        self.pool = traffic["pool"]
        self.rng = np.random.default_rng(seed_words(seed, STREAM_SCHEDULE))
        self.order = []

    def next(self):
        if not self.order:
            self.order = list(self.rng.permutation(self.sizes))
        m = int(self.order.pop())
        offset = int(self.rng.integers(0, self.pool - m + 1))
        return m, offset


def setup(ctx):
    from gp_emu_uqsa_torch import Emulator, gp
    from gp_emu_uqsa_torch.kernels import make_params

    cfg, dev = ctx.config, ctx.device
    x, y = data.training_set(cfg, ctx.seed, dev)
    emul = Emulator.from_arrays(
        x.cpu().numpy(), y.cpu().numpy(), tv_config=(1, 0, 0), shuffle=False,
        scale_inputs=False, nugget=cfg["nugget"], dtype=data.DTYPES[cfg["dtype"]],
        device=dev)
    emul.params = make_params(np.full(cfg["d"], cfg["delta"]),
                              nugget=cfg["nugget"], dtype=emul.dtype,
                              device=dev)
    xt, yt, ht = emul.train_view()
    emul.state = gp.fit(emul.params, xt, yt, ht, mode=cfg["likelihood"])
    rng = np.random.default_rng(seed_words(ctx.seed, STREAM_POOL))
    pool = rng.uniform(size=(ctx.traffic["pool"], cfg["d"]))
    for m in ctx.traffic["warm"]:
        mean, var = emul.predict(pool[:m])
        mean.cpu().numpy(), var.cpu().numpy()
    synchronize(dev)
    return {"emul": emul, "pool": pool, "x": x, "y": y,
            "schedule": Schedule(ctx.traffic, ctx.seed)}


def window(state, ctx):
    emul, pool, schedule = state["emul"], state["pool"], state["schedule"]
    served, latencies = [], []
    attempted = failed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        m, offset = schedule.next()
        queries = pool[offset:offset + m]
        attempted += 1
        start = time.perf_counter()
        try:
            with ctx.span("gpbench.request"):
                mean, var = emul.predict(queries)
                mean, var = mean.cpu().numpy(), var.cpu().numpy()
        except RuntimeError as exc:
            failed += 1
            print(f"request of {m} points failed: {exc}", file=sys.stderr)
            continue
        latencies.append(time.perf_counter() - start)
        served.append((offset, m, mean, var))
    synchronize(ctx.device)
    window_s = time.perf_counter() - t0
    return {"attempted": attempted, "failed": failed, "window_s": window_s,
            "latencies_s": latencies, "sizes": [s[1] for s in served],
            "points": sum(s[1] for s in served), "served": served,
            "n": ctx.config["n"], "d": ctx.config["d"],
            "q": ctx.config["d"] + 1}


def layer_timings(state, record, ctx):
    return {}


def release(state, record, ctx):
    """Keep the inputs and a sample of the served answers; drop the emulator."""
    rng = np.random.default_rng(seed_words(ctx.seed, STREAM_SAMPLE))
    served = record.pop("served")
    k = min(ctx.traffic["sample_requests"], len(served))
    chosen = []
    if k:
        largest = int(np.argmax([s[1] for s in served]))
        rest = [i for i in range(len(served)) if i != largest]
        chosen = [largest] + [int(i) for i in
                              rng.choice(rest, size=k - 1, replace=False)]
    rows, means, variances = [], [], []
    for i in chosen:
        offset, m, mean, var = served[i]
        pick = np.sort(rng.choice(m, size=min(m, ctx.traffic["sample_points"]),
                                  replace=False))
        rows.append(offset + pick)
        means.append(mean[pick])
        variances.append(var[pick])
    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    outputs = {"x": state["x"], "y": state["y"], "queries": state["pool"][rows],
               "mean": np.concatenate(means) if means else np.zeros(0),
               "var": np.concatenate(variances) if variances else np.zeros(0)}
    state.clear()
    return outputs


def check(outputs, ctx, control=False):
    return meanvar.numbers(outputs, ctx.config, ctx.device, control)
