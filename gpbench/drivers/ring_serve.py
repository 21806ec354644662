"""Closed-loop serving through `parallel.ring_predict` over the cell's
cards, from `parallel.fit_large` and `predictor_large`.

One rank a card (torchrun, NCCL). Set-up fits A's rows with the
distributed recursive Cholesky and builds W = L^-1 by rows
(`predictor_large`): no rank holds an (n, n) tensor. A request is `m`
queries U[0, 1]^d, drawn on the cards from the run's seed (the same stream
on every rank), served through `ring_predict` in calls of `chunk` queries
a rank, as `examples.large_scale` serves them; it ends when its whole mean
and variance are on every card. The mix's parameters
(traffic/<name>.json):

  m, chunk, block    request size, queries a rank a call, layout block
  sample_requests, sample_points
                     the comparison: that many requests drawn from the
                     seed (the last always among them), that many points
                     of each, drawn from the seed when the request is made

Rank 0 decides when the window closes and tells the others (one broadcast
a request, not counted in the bytes sent); rank 0 keeps the sample.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from gpbench import meanvar
from gpbench.harness import seed_words, synchronize
from gpbench.reference import data

STREAM_SAMPLE = 3


def _serve(state, xs, hs):
    from gp_emu_uqsa_torch.parallel import ring_predict

    per_call = state["per_call"]
    parts = [ring_predict(state["pred"], state["x"], xs[s:s + per_call],
                          hs[s:s + per_call], state["data_mesh"])
             for s in range(0, xs.shape[0], per_call)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _queries(state, ctx):
    from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis

    d = ctx.config["d"]
    xs = torch.rand((ctx.traffic["m"], d), generator=state["gen"],
                    device=ctx.device, dtype=state["x"].dtype)
    return xs, basis_matrix(xs, linear_basis(d))


def setup(ctx):
    from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
    from gp_emu_uqsa_torch.kernels import make_params
    from gp_emu_uqsa_torch.parallel import fit_large, make_mesh, predictor_large

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    p = ctx.world
    mesh = make_mesh({"mr": p}, device_type=dev.type)
    x, y = data.training_set(cfg, ctx.seed, dev)
    h = basis_matrix(x, linear_basis(cfg["d"]))
    params = make_params(np.full(cfg["d"], cfg["delta"]), nugget=cfg["nugget"],
                         dtype=x.dtype, device=dev)
    state = fit_large(params, x, y, h, mesh, block=tr["block"],
                      mode=cfg["likelihood"])
    out = {"x": x, "y": y, "per_call": tr["chunk"] * p,
           "pred": predictor_large(state, mesh, block=tr["block"]),
           "data_mesh": make_mesh({"data": p}, device_type=dev.type),
           "gen": torch.Generator(device=dev).manual_seed(ctx.seed % 2 ** 64)}
    _serve(out, *_queries(out, ctx))
    synchronize(dev)
    return out


def window(state, ctx):
    from gp_emu_uqsa_torch.parallel.mesh import traffic

    rng = np.random.default_rng(seed_words(ctx.seed, STREAM_SAMPLE))
    m = ctx.traffic["m"]
    served, latencies = [], []
    attempted = 0
    go = torch.ones(1, device=ctx.device)
    traffic.reset()
    t0 = time.perf_counter()
    while True:
        go.fill_(float(time.perf_counter() - t0 < ctx.seconds))
        if ctx.world > 1:
            dist.broadcast(go, 0)
        if not go.item():
            break
        attempted += 1
        xs, hs = _queries(state, ctx)
        start = time.perf_counter()
        with ctx.span("gpbench.request"):
            mean, var = _serve(state, xs, hs)
            synchronize(ctx.device)
        latencies.append(time.perf_counter() - start)
        if ctx.rank == 0:
            pick = torch.as_tensor(np.sort(rng.choice(
                m, size=min(m, ctx.traffic["sample_points"]), replace=False)),
                device=ctx.device)
            served.append((xs[pick].double().cpu().numpy(),
                           mean[pick].cpu().numpy(), var[pick].cpu().numpy()))
    window_s = time.perf_counter() - t0
    state["served"] = served
    cfg = ctx.config
    return {"attempted": attempted, "failed": 0, "window_s": window_s,
            "latencies_s": latencies, "sizes": [m] * len(latencies),
            "points": m * len(latencies), "bytes_sent": traffic.bytes,
            "n": cfg["n"], "d": cfg["d"], "q": cfg["d"] + 1}


def layer_timings(state, record, ctx):
    return {}


def release(state, record, ctx):
    """Rank 0 keeps the inputs and a sample of the requests' answers."""
    served = state.pop("served")
    rng = np.random.default_rng(seed_words(ctx.seed, STREAM_SAMPLE + 1))
    k = min(ctx.traffic["sample_requests"], len(served))
    chosen = [len(served) - 1] + [int(i) for i in rng.choice(
        len(served) - 1, size=max(k - 1, 0), replace=False)] if k else []
    cat = (lambda j: np.concatenate([served[i][j] for i in chosen])
           if chosen else np.zeros(0))
    outputs = {"x": state["x"], "y": state["y"], "queries": cat(0),
               "mean": cat(1), "var": cat(2)}
    state.clear()
    return outputs


def check(outputs, ctx, control=False):
    return meanvar.numbers(outputs, ctx.config, ctx.device, control)
