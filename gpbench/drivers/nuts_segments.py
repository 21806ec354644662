"""NUTS over the GP hyperparameters: chains in lockstep, segments back to back.

The system under test is `inference.nuts` over `inference.hmc.
make_gp_logdensity` (the batched concentrated likelihood, `gp._NllMucm`,
K1 a chain on the card). The mix's parameters (traffic/<name>.json):

  chains, start_sd   chains started at log delta ~ N(0, start_sd^2)
  warmup, warmup_depth, warmup_seed
                     burn-in in set-up, the set-up the traffic needs:
                     `nuts_sample`'s warmup from starts and draws of a
                     generator seeded with warmup_seed; its adapted step
                     size and metric are not used
  step_size, inv_mass
                     the kernel the window samples with: fixed here, so
                     that every run does the same work a draw and the
                     replay needs nothing of the program's adaptation
  segment, max_depth the window runs `nuts_continue` segments of `segment`
                     draws at `max_depth` back to back, from a generator
                     seeded with the run's seed; the segment running at
                     the deadline finishes and counts
  compare_draws      how many more of the last segment's transitions, drawn
                     from the seed, have their log density compared

The comparison, on the last segment: the log density that the window
computed where its transitions start (the segment's start and
`compare_draws` more), at the window's batch of chains, against the
reference's there; and the segment's first transition replayed by the
reference from the same start, kernel and draws, judged chain by chain
(each leapfrog step takes the gradient, so the replay judges it too).
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from gpbench.harness import device_ms, seed_words, synchronize
from gpbench.reference import data
from gpbench.reference import gp as ref
from gpbench.reference import nuts as ref_nuts

STREAM_SAMPLE = 3
# A chain's replayed proposal is off when it lies this far (log delta)
# from the reference's: float32 trajectories drift up to about 3e-3, a
# chain sent to another leaf or left in place moves by a leapfrog step.
OFF_TOL = 0.01


def setup(ctx):
    from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
    from gp_emu_uqsa_torch.inference import MLEConfig
    from gp_emu_uqsa_torch.inference.hmc import HMCConfig, make_gp_logdensity
    from gp_emu_uqsa_torch.inference.nuts import nuts_sample

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    x, y = data.training_set(cfg, ctx.seed, dev)
    h = basis_matrix(x, linear_basis(cfg["d"]))
    logdensity = make_gp_logdensity(
        x, y, h, MLEConfig(mode=cfg["likelihood"], nugget=cfg["nugget"]),
        prior_scale=cfg["prior_scale"])
    warm_gen = torch.Generator(device=dev).manual_seed(tr["warmup_seed"])
    z0 = tr["start_sd"] * torch.randn((tr["chains"], cfg["d"]),
                                      generator=warm_gen, device=dev,
                                      dtype=x.dtype)
    warm, _ = nuts_sample(warm_gen, logdensity, z0,
                          HMCConfig(n_warmup=tr["warmup"], n_samples=1),
                          max_depth=tr["warmup_depth"])
    synchronize(dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % 2 ** 64)
    kernel = dict(dtype=x.dtype, device=dev)
    return {"x": x, "y": y, "logdensity": logdensity, "gen": gen,
            "z": warm[:, -1], "eps": torch.tensor(tr["step_size"], **kernel),
            "inv_mass": torch.tensor(tr["inv_mass"], **kernel)}


def _recorded(logdensity, log: list):
    """logdensity, keeping each call's positions and values in `log`:
    references to what the sampler computed, with no copy and no sync."""
    def call(z):
        v = logdensity(z)
        log.append((z.detach(), v.detach()))
        return v
    return call


def window(state, ctx):
    from gp_emu_uqsa_torch.inference.nuts import nuts_continue

    tr = ctx.traffic
    gen, z = state["gen"], state["z"]
    segments = []
    attempted = failed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        attempted += 1
        before, evals = (gen.get_state(), z), []
        with ctx.span("gpbench.segment"):
            draws, stats, gen = nuts_continue(
                gen, _recorded(state["logdensity"], evals), z, state["eps"],
                state["inv_mass"], tr["segment"], max_depth=tr["max_depth"])
        z = draws[:, -1]
        segments.append((before, draws, stats["counts"], evals))
    synchronize(ctx.device)
    window_s = time.perf_counter() - t0
    counts = {}
    for c in (s[2] for s in segments):
        for key, value in c.items():
            counts[key] = counts.get(key, 0) + int(value)
    state["segments"] = segments
    cfg = ctx.config
    return {"attempted": attempted, "failed": failed, "window_s": window_s,
            "draws": tr["chains"] * tr["segment"] * len(segments),
            "counts": counts, "chains": tr["chains"], "n": cfg["n"],
            "d": cfg["d"], "q": cfg["d"] + 1}


def layer_timings(state, record, ctx):
    from gp_emu_uqsa_torch.inference.hmc import value_and_grad

    z = state["segments"][-1][1][:, -1]
    ms = device_ms(lambda: value_and_grad(state["logdensity"], z), ctx.device)
    return {"logdensity_ms": ms}


def _transition_starts(evals, starts):
    """For each position a transition started from, in order, the window's
    evaluation there (its first), or None where no evaluation was made
    there."""
    found, i = [], 0
    for z in starts:
        while i < len(evals) and not torch.equal(evals[i][0], z):
            i += 1
        found.append(evals[i] if i < len(evals) else None)
        i += 1
    return found


def release(state, record, ctx):
    """Keep the inputs, the last segment's compared evaluations as the
    window made them and its first transition's start, draws and proposal;
    drop the sampler."""
    tr = ctx.traffic
    (gen_state, z_start), draws, _, evals = state["segments"][-1]
    starts = [z_start] + [draws[:, k] for k in range(tr["segment"] - 1)]
    rng = np.random.default_rng(seed_words(ctx.seed, STREAM_SAMPLE))
    picks = [0] + sorted(rng.choice(np.arange(1, tr["segment"]),
                                    tr["compare_draws"], replace=False).tolist())
    found = _transition_starts(evals, starts)
    positions, values = [], []
    for k in picks:
        entry = found[k]
        if entry is None:   # the window never evaluated there
            entry = (starts[k], torch.full_like(starts[k][:, 0], math.nan))
        positions.append(entry[0])
        values.append(entry[1])
    outputs = {"x": state["x"], "y": state["y"],
               "positions": torch.cat(positions), "values": torch.cat(values),
               "gen_state": gen_state,
               "z_start": z_start, "proposal": draws[:, 0],
               "all_draws": torch.cat([s[1] for s in state["segments"]], 1),
               "eps": state["eps"], "inv_mass": state["inv_mass"]}
    state.clear()
    return outputs


def _replay_draws(gen_state, z, max_depth, device):
    """The transition's draws, taken from the run's generator restored to
    its state before the segment, in the sampler's order: the momenta, then
    a (chains, max_depth, 2 + 2^(max_depth-1)) block of uniforms whose
    columns are the direction bit, the subtree merge and the leaves."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    chains = z.shape[0]
    r0 = torch.randn(z.shape, generator=gen, dtype=z.dtype, device=device)
    u = torch.rand((chains, max_depth, 2 + (1 << (max_depth - 1))),
                   generator=gen, dtype=z.dtype, device=device)
    return r0, u[:, :, 0] < 0.5, u[:, :, 1], u[:, :, 2:]


def check(outputs, ctx, control=False):
    """logdensity_gap: the largest gap of the window's log density from the
    reference's at the compared transition starts (nats); chains_off_pct:
    the share of chains whose replayed proposal lies more than OFF_TOL from
    the reference's; nonfinite_draws: draws of the window that are not
    finite. With
    control=True the reference in float32 with TF32 products stands in for
    the program."""
    cfg, dev = ctx.config, ctx.device
    nugget = cfg["nugget"]
    x64, y64 = outputs["x"].double(), outputs["y"].double()
    pos = outputs["positions"].double()
    max_depth = ctx.traffic["max_depth"]
    r0, go_right, u_sub, u_leaf = _replay_draws(
        outputs["gen_state"], outputs["z_start"], max_depth, dev)

    def replay(xs, ys, dtype):
        return ref_nuts.transition(
            lambda z: ref.logdensity_and_grad(z, xs, ys, nugget),
            outputs["z_start"].to(dtype), r0.to(dtype), go_right,
            u_sub.to(dtype), u_leaf.to(dtype), outputs["eps"].to(dtype),
            outputs["inv_mass"].to(dtype), max_depth).double()

    with ref.precision(False):
        v_ref, _ = ref.logdensity_and_grad(pos, x64, y64, nugget)
        z_ref = replay(x64, y64, torch.float64)
    if control:
        with ref.precision(True):
            x32, y32 = outputs["x"].float(), outputs["y"].float()
            v, _ = ref.logdensity_and_grad(pos.float(), x32, y32, nugget)
            proposal = replay(x32, y32, torch.float32)
        v = v.double()
    else:
        v = outputs["values"].double()
        proposal = outputs["proposal"].double()
    off = (proposal - z_ref).abs().amax(-1)
    return {
        "logdensity_gap": float((v - v_ref).abs().max()),
        "chains_off_pct": 100.0 * float((off > OFF_TOL).double().mean()),
        "nonfinite_draws": float((~torch.isfinite(outputs["all_draws"])).sum()),
    }
