"""Multi-restart maximum-likelihood hyperparameter fitting.

Port of `gp_emu_uqsa_tpu.inference.lbfgs`. The reference runs `tries`
scipy L-BFGS-B fits from Latin-hypercube starts, one after another; the
JAX package advances all restarts in lockstep under `jax.vmap`. So does
the port: every restart sits on a leading batch axis, each objective
evaluation builds A for all of them (K1 on the card), factors them in one
batched Cholesky and takes its gradient from the analytic adjoint
(`gp._NllMucm`).

The optimizer is optax 0.2.6's `optax.lbfgs()` step for step, in torch:
memory 10 with the scaled initial preconditioner, then the zoom linesearch
(`scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')` with optax's default tolerances). A restart
that has stopped, or that has found its step while others still search,
is masked, not dropped: it neither moves nor touches the others' memory,
as under `vmap`. The loop reads its stop tests on the host once per
iteration and once per linesearch step, and evaluates only the restarts
still running.

Bounds are enforced by a sigmoid map of log space, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.kernels import GPParams
from gp_emu_uqsa_torch.parallel.mesh import (
    all_gather, axis_group, group_rank, group_size,
)

# optax.lbfgs() and its zoom linesearch, with optax 0.2.6's defaults
MEMORY = 10
LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0


@dataclasses.dataclass(frozen=True)
class MLEConfig:
    """Hyperparameter-fit configuration (reference config-file surface).

    delta/sigma/nugget bounds are in NATURAL space, like the reference's
    `delta_bounds`/`sigma_bounds` config entries; None => wide defaults.
    """

    mode: str = "mucm"                # "mucm" (sigma2 profiled) or "gp4ml"
    family: str = "gaussian"          # correlation family (kernels.CORR_FAMILIES)
    tries: int = 8                    # restarts (reference `tries`)
    max_iters: int = 200
    tol: float = 1e-8                 # gradient-norm stop
    train_nugget: bool = False        # reference `fix_nugget F/T`
    nugget: float = 1e-8              # value when fixed
    delta_bounds: Optional[tuple] = None    # (lo, hi) scalars or (d,) arrays
    sigma_bounds: Optional[tuple] = None
    nugget_bounds: Optional[tuple] = None
    constraints: str = "bounds"       # "bounds" | "none" (reference `constraints`)


def _default_bounds(cfg: MLEConfig, d: int):
    db = cfg.delta_bounds if cfg.delta_bounds is not None else (1e-3, 1e3)
    sb = cfg.sigma_bounds if cfg.sigma_bounds is not None else (1e-6, 1e6)
    nb = cfg.nugget_bounds if cfg.nugget_bounds is not None else (1e-10, 1e0)
    # each bound may be a scalar or a per-dim vector (reference per-dim lists)
    lo = [np.broadcast_to(np.log(np.asarray(db[0], np.float64)), (d,))]
    hi = [np.broadcast_to(np.log(np.asarray(db[1], np.float64)), (d,))]
    if cfg.mode == "gp4ml":
        # sigma bound is on sigma (std dev) in the reference; optimize log sigma2
        lo.append(2.0 * np.log(np.ravel(np.asarray(sb[0], np.float64)))[:1])
        hi.append(2.0 * np.log(np.ravel(np.asarray(sb[1], np.float64)))[:1])
    if cfg.train_nugget:
        lo.append(np.log(np.ravel(np.asarray(nb[0], np.float64)))[:1])
        hi.append(np.log(np.ravel(np.asarray(nb[1], np.float64)))[:1])
    return np.concatenate(lo), np.concatenate(hi)


def _unpack(z: torch.Tensor, cfg: MLEConfig, d: int, dtype) -> GPParams:
    """Optimization vectors (..., p) -> GPParams with the batch axes."""
    batch = z.shape[:-1]
    log_delta = z[..., :d]
    i = d
    if cfg.mode == "gp4ml":
        log_sigma2 = z[..., i]
        i += 1
    else:
        log_sigma2 = torch.zeros(batch, dtype=dtype, device=z.device)
    if cfg.train_nugget:
        log_nugget = z[..., i]
    else:
        log_nugget = torch.full(batch, float(np.log(cfg.nugget)), dtype=dtype,
                                device=z.device)
    return GPParams(log_delta, log_sigma2, log_nugget)


def _make_objective(x, y, h, cfg: MLEConfig, lo, hi, noise_diag=None):
    """(objective, to_logspace, from_logspace); objective(u, rows=None) maps
    u (b, p) to the b NLLs, differentiably.

    y is (n,), shared by every restart, or (B, n), one row a restart (the
    outputs x restarts grid of `multi.MultiEmulator`): then `rows`, the
    indices of u's rows among the B restarts, picks y's rows, and u covers
    all B when rows is None.
    """
    d = x.shape[1]
    dtype = x.dtype
    use_bounds = cfg.constraints != "none"
    lo = torch.as_tensor(lo, dtype=dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=dtype, device=x.device)

    def to_logspace(u):
        if use_bounds:
            return lo + (hi - lo) * torch.sigmoid(u)
        return u

    def from_logspace(z):
        if use_bounds:
            frac = torch.clamp((z - lo) / (hi - lo), 1e-4, 1 - 1e-4)
            return torch.log(frac) - torch.log1p(-frac)
        return z

    def objective(u, rows=None):
        params = _unpack(to_logspace(u.to(dtype)), cfg, d, dtype)
        y_rows = y if rows is None or y.ndim == 1 else y[rows]
        return gp.nll(params, x, y_rows, h, mode=cfg.mode,
                      noise_diag=noise_diag, family=cfg.family)

    return objective, to_logspace, from_logspace


def value_and_grad(objective, u: torch.Tensor):
    """(values (B,), gradients (B, p)) of a batched objective at u (B, p).

    Rows whose value is not finite get a zero gradient.
    """
    with torch.enable_grad():
        u = u.detach().requires_grad_(True)
        v = objective(u)
        (g,) = torch.autograd.grad(v.sum(), u)
    v = v.detach()
    return v, torch.where(torch.isfinite(v)[:, None], g, torch.zeros_like(g))


def _lhc_starts(generator: torch.Generator, tries: int, lo, hi, dtype):
    """Latin-hypercube starts in the log-space box (reference behavior).

    Drawn on the CPU from `generator` in fp64, one stratum per restart and
    column; the draws differ from `jax.random`'s.
    """
    lo = torch.as_tensor(lo, dtype=torch.float64)
    hi = torch.as_tensor(hi, dtype=torch.float64)
    p = lo.shape[0]
    u = torch.rand((tries, p), generator=generator, dtype=torch.float64)
    perms = torch.stack([torch.randperm(tries, generator=generator)
                         for _ in range(p)], dim=1)          # (tries, p)
    strat = (perms.to(torch.float64) + u) / tries
    return (lo + (hi - lo) * strat).to(dtype)


# ----- optax.scale_by_lbfgs, batched ----------------------------------------

def _lbfgs_init(b: int, p: int, like: torch.Tensor) -> dict:
    zeros = torch.zeros((b, p), dtype=like.dtype, device=like.device)
    return {
        "count": torch.zeros(b, dtype=torch.int64, device=like.device),
        "params": zeros, "updates": zeros.clone(),
        "dw": torch.zeros((b, MEMORY, p), dtype=like.dtype, device=like.device),
        "du": torch.zeros((b, MEMORY, p), dtype=like.dtype, device=like.device),
        "rho": torch.zeros((b, MEMORY), dtype=like.dtype, device=like.device),
    }


def _lbfgs_update(state: dict, z: torch.Tensor, grad: torch.Tensor):
    """`optax.scale_by_lbfgs(memory_size=10, scale_init_precond=True)` for
    every row: (preconditioned gradient (B, p), new state)."""
    b = z.shape[0]
    rows = torch.arange(b, device=z.device)
    count = state["count"]
    first = (count == 0)[:, None]
    mem = count % MEMORY
    prev = (count - 1) % MEMORY
    # 1. memory of parameter and gradient differences
    dw = z - state["params"]
    du = grad - state["updates"]
    vdot = torch.sum(du * dw, -1)
    weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
    dw = torch.where(first, torch.zeros_like(dw), dw)
    du = torch.where(first, torch.zeros_like(du), du)
    weight = torch.where(first[:, 0], torch.zeros_like(weight), weight)
    dw_mem, du_mem, rho = state["dw"].clone(), state["du"].clone(), \
        state["rho"].clone()
    dw_mem[rows, prev] = dw
    du_mem[rows, prev] = du
    rho[rows, prev] = weight
    # 2. scale of the initial inverse Hessian; a capped 1/|g| at step 0
    num = torch.sum(du * dw, -1)
    den = torch.sum(du * du, -1)
    scale = torch.where(den > 0.0, num / den, torch.ones_like(num))
    capped = torch.clamp(1.0 / torch.linalg.vector_norm(grad, dim=-1), max=1.0)
    scale = torch.where(first[:, 0], capped, scale)
    # 3. two-loop recursion from the oldest slot (mem) round the ring
    order = (mem[:, None] + torch.arange(MEMORY, device=z.device)) % MEMORY
    vec = grad
    alphas = [None] * MEMORY
    for k in reversed(range(MEMORY)):
        j = order[:, k]
        alphas[k] = rho[rows, j] * torch.sum(dw_mem[rows, j] * vec, -1)
        vec = vec - alphas[k][:, None] * du_mem[rows, j]
    vec = scale[:, None] * vec
    for k in range(MEMORY):
        j = order[:, k]
        beta = rho[rows, j] * torch.sum(du_mem[rows, j] * vec, -1)
        vec = vec + (alphas[k] - beta)[:, None] * dw_mem[rows, j]
    new = {"count": count + 1, "params": z, "updates": grad, "dw": dw_mem,
           "du": du_mem, "rho": rho}
    return vec, new


# ----- optax.zoom_linesearch, batched ---------------------------------------

def _decrease_error(step, value, slope, value_init, slope_init):
    """Armijo, or Hager-Zhang's approximate decrease near a minimum."""
    dec = value - value_init - SLOPE_RTOL * step * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    dec = torch.minimum(torch.maximum(approx, delta_values), dec)
    dec = torch.clamp(dec, min=0.0)
    return torch.where(torch.isnan(dec), torch.full_like(dec, float("inf")),
                       dec)


def _curvature_error(slope, slope_init):
    curv = torch.clamp(torch.abs(slope) - CURV_RTOL * torch.abs(slope_init),
                       min=0.0)
    return torch.where(torch.isnan(curv), torch.full_like(curv, float("inf")),
                       curv)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none (optax's `_cubicmin`)."""
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r0 = fb - fa - fpa * db
    r1 = fc - fa - fpa * dc
    coef_a = (dc * dc * r0 + -(db * db) * r1) / denom
    coef_b = (-(dc * dc * dc) * r0 + db * db * db * r1) / denom
    radical = coef_b * coef_b - 3.0 * coef_a * fpa
    return a + (-coef_b + torch.sqrt(radical)) / (3.0 * coef_a)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax's `_quadmin`)."""
    db = b - a
    coef_b = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * coef_b)


def _where(mask, new: dict, old: dict) -> dict:
    """Row-wise select of two states with the same keys."""
    out = {}
    for k, v in old.items():
        m = mask if v.ndim == 1 else mask[:, None]
        out[k] = torch.where(m, new[k], v)
    return out


def _zoom_linesearch(vg, z, direction, value, grad, rows):
    """optax's zoom linesearch for a batch of rows in lockstep.

    vg(points (b, p), their rows among the restarts) -> (values,
    gradients); `rows` are z's. Returns the stepsize, value and gradient
    each row ends at (after the safe-step rule on failure).
    """
    b = z.shape[0]
    zeros = torch.zeros(b, dtype=z.dtype, device=z.device)
    inf = torch.full_like(zeros, float("inf"))
    false = torch.zeros(b, dtype=torch.bool, device=z.device)
    slope = torch.sum(direction * grad, -1)
    value_init, slope_init = value, slope
    st = {
        "count": torch.zeros(b, dtype=torch.int64, device=z.device),
        "stepsize": zeros, "value": value, "grad": grad, "slope": slope,
        "decrease_error": inf, "curvature_error": inf, "error": inf,
        "interval_found": false, "done": false, "failed": false,
        "low": zeros, "value_low": value, "slope_low": slope,
        "high": zeros, "value_high": value, "slope_high": slope,
        "cubic_ref": zeros, "value_cubic_ref": value,
        "safe_stepsize": zeros, "safe_value": value, "safe_grad": grad,
    }
    while True:
        running = torch.nonzero(~(st["done"] | st["failed"])).flatten()
        if running.numel() == 0:
            break
        s = {k: v[running] for k, v in st.items()}
        v0, s0 = value_init[running], slope_init[running]
        # the point to try: the interval search's next stepsize, or the
        # zoom's cubic / quadratic / bisection point
        lo, hi = s["low"], s["high"]
        width = torch.abs(hi - lo)
        left, right = torch.minimum(hi, lo), torch.maximum(hi, lo)
        mid_cubic = _cubicmin(lo, s["value_low"], s["slope_low"], hi,
                              s["value_high"], s["cubic_ref"],
                              s["value_cubic_ref"])
        use_cubic = ((mid_cubic > left + 0.2 * width)
                     & (mid_cubic < right - 0.2 * width))
        mid_quad = _quadmin(lo, s["value_low"], s["slope_low"], hi,
                            s["value_high"])
        use_quad = (~use_cubic & (mid_quad > left + 0.1 * width)
                    & (mid_quad < right - 0.1 * width))
        use_bisect = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, mid_cubic, s["cubic_ref"])
        middle = torch.where(use_quad, mid_quad, middle)
        middle = torch.where(use_bisect, (lo + hi) / 2.0, middle)
        larger = torch.where(s["count"] == 0, torch.ones_like(lo),
                             INCREASE_FACTOR * s["stepsize"])
        zoom = s["interval_found"]
        step = torch.where(zoom, middle, larger)

        val, g = vg(z[running] + step[:, None] * direction[running],
                    rows[running])
        sl = torch.sum(g * direction[running], -1)
        dec = _decrease_error(step, val, sl, v0, s0)
        curv = _curvature_error(sl, s0)
        err = torch.maximum(dec, curv)
        last = s["count"] + 1 >= LINESEARCH_STEPS
        common = {"count": s["count"] + 1, "stepsize": step, "value": val,
                  "grad": g, "slope": sl, "decrease_error": dec,
                  "curvature_error": curv, "error": err}

        # interval search (Nocedal and Wright, Algorithm 3.5)
        take = dec <= 0.0
        safe_s = _where(take, {"safe_stepsize": step, "safe_value": val,
                               "safe_grad": g},
                        {k: s[k] for k in ("safe_stepsize", "safe_value",
                                           "safe_grad")})
        set_high = (dec > 0.0) | ((val >= s["value"]) & (s["count"] > 0))
        set_low = (sl >= 0.0) & ~set_high
        prev = {"low": s["stepsize"], "value_low": s["value"],
                "slope_low": s["slope"], "high": step, "value_high": val,
                "slope_high": sl}
        swapped = {"low": step, "value_low": val, "slope_low": sl,
                   "high": s["stepsize"], "value_high": s["value"],
                   "slope_high": s["slope"]}
        bracket = _where(set_low, swapped, prev)
        done_s = err <= 0.0
        search = {**common, **bracket, **safe_s,
                  "interval_found": set_high | set_low | done_s,
                  "done": done_s, "failed": last & ~done_s,
                  "cubic_ref": bracket["low"],
                  "value_cubic_ref": bracket["value_low"]}

        # zoom (Algorithm 3.6)
        take = (dec <= 0.0) & (val < s["safe_value"])
        safe_z = _where(take, {"safe_stepsize": step, "safe_value": val,
                               "safe_grad": g},
                        {k: s[k] for k in ("safe_stepsize", "safe_value",
                                           "safe_grad")})
        done_z = err <= 0.0
        high_to_mid = (dec > 0.0) | (val >= s["value_low"])
        high_to_low = (sl * (hi - lo) >= 0.0) & ~high_to_mid
        cur_high = {"high": hi, "value_high": s["value_high"],
                    "slope_high": s["slope_high"]}
        cur_low = {"low": lo, "value_low": s["value_low"],
                   "slope_low": s["slope_low"]}
        new_high = _where(high_to_mid, {"high": step, "value_high": val,
                                        "slope_high": sl}, cur_high)
        new_high = _where(high_to_low, {"high": lo, "value_high": s["value_low"],
                                        "slope_high": s["slope_low"]}, new_high)
        new_low = _where(~high_to_mid, {"low": step, "value_low": val,
                                        "slope_low": sl}, cur_low)
        ref = _where(high_to_mid | high_to_low,
                     {"cubic_ref": hi, "value_cubic_ref": s["value_high"]},
                     {"cubic_ref": lo, "value_cubic_ref": s["value_low"]})
        too_small = width <= STEPSIZE_PRECISION
        gave_up = last | (too_small & (safe_z["safe_stepsize"] > 0.0))
        zoomed = {**common, **new_high, **new_low, **ref, **safe_z,
                  "interval_found": s["interval_found"], "done": done_z,
                  "failed": gave_up & ~done_z}

        new = _where(zoom, zoomed, search)
        # on failure: the safe step (sufficient decrease) if there is one,
        # or no step when the last point was outside the domain
        use_safe = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                    | torch.isinf(new["decrease_error"]))
        new = {**new, **_where(use_safe,
                               {"stepsize": new["safe_stepsize"],
                                "value": new["safe_value"],
                                "grad": new["safe_grad"]},
                               {k: new[k] for k in ("stepsize", "value",
                                                    "grad")})}
        for k, v in new.items():
            st[k] = st[k].clone()
            st[k][running] = v
    return st["stepsize"], st["value"], st["grad"]


def run_restarts(objective, u0s: torch.Tensor, max_iters: int, tol: float):
    """Batched L-BFGS from the starts u0s (B, p), restarts in lockstep.

    The JAX package's `run_lbfgs` under `vmap`: each restart keeps the best
    iterate it has seen, stops when its gradient norm falls to `tol` or
    after `max_iters` iterations, and freezes in place if a step is not
    finite. The value of the iterate a step lands on is the linesearch's
    (the same point, the same function), so no extra evaluation is made.
    The objective is called as objective(u, rows), rows the indices of u's
    rows among the B restarts (`_make_objective`). Returns (best u (B, p),
    best value (B,), iterations (B,)).
    """
    b, p = u0s.shape
    z = u0s.detach().clone()

    def vg(u, rows):
        return value_and_grad(lambda v: objective(v, rows), u)

    with torch.no_grad():
        best_v = objective(z, torch.arange(b, device=z.device))
    best_z = z.clone()
    iters = torch.zeros(b, dtype=torch.int64, device=z.device)
    gnorm = torch.full((b,), float("inf"), dtype=z.dtype, device=z.device)
    ls_value = torch.full((b,), float("inf"), dtype=z.dtype, device=z.device)
    ls_grad = torch.zeros_like(z)
    memory = _lbfgs_init(b, p, z)
    while True:
        rows = torch.nonzero((iters < max_iters) & (gnorm > tol)).flatten()
        if rows.numel() == 0:
            break
        zs = z[rows]
        # value and gradient from the last linesearch, unless not finite
        val, g = ls_value[rows], ls_grad[rows]
        stale = torch.nonzero(~torch.isfinite(val)).flatten()
        if stale.numel():
            val, g = val.clone(), g.clone()
            val[stale], g[stale] = vg(zs[stale], rows[stale])
        precond, mem = _lbfgs_update({k: v[rows] for k, v in memory.items()},
                                     zs, g)
        direction = -precond
        step, v_new, g_new = _zoom_linesearch(vg, zs, direction, val, g,
                                              rows)
        z_new = zs + step[:, None] * direction
        improved = (v_new < best_v[rows])[:, None]
        best_z[rows] = torch.where(improved, z_new, best_z[rows])
        best_v[rows] = torch.minimum(v_new, best_v[rows])
        gn = torch.linalg.vector_norm(g, dim=-1)
        # a non-finite step poisons the state: freeze in place instead
        ok = torch.isfinite(z_new).all(-1)
        z[rows] = torch.where(ok[:, None], z_new, zs)
        gnorm[rows] = torch.where(ok, gn, torch.zeros_like(gn))
        iters[rows] += 1
        ls_value[rows], ls_grad[rows] = v_new, g_new
        for k, v in mem.items():
            memory[k][rows] = v
    return best_z, best_v, iters


def mle_fit(generator: torch.Generator, x, y, h, cfg: MLEConfig = MLEConfig(),
            *, noise_diag=None, mesh=None, axis: str = "chains"):
    """Multi-restart MLE. Returns (best GPParams, info dict).

    info holds the per-restart final NLLs (`nlls`), iteration counts
    (`iters`), the LHC starts (`starts_logspace`), `best_index` and
    `best_nll`. The starts come from `generator` (a CPU torch.Generator);
    everything else runs where x is, in x's dtype.

    With `mesh`, the restarts are split over mesh axis `axis` (the JAX
    package shards the restart axis the same way): every rank draws the
    same starts from its generator (seeded alike on every rank) and runs
    its cfg.tries / p of them through `run_restarts` (on the card K1 once
    a restart an evaluation); the NLLs, iterations and end points are
    all-gathered, so every rank chooses the same best. cfg.tries must be a
    multiple of the axis size.
    """
    d = x.shape[1]
    lo, hi = _default_bounds(cfg, d)
    objective, to_logspace, from_logspace = _make_objective(
        x, y, h, cfg, lo, hi, noise_diag)
    z0s = _lhc_starts(generator, cfg.tries, lo, hi, x.dtype).to(x.device)
    group = axis_group(mesh, axis)
    p, me = group_size(group), group_rank(group)
    if cfg.tries % p:
        raise ValueError(f"{cfg.tries} restarts do not split over {p} ranks")
    k = cfg.tries // p
    mine = from_logspace(z0s[me * k:(me + 1) * k])
    us, vs, iters = run_restarts(objective, mine, cfg.max_iters, cfg.tol)
    if group is not None:
        us = all_gather(us, group).reshape(cfg.tries, -1)
        vs = all_gather(vs, group).reshape(cfg.tries)
        iters = all_gather(iters, group).reshape(cfg.tries)
    best = torch.argmin(torch.where(torch.isfinite(vs), vs,
                                    torch.full_like(vs, float("inf"))))
    params = _unpack(to_logspace(us[best]), cfg, d, x.dtype)
    info = {
        "nlls": vs,
        "iters": iters,
        "best_index": best,
        "starts_logspace": z0s,
        "best_nll": vs[best],
    }
    return params, info
