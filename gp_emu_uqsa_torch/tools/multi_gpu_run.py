"""The multi-device path at BASELINE config 5's width over NCCL ranks.

    torchrun --nproc_per_node=N -m gp_emu_uqsa_torch.tools.multi_gpu_run \
        [--n 16384] [--m 65536]

One card a rank (`cuda:LOCAL_RANK`), NCCL between them. On
`bench.py::_problem`'s data (seed 0, d = 8, delta 0.8, nugget 1e-4,
linear basis, fp32) every rank runs the multi-device path and the
single-device path it stands for, and holds one against the other:

- `build_corr_sharded` (K2 row blocks) against K1's A, within K1/K2's
  tolerance, and exactly symmetric across the rank blocks;
- `fit_large` with "recursive", "panel" and "block2d": the NLL, sigma2
  and the mean at M_HOLD queries against `gp.fit` in fp32 and in fp64
  (phase 3b's budgets: mean within 1e-3 of max |mean|, variance within
  1e-2 sigma2);
- `fit_large(refine=1)`: e against the fp64 solve of the same fp32 A,
  before and after, here and on tests/test_parallel.py's clustered
  system, both held to that test's bounds (after < 1.5e-3 and < before
  / 3);
- `predictor_large`'s W against `tri_inverse` of the same factor;
- `ring_predict` at m queries against `gp.predict_fast` on the same
  predictor and `predict_sharded` against `gp.predict` on the same state
  (phase 3's fused-vs-gemm tolerances), and the ring against fp64;
- K2 against its plain version at the row-block and ring-block shapes.

Each multi-device call is timed (host clock, synchronized, then a barrier)
beside its single-device counterpart, with the peak memory of this rank
and the bytes it sent; the K1/K2 launches are counted over the
multi-device calls alone. `run` also takes fp64 (the plain build; the
fp32-only checks, refine and K2, are left out) and, with `one_rank`,
holds every multi-device result against the same function with no mesh
(ONE_RANK_RTOL). `chip_smoke.py` phase 8 calls `run`: (a) with one NCCL
rank, (b) on four gloo ranks sharing one card in fp64 against one rank,
then in fp32. Exits 1 if a check failed on any rank.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from gp_emu_uqsa_torch import gp, kernels
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.kernels import params_from_numpy
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops.cholesky import cho_solve, tri_inverse
from gp_emu_uqsa_torch.parallel import (
    build_corr_sharded, fit_large, init_multihost, make_mesh,
    predict_sharded, predictor_large, ring_predict,
)
from gp_emu_uqsa_torch.parallel.large_fit import FACTORIZATIONS, row_block
from gp_emu_uqsa_torch.parallel.mesh import (
    RowBlocks, gather_group_rows, mesh_device, padded_rows, traffic,
)
from gp_emu_uqsa_torch.parallel.sharded_gp import corr_block, padded_x

DIM, DELTA, NUGGET = 8, 0.8, 1e-4
BLOCK = 512
M_HOLD = 1024
# phase 3b of chip_smoke.py: fp32 against fp64
MEAN_REL, VAR_REL = 1e-3, 1e-2
# phase 4 of chip_smoke.py: the cap of its fp32 NLL budget against fp64
NLL_REL = 1e-2
# phase 3 of chip_smoke.py: one fp32 serving path against another
SERVE_MEAN, SERVE_VAR = 1e-4, 2e-3
# K1/K2's tolerance (tests/test_pallas_kernels.py)
BUILD_RTOL, BUILD_ATOL = 2e-5, 2e-6
# predictor_large's W against tri_inverse of the same fp32 factor, relative
# to max |W|: two backward-stable inverses of L differ by about
# kappa(L) eps32 (kappa(L) = sqrt(kappa(A)), about 3e3 here)
W_REL = 1e-3
# fp64, the multi-device path against the same function with no mesh (or
# predict_sharded against gp.predict): the sums run in other orders
ONE_RANK_RTOL = 1e-10
# e = A^-1 (y - H beta) carries kappa(A) eps64 (kappa ~ 1e7 at n = 4096):
# the JAX package's tolerance for e (tests/test_parallel.py)
E_RTOL, E_ATOL = 1e-6, 1e-8


def problem(n: int, d: int = DIM, seed: int = 0):
    """bench.py::_problem's data: x ~ U[0,1]^d, y = sin(3x0) + x1 x2 +
    0.1 sum x (fp32)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x.sum(1)
    return x, y.astype(np.float32)


def clustered_problem():
    """tests/test_parallel.py::test_fit_large_refine_fp32_compensated's
    system: n = 512, d = 3, pairs 1e-3 apart, delta 1.2, nugget 2.2e-3."""
    rng = np.random.default_rng(9)
    base = rng.uniform(size=(256, 3))
    xx = np.vstack([base, base + 1e-3 * rng.standard_normal((256, 3))])
    return (xx.astype(np.float32),
            (np.sin(3 * xx[:, 0]) + xx[:, 1]).astype(np.float32))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def grid_shape(p: int) -> dict:
    """The most square (mr, mc) split of p ranks, mr >= mc."""
    mc = max(c for c in range(1, int(math.isqrt(p)) + 1) if p % c == 0)
    return {"mr": p // mc, "mc": mc}


def timed(fn):
    """(seconds, fn(), this rank's peak GiB): the host clock around fn and
    a synchronize, then a barrier, so the slowest rank sets the time."""
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    dist.barrier()
    return s, out, torch.cuda.max_memory_allocated() / 2 ** 30


def rel(got, want, scale=None) -> float:
    """max |got - want| / scale (default max |want|)."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max()) if scale is None else scale
    return float((got - want).abs().max()) / max(scale, 1e-300)


class Holds:
    """Named checks, each printed with its value and limit; misses are
    collected, not raised. `prefix` starts every name."""

    def __init__(self, say, prefix=""):
        self.say = say
        self.prefix = prefix
        self.failures = []

    def le(self, name, value, limit):
        name = self.prefix + name
        ok = bool(value <= limit)
        self.say(f"  {name}: {value:.3e} (limit {limit:.3g}) "
                 f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{name}: {value:.3e} > {limit:.3g}")

    def close(self, name, got, want, rtol, atol):
        got, want = got.double(), want.double()
        if not bool(torch.isfinite(got).all()):
            name = self.prefix + name
            self.failures.append(f"{name}: non-finite values")
            self.say(f"  {name}: non-finite values FAIL")
            return
        worst = float(((got - want).abs() / (atol + rtol * want.abs())).max())
        self.le(f"{name} (worst err / (atol {atol:.2g} + rtol {rtol:.2g} "
                f"|want|))", worst, 1.0)

    def true(self, name, ok):
        name = self.prefix + name
        self.say(f"  {name}: {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)


def _mean(st, x, xq, hq):
    """The posterior mean from a fit state's replicated beta and e."""
    return hq @ st.beta + kernels.corr(xq, x, st.params) @ st.e


def _launches():
    return {"K1": km.gaussian_corr_self_fused.launches,
            "K2": km.gaussian_corr_fused.launches}


def run(n: int, m: int, say=print, device_type=None,
        dtype: torch.dtype = torch.float32, one_rank: bool = False) -> dict:
    """The checks on every rank of the default process group (NCCL, one
    card a rank; device_type "cpu" for a rehearsal on gloo ranks), in
    `dtype`; `one_rank` (fp64 only) adds the one-rank references. Returns
    {"failures", "launches" (the multi-device calls' K1/K2 launches on this
    rank), "times" (s), "peak_gib", "bytes"}."""
    fp32 = dtype == torch.float32
    if one_rank and fp32:
        raise ValueError("one_rank holds fp64 runs only: two fp32 "
                         "factorizations of A differ by kappa(A) eps32")
    tag = "fp32" if fp32 else "fp64"
    p, me = dist.get_world_size(), dist.get_rank()
    holds = Holds(say, f"{tag} ")
    mesh = make_mesh({"mr": p}, device_type=device_type)
    mesh2 = make_mesh(grid_shape(p), device_type=device_type)
    mesh_data = make_mesh({"data": p}, device_type=device_type)
    dev = mesh_device(mesh)
    group = mesh.get_group("mr")
    x_np, y_np = problem(n)
    xq_np = np.random.default_rng(2).uniform(size=(m, DIM))
    td = dict(dtype=dtype, device=dev)
    x, y = torch.as_tensor(x_np, **td), torch.as_tensor(y_np, **td)
    xq = torch.as_tensor(xq_np, **td)
    spec = linear_basis(DIM)
    h, hq = basis_matrix(x, spec), basis_matrix(xq, spec)
    params = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0,
                               np.log(NUGGET), device=dev, dtype=dtype)
    times, peak, sent = {}, {}, {}
    card = card_line() if dev.type == "cuda" else "cpu"
    say(f"[multi-device] {p} rank(s), {dist.get_backend()}, n={n}, m={m}, "
        f"d={DIM}, {tag} ({card})")
    # warm-up at a small n: the libraries' handles and the communicators,
    # so that no timed call pays for them
    for fac in FACTORIZATIONS:
        fit_large(params, x[:1024], y[:1024], h[:1024],
                  mesh2 if fac == "block2d" else mesh, block=BLOCK,
                  factorization=fac)
    small = gp.predictor(gp.fit(params, x[:1024], y[:1024], h[:1024]))
    ring_predict(small, x[:1024], xq[:1024], hq[:1024], mesh_data)
    del small

    # the single-device counterparts, in dtype and in fp64
    times["gp.fit"], st_d, peak["gp.fit"] = timed(
        lambda: gp.fit(params, x, y, h))
    x64, y64, h64 = x.double(), y.double(), h.double()
    p64 = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0, np.log(NUGGET),
                            device=dev, dtype=torch.float64)
    st64 = gp.fit(p64, x64, y64, h64) if fp32 else st_d
    nll64 = float(st64.nll)
    held = slice(0, M_HOLD)
    mean64, var64 = gp.predict(st64, x64, h64, xq[held].double(),
                               hq[held].double())
    s64 = float(st64.sigma2)
    del st64
    times["gp.predictor"], pred_d, peak["gp.predictor"] = timed(
        lambda: gp.predictor(st_d))
    times["gp.predict_fast"], (mf, vf), peak["gp.predict_fast"] = timed(
        lambda: gp.predict_fast(pred_d, x, xq, hq))
    del pred_d
    times["gp.predict"], (mp, vp), peak["gp.predict"] = timed(
        lambda: gp.predict(st_d, x, h, xq, hq))
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the multi-device path, its launches counted apart
    before = _launches()
    times["build_corr_sharded"], (a_rows, _), peak["build_corr_sharded"] = \
        timed(lambda: build_corr_sharded(x, params, mesh))
    a = gather_group_rows(a_rows, group)[:n, :n]
    del a_rows
    states = {}
    for fac in FACTORIZATIONS:
        on = mesh2 if fac == "block2d" else mesh
        traffic.reset()
        times[f"fit_large {fac}"], states[fac], peak[f"fit_large {fac}"] = \
            timed(lambda: fit_large(params, x, y, h, on, block=BLOCK,
                                    factorization=fac))
        sent[f"fit_large {fac}"] = traffic.bytes
    if fp32:
        traffic.reset()
        times["fit_large refine=1"], st_ref, peak["fit_large refine=1"] = \
            timed(lambda: fit_large(params, x, y, h, mesh, block=BLOCK,
                                    refine=1))
        sent["fit_large refine=1"] = traffic.bytes
    st = states["recursive"]
    traffic.reset()
    times["predictor_large"], pred, peak["predictor_large"] = timed(
        lambda: predictor_large(st, mesh, block=BLOCK))
    sent["predictor_large"] = traffic.bytes
    traffic.reset()
    times["ring_predict"], (mr, vr), peak["ring_predict"] = timed(
        lambda: ring_predict(pred, x, xq, hq, mesh_data))
    del mf, vf
    sent["ring_predict"] = traffic.bytes
    traffic.reset()
    times["predict_sharded"], (ms, vs), peak["predict_sharded"] = timed(
        lambda: predict_sharded(st_d, x, h, xq, hq, mesh_data))
    sent["predict_sharded"] = traffic.bytes
    launches = {k: v - before[k] for k, v in _launches().items()}
    say(f"  {tag} multi-device launches on this rank: {launches}")

    # the checks
    holds.true("the built A exactly symmetric across rank blocks",
               torch.equal(a, a.mT))
    if fp32:
        k1 = km.gaussian_corr_self_fused(x, params.delta, params.nugget)
        holds.close("build_corr_sharded (K2 rows) vs K1's A", a, k1,
                    BUILD_RTOL, BUILD_ATOL)
        say(f"    bitwise equal to K1's A: {torch.equal(a, k1)}")
        del k1
    else:
        holds.close("build_corr_sharded vs corr_self", a,
                    kernels.corr_self(x, params), 1e-14, 1e-15)
    s_d = float(st_d.sigma2)
    mean_d = mp[held]
    if fp32:
        say(f"  gp.fit fp32: NLL vs fp64, relative "
            f"{abs(float(st_d.nll) / nll64 - 1):.3e}")
    for fac, s in states.items():
        say(f"  {tag} fit_large {fac}: NLL {float(s.nll):.10g} (gp.fit "
            f"{float(st_d.nll):.10g}, fp64 {nll64:.10g}), sigma2 rel "
            f"{rel(s.sigma2, st_d.sigma2):.3e}, beta rel "
            f"{rel(s.beta, st_d.beta):.3e}")
        holds.le(f"fit_large {fac}: NLL vs fp64, relative",
                 abs(float(s.nll) / nll64 - 1), NLL_REL)
        mean = _mean(s, x, xq[held], hq[held])
        if fp32:
            holds.le(f"fit_large {fac}: mean vs gp.fit fp32, / max|mean|",
                     rel(mean, mean_d), MEAN_REL)
        holds.le(f"fit_large {fac}: mean vs gp.fit fp64, / max|mean|",
                 rel(mean, mean64), MEAN_REL)
        holds.le(f"fit_large {fac}: sigma2 vs fp64, relative",
                 abs(float(s.sigma2) / s64 - 1), VAR_REL)
    if one_rank:
        for fac, s in states.items():
            one = fit_large(params, x, y, h, None, block=BLOCK,
                            factorization=fac)
            for name in ("nll", "sigma2", "beta"):
                want = getattr(one, name)
                holds.close(f"fit_large {fac} {name} vs one rank",
                            getattr(s, name), want, ONE_RANK_RTOL,
                            1e-12 * float(want.abs().max()))
            holds.close(f"fit_large {fac} e vs one rank", s.e, one.e,
                        E_RTOL, E_ATOL * float(one.e.abs().max()))
            if fac == "recursive":
                one_rec = one
            del one

    if fp32:
        # refinement: e against the fp64 solve of the same fp32 A (its rows
        # as fit_large builds them: with fewer than 256 rows a rank,
        # kernels.corr takes the plain distance, which rounds unlike K2),
        # held to the bounds of tests/test_parallel.py's refine test here
        # too
        del a
        a = fit_rows_a(x, params, mesh, BLOCK)
        e0, e1 = hold_refine(holds, "config 5", a, h, y, st, st_ref)
        holds.le("refine=1 at config 5: after", e1, 1.5e-3)
        holds.le("refine=1 at config 5: after / before", e1 / e0, 1 / 3)
        xc, yc = clustered_problem()
        xc, yc = torch.as_tensor(xc, **td), torch.as_tensor(yc, **td)
        hc = basis_matrix(xc, linear_basis(3))
        pc = params_from_numpy(np.log(np.full(3, 1.2)), 0.0, np.log(2.2e-3),
                               device=dev, dtype=dtype)
        c0 = fit_large(pc, xc, yc, hc, mesh, block=64)
        c1 = fit_large(pc, xc, yc, hc, mesh, block=64, refine=1)
        ac = fit_rows_a(xc, pc, mesh, 64)
        err0, err1 = hold_refine(holds, "the clustered system", ac, hc, yc,
                                 c0, c1)
        holds.le("refine=1 on the clustered system: after", err1, 1.5e-3)
        holds.le("refine=1 on the clustered system: after / before",
                 err1 / err0, 1 / 3)
    del a

    # W = L^-1 by rows against tri_inverse of the same factor
    l_full = (st.l if p == 1 else
              gather_group_rows(st.l, group, row_block(n, p, BLOCK))[:n, :n])
    w_ref = torch.tril(tri_inverse(l_full))
    del l_full
    w = (pred.linv if p == 1 else
         gather_group_rows(pred.linv, group, row_block(n, p, BLOCK))[:n, :n])
    holds.le("predictor_large W vs tri_inverse of its factor, / max|W|",
             rel(w, w_ref), W_REL)
    del w, w_ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    s2 = float(pred.sigma2)
    # the ring against the one-device product on the same predictor (two
    # fp32 factors of A at kappa(A) ~ 1e7 give means 9e-4 apart, so each
    # is held to fp64 instead)
    whole = pred if p == 1 else pred._replace(linv=gather_group_rows(
        pred.linv, group, row_block(n, p, BLOCK))[:n, :n])
    mf, vf = gp.predict_fast(whole, x, xq, hq)
    del whole
    holds.close("ring_predict mean vs gp.predict_fast, the same predictor",
                mr, mf, SERVE_MEAN, SERVE_MEAN * max(1.0, s2))
    holds.close("ring_predict var vs gp.predict_fast, the same predictor",
                vr, vf, SERVE_VAR, SERVE_MEAN * s2)
    del mf, vf
    holds.le("ring_predict mean vs fp64, / max|mean|", rel(mr[held], mean64),
             MEAN_REL)
    holds.le("ring_predict var vs fp64, / sigma2",
             rel(vr[held], var64, s64), VAR_REL)
    if one_rank:
        m1, v1 = ring_predict(predictor_large(one_rec, None, block=BLOCK), x,
                              xq, hq, None)
        holds.close("predictor_large + ring_predict mean vs one rank", mr, m1,
                    ONE_RANK_RTOL, 1e-12 * s2)
        holds.close("predictor_large + ring_predict var vs one rank", vr, v1,
                    ONE_RANK_RTOL, 1e-12 * s2)
        del one_rec, m1, v1
    # predict_sharded runs gp.predict on each rank's rows: fp64 to rounding
    rtol_m, rtol_v = ((SERVE_MEAN, SERVE_VAR) if fp32 else
                      (ONE_RANK_RTOL, ONE_RANK_RTOL))
    atol = SERVE_MEAN if fp32 else 1e-12
    holds.close("predict_sharded mean vs gp.predict", ms, mp, rtol_m,
                atol * max(1.0, s_d))
    holds.close("predict_sharded var vs gp.predict", vs, vp, rtol_v,
                atol * s_d)
    del mr, vr, ms, vs, mp, vp

    if fp32:
        # K2 against its plain version at the path's shapes (not counted)
        rows = RowBlocks(st.l.shape[1] if p > 1 else n, p, me,
                         row_block(n, p, BLOCK))
        x_pad = padded_x(x, rows.n_pad)
        xr = x_pad[rows.index_tensor(dev)]
        s_q = -(-m // p)
        for what, x1, x2 in (("row block", xr, x_pad),
                             ("ring block", xq[me * s_q:(me + 1) * s_q],
                              x_pad[me * (rows.n_pad // p):
                                    (me + 1) * (rows.n_pad // p)])):
            got = km.gaussian_corr_fused(x1, x2, params.delta)
            want = km.gaussian_corr_plain(x1, x2, params.delta)
            holds.close(f"K2 at the {what} {tuple(got.shape)} vs plain", got,
                        want, BUILD_RTOL, BUILD_ATOL)
            say(f"    bitwise equal to the plain version: "
                f"{torch.equal(got, want)}")
            del got, want
    for name, s in times.items():
        say(f"  {tag} {name}: {s * 1e3:.1f} ms, peak {peak[name]:.2f} GiB on "
            f"this rank" + (f", sent {sent[name]} bytes" if name in sent
                            else ""))
    return {"failures": holds.failures, "launches": launches,
            "times": times, "peak_gib": peak, "bytes": sent}


def fit_rows_a(x, params, mesh, block):
    """The whole A that `fit_large(..., mesh, block=block)` factors, from
    every rank's rows as it builds them."""
    group = mesh.get_group("mr")
    n, p = x.shape[0], group.size()
    b = row_block(n, p, block)
    rows = RowBlocks.of(padded_rows(n, p, b), group, b)
    a = corr_block(padded_x(x, rows.n_pad), n, params,
                   rows.index_tensor(x.device),
                   torch.arange(rows.n_pad, device=x.device))
    return gather_group_rows(a, group, b, rows.n_pad)[:n, :n]


def hold_refine(holds, what, a32, h, y, st0, st1):
    """e before and after one refinement sweep against the fp64 solve of
    the same fp32 A at the refined fit's beta; (before, after)."""
    a64 = a32.double()
    l64 = torch.linalg.cholesky(a64)
    rhs = y.double() - h.double() @ st1.beta.double()
    e64 = cho_solve(l64, rhs[:, None])[:, 0]
    del a64, l64
    norm = float(torch.linalg.vector_norm(e64))
    err0 = float(torch.linalg.vector_norm(st0.e.double() - e64)) / norm
    err1 = float(torch.linalg.vector_norm(st1.e.double() - e64)) / norm
    holds.say(f"  refine=1 on {what}: e vs the fp64 solve of the same fp32 "
              f"A {err0:.3e} -> {err1:.3e}")
    return err0, err1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--m", type=int, default=65536)
    args = ap.parse_args()
    init_multihost()
    me = dist.get_rank()
    say = print if me == 0 else (lambda *_: None)
    try:
        out = run(args.n, args.m, say)
        failures = [None] * dist.get_world_size()
        dist.all_gather_object(failures, out["failures"])
        bad = [f"rank {r}: {f}" for r, fs in enumerate(failures) for f in fs]
        if me == 0:
            print(json.dumps({"world": dist.get_world_size(), "n": args.n,
                              "m": args.m, "times_s": out["times"],
                              "peak_gib_rank0": out["peak_gib"],
                              "bytes_rank0": out["bytes"],
                              "launches_rank0": out["launches"],
                              "failures": bad}))
    finally:
        dist.destroy_process_group()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
