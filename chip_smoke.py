#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gp_emu_uqsa_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
PyTorch built for CUDA and the CUDA toolkit (nvcc). Imports no JAX. Phases,
each of which fails the run with a non-zero exit:

1. Print the card's name and power limit (nvidia-smi); build the CUDA
   kernels from `gp_emu_uqsa_torch/csrc/` and print the build time, and
   ptxas's registers and spills and the launch plan of the K1/K2 bodies.
2. Hold each kernel (K1-K4) against its plain PyTorch version on the card at
   the serving path's shapes, with the tolerances of
   tests/test_pallas_kernels.py; time each kernel two ways, its C entry
   point alone on preallocated buffers (CUDA events around 20 back-to-back
   launches: `ms`) and through its wrapper (median: `wrapper_ms`), time the
   plain version, and compute the bound from the same shapes. K1 and K2 are
   held bit for bit (K1 also exactly symmetric) at n=16384 and at K2's three
   served shapes (1000 x 16384, 256 x 16384, 256 x 256), and at ragged
   shapes (K1 at n in {513, 16383}, K2 at 257 x 16383, d in {1, 20}); K1 is
   timed beside fill_(1.0) of its output, what the card's store path gives.
   The K1 and K2 wrappers, with delta and the nugget as tensors on the card,
   run under torch.cuda.set_sync_debug_mode("error") (a host sync fails
   the run), and the profiler counts the kernels each call runs (one).
   K4 is held and timed
   per precision tier ("highest": exact fp32 on the CUDA cores; "high":
   3xTF32 on the tensor cores) at the serving request m=65536, against the
   plain version and an fp64 evaluation of the same W and c; "high" also
   against its own arithmetic in plain PyTorch on the first and last 4096
   queries. It is timed beside cuBLAS doing the same contraction as one
   fp32 product, and the error of the products' split alone is printed for
   3xTF32 and for the JAX package's bf16x3. K3 and K4 "highest" are also
   held against their plain versions at ragged shapes that hit the edges of
   their tiles (m=4097, n=16383, d in {1, 20}; K3 with r in {1, 10, 17,
   33}), and K4 "highest" is timed at the m=4096 request with its factor
   tiles split over blocks (as served) and unsplit.
3. Serve at full width (BASELINE config 5 on one card, the data of
   bench.py::_problem: seed 0, d=8, delta 0.8, nugget 1e-4, linear basis,
   fp32): save a trained emulator with n=16384 training rows and one
   256-row V-set, `load_emulator` it on the card (refit: K1, Cholesky,
   jitter ladder), answer requests through `Emulator.predict` (m=1000 on
   the gemm tier, m=65536 twice on the fused tier with K4 "high",
   full_cov at m=256) and `validate_against(0)`, with every launch counter
   set to 0 before that run and read after it. Then, in a launch window of
   its own, one request of m=4096 on the fused tier with K4 "highest".
   Check the results, the fused tier against the gemm tier, the two K4
   tiers against each other, and a small fp32 card run against the fp64
   CPU path.
4. Print the kernels JSON line, the card line, and as the last line
   {"ok": true, "device": {...}}.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gp_emu_uqsa_torch import (
    Emulator, gp, kernels, load_emulator, params_from_numpy, save_emulator,
)
from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops import cholesky as chol
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops import serve as sv
from gp_emu_uqsa_torch.ops.precision import fp32_exact_matmul
from gp_emu_uqsa_torch.tools.k4_high_variants import launches_ms, ptxas_report

N_TRAIN = 16384          # training rows (BASELINE config 5)
N_VALID = 256            # one V-set: tv_config (65, 64, 1) over 16640 rows
DIM = 8
M_SERVE = 65536          # fused-tier request
M_GEMM = 1000            # gemm-tier request
M_COV = 256              # full-covariance request
M_QUAD_CHECK = 4096      # K4 kernel-vs-plain check
M_COMPARE = 2048         # fused vs gemm on the card
RHS_WIDTH = 10           # 1 + q, q = 9 (linear basis, d = 8)
DELTA = 0.8
NUGGET = 1e-4

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# HBM bytes/s, fp32 FLOP/s outside the tensor cores, TF32 and bf16
# tensor-core FLOP/s (half the data sheets' figures with sparsity).
_PEAKS = {
    "PCIe": (2.0e12, 51e12, 378e12, 756e12),
    "NVL": (3.9e12, 60e12, 417.5e12, 835.5e12),
    "SXM": (3.35e12, 67e12, 495e12, 989e12),
}
# K4 "high" against an fp64 evaluation of the same fp32 W and c: the tier's
# measured budget on quad (docs/numerics.md, bf16x3 tier)
QUAD_HIGH_FP64_BUDGET = 4.7e-5
# K4 "highest" against the same fp64 evaluation: twice the PR 1 body's
# 6.805e-6 at m=65536 on this W
QUAD_HIGHEST_FP64_BUDGET = 1.4e-5
# the fused tier's mean against an fp64 sum of the same fp32 state
MEAN_FP64_BUDGET = 1e-4
# ragged shapes for K3 and K4 "highest": one past a query tile, one short of
# a training chunk and factor tile
M_RAGGED, N_RAGGED = 4097, 16383


class SmokeFailure(RuntimeError):
    pass


def _peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, _PEAKS[key]
    return "SXM", _PEAKS["SXM"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def problem(n: int, d: int = DIM, seed: int = 0):
    """bench.py::_problem's data: x ~ U[0,1]^d, y = sin(3x0) + x1 x2 + 0.1 sum x."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x.sum(1)
    return x, y.astype(np.float32)


def time_ms(fn, reps: int = 5):
    """(median CUDA-event time of fn() over `reps` runs after one warm-up,
    the last run's result). The events are created before the timed runs:
    creating one costs the host about as much as a short kernel takes
    (`tools/cuda_core_variants.py build` times it)."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for pair in events:
        for event in pair:
            event.record()
    torch.cuda.synchronize()
    times = []
    for start, stop in events:
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times)), out


def check_close(name, got, want, rtol, atol) -> float:
    """max |got - want|; fails unless |got - want| <= atol + rtol |want|."""
    got = got.double()
    want = want.double()
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    worst = float((err / (atol + rtol * want.abs())).max())
    max_err = float(err.max())
    ok = worst <= 1.0
    print(f"  {name}: max_abs_err={max_err:.3e} (rtol={rtol:g}, atol={atol:g};"
          f" worst err/tolerance {worst:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: exceeds its tolerance {worst:.3f}-fold")
    return max_err


def check_build(name, got, want, symmetric=False) -> float:
    """A correlation build against its plain version: within K1/K2's
    tolerance (rtol 2e-5, atol 2e-6) and, as designed, bit for bit; K1 also
    exactly symmetric."""
    err = check_close(name, got, want, 2e-5, 2e-6)
    print(f"    bitwise equal to the plain version: {torch.equal(got, want)}"
          + (f"; torch.equal(a, a.T): {torch.equal(got, got.T)}"
             if symmetric else ""))
    if symmetric and not torch.equal(got, got.T):
        raise SmokeFailure(f"{name}: output is not exactly symmetric")
    return err


def entry_call(source: str, symbol: str, argtypes, *args):
    """A no-argument call of a C entry point on fixed arguments on the
    current stream (tensors go as their pointers and are kept alive);
    raises on an error code."""
    fn = _build.kernel(source, symbol, argtypes)
    ptrs = (*(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), torch.cuda.current_stream().cuda_stream)

    def call(_keep=args):
        err = fn(*ptrs)
        if err:
            _build.check(err, source, symbol)
    return call


def self_entry(x, delta, nugget, out):
    """K1's C entry point alone, writing into out."""
    n, d = x.shape
    return entry_call(km._SOURCE, "gp_corr_self", km._SELF_ARGTYPES,
                      x, delta, nugget, 0.0, out, n, d)


def cross_entry(x1, x2, delta, out):
    """K2's C entry point alone, writing into out."""
    (m, d), n = x1.shape, x2.shape[0]
    return entry_call(km._SOURCE, "gp_corr_cross", km._CROSS_ARGTYPES,
                      x1, x2, delta, out, m, n, d)


def matvec_entry(xq, x, delta, rhs):
    """K3's C entry point alone on buffers prepared as ops/serve.py
    prepares them."""
    xs, xt = sv._scaled(xq, x, delta)
    (m, d), (n, r) = xs.shape, rhs.shape
    segments = sv._matvec_segments(m, n, r)
    out = torch.zeros((m, r), dtype=torch.float32, device=xs.device)
    partial = (torch.empty((segments, m, r), dtype=torch.float32,
                           device=xs.device) if segments > 1 else out)
    return entry_call(sv._MATVEC_SOURCE, "gp_corr_matvec",
                      sv._MATVEC_ARGTYPES, xs, xt, rhs, partial, out, m, n,
                      d, r, segments)


def quad_entry(xq, x, delta, w, tier):
    """K4's C entry point of one tier alone on buffers prepared as
    ops/serve.py prepares them."""
    xs, xt = sv._scaled(xq, x, delta)
    (m, d), n = xs.shape, xt.shape[0]
    quad = torch.zeros((m,), dtype=torch.float32, device=xs.device)
    tile = 4 if tier == "high" else sv.QUAD_TILE_K
    ld = -(-n // tile) * tile
    xt_t = torch.zeros((d, ld), dtype=torch.float32, device=xs.device)
    xt_t[:, :n] = xt.T
    if tier == "high":
        w_split = torch.empty((2, n, ld), dtype=torch.float32, device=xs.device)
        return entry_call(sv._QUAD_SOURCE, "gp_corr_quad_tf32x3",
                          sv._QUAD_TF32X3_ARGTYPES, xs, xt_t, w, w_split,
                          quad, m, n, d, ld)
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    splits = sv.quad_splits(m, n, sms)
    wt = torch.empty((ld, ld), dtype=torch.float32, device=xs.device)
    partial = (torch.empty((splits, m), dtype=torch.float32, device=xs.device)
               if splits > 1 else quad)
    return entry_call(sv._QUAD_SOURCE, "gp_corr_quad", sv._QUAD_ARGTYPES, xs,
                      xt_t, w, wt, partial, quad, m, n, d, ld, splits)


def device_kernels(fn):
    """Names of the kernels that fn() ran on the card, from torch.profiler's
    trace; None when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def check_build_wrappers(x, xv):
    """K1 and K2 through their wrappers with delta and the nugget as tensors
    on the card (kernels.corr_self and kernels.corr pass params.delta and
    params.nugget): no host synchronisation under
    torch.cuda.set_sync_debug_mode("error"), and one kernel on the card per
    call."""
    params = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0,
                               np.log(NUGGET), device=x.device,
                               dtype=torch.float32)
    delta, nugget = params.delta, params.nugget
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a sync raises
    try:
        km.gaussian_corr_self_fused(x, delta, nugget)
        km.gaussian_corr_fused(xv, x, delta)
        kernels.corr_self(x, params)
        kernels.corr(xv, x, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  K1, K2 wrappers and kernels.corr_self/corr with device delta "
          "and nugget: no host sync under set_sync_debug_mode(\"error\")")
    for name, fn in (
            ("K1", lambda: km.gaussian_corr_self_fused(x, delta, nugget)),
            ("K2", lambda: km.gaussian_corr_fused(xv, x, delta))):
        seen = device_kernels(fn)
        if seen is None:
            print(f"  {name} wrapper, kernels on the card per call: not "
                  "measured (the profiler's trace holds no device activity)")
            continue
        print(f"  {name} wrapper, kernels on the card per call: {len(seen)} "
              f"{sorted(set(seen))}")
        if len(seen) != 1:
            raise SmokeFailure(f"{name} wrapper ran {len(seen)} kernels, not 1")


def bound(bytes_moved: float, flops: float, peaks, tf32_flops: float = 0.0):
    """Least time (ms, what bounds it): bytes over HBM, fp32 operations over
    the CUDA cores' peak and TF32 operations over the tensor cores' peak."""
    bw, fp32, tf32 = peaks[:3]
    t_bytes = bytes_moved / bw * 1e3
    t_ops = max(flops / fp32, tf32_flops / tf32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_WRAPPERS = {"K1": km.gaussian_corr_self_fused, "K2": km.gaussian_corr_fused,
             "K3": sv.corr_matvec, "K4": sv.corr_quad}


def counters():
    return {key: fn.launches for key, fn in _WRAPPERS.items()}


def reset_counters():
    for fn in _WRAPPERS.values():
        fn.launches = 0


def bf16x3_split(c, w):
    """The JAX package's bf16x3 operands (`_quad_kernel_bf16x3` and its
    caller): c_hi is c truncated to bf16, W_hi is W rounded to nearest
    even, and each lo part is the remainder rounded to bf16; as fp32."""
    c_hi = (c.contiguous().view(torch.int32) & -0x10000).view(torch.float32)
    w_hi = w.bfloat16().float()
    return ((c_hi, (c - c_hi).bfloat16().float()),
            (w_hi, (w - w_hi).bfloat16().float()))


def phase_kernels(dev, peaks, card):
    """Kernel vs plain version at the serving path's shapes; times; bounds."""
    print(f"[phase 2] kernels vs plain versions ({card})")
    torch.manual_seed(5)
    x_np, _ = problem(N_TRAIN + N_VALID)
    x = torch.as_tensor(x_np[:N_TRAIN], device=dev)
    xv = torch.as_tensor(x_np[N_TRAIN:], device=dev)
    delta = torch.full((DIM,), DELTA, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(1)
    xq = torch.as_tensor(rng.uniform(size=(M_SERVE, DIM)).astype(np.float32),
                         device=dev)
    n, d = N_TRAIN, DIM
    rows = {}

    # K1: the training build at n = 16384, with delta and the nugget as
    # tensors on the card, as kernels.corr_self passes them
    nugget = torch.tensor(NUGGET, dtype=torch.float32, device=dev)
    a = km.gaussian_corr_self_fused(x, delta, nugget)
    torch.cuda.synchronize()
    err = check_build("K1 gaussian_corr_self", a,
                      km.gaussian_corr_self_plain(x, delta, NUGGET),
                      symmetric=True)
    t_wrap, _ = time_ms(lambda: km.gaussian_corr_self_fused(x, delta, nugget))
    t = launches_ms(self_entry(x, delta, nugget, a))
    t_fill, _ = time_ms(lambda: a.fill_(1.0), reps=20)
    tp, _ = time_ms(lambda: km.gaussian_corr_self_plain(x, delta, NUGGET),
                    reps=3)
    rows["K1"] = (err, t, t_wrap, tp, bound(4.0 * (n * d + n * n),
                                            n * n * (3.0 * d + 1), peaks),
                  None)
    print(f"  K1 at n={n}: {t:.4f} ms alone, {t_wrap:.4f} ms through the "
          f"wrapper; write-rate yardstick fill_(1.0) of the same {n}^2 fp32 "
          f"output {t_fill:.4f} ms (median of 20): K1 writes at "
          f"{t_fill / t:.3f} of fill_'s rate ({card})")
    # W = L^-1 of the same matrix, as the serving predictor builds it
    a = km.gaussian_corr_self_fused(x, delta, nugget)
    l, jitter = chol.cholesky_with_jitter(a)
    w = torch.tril(chol.tri_inverse(l))
    del a, l
    print(f"  (K4 check factor: jitter {float(jitter):.4g})")

    # K2 at the serving run's shapes: gp.predict_batched (m = 1000),
    # predict(full_cov) and validate (256 x n, 256 x 256); the kernels entry
    # is the validation block, 256 x 16384
    k2 = {}
    for xa, xb in ((xq[:M_GEMM], x), (xv, x), (xv, xv)):
        shape = f"{xa.shape[0]} x {xb.shape[0]}"
        c = km.gaussian_corr_fused(xa, xb, delta)
        torch.cuda.synchronize()
        err = check_build(f"K2 gaussian_corr, {shape}", c,
                          km.gaussian_corr_plain(xa, xb, delta))
        t_wrap, _ = time_ms(lambda: km.gaussian_corr_fused(xa, xb, delta),
                            reps=20)
        t = launches_ms(cross_entry(xa, xb, delta, c))
        k2[shape] = (err, t, t_wrap)
        print(f"  K2 at {shape}: {t * 1e3:.2f} us alone, {t_wrap * 1e3:.2f} us "
              f"through the wrapper ({card})")
    mv = xv.shape[0]
    tp, _ = time_ms(lambda: km.gaussian_corr_plain(xv, x, delta))
    rows["K2"] = (*k2[f"{mv} x {n}"], tp,
                  bound(4.0 * (mv * n + (mv + n) * d), mv * n * (3.0 * d + 1),
                        peaks), None)
    # ragged edges: past and short of a 64-row tile, rows that are not a
    # multiple of 16 bytes (thread stores instead of TMA), d in {1, 20}
    for dr in (1, 20):
        dl = torch.full((dr,), DELTA * (dr / DIM) ** 0.5, device=dev)
        for nr in (513, N_RAGGED):
            xr = torch.rand((nr, dr), device=dev)
            check_build(f"K1 gaussian_corr_self, n={nr}, d={dr}",
                        km.gaussian_corr_self_fused(xr, dl, nugget),
                        km.gaussian_corr_self_plain(xr, dl, NUGGET),
                        symmetric=True)
        xr = torch.rand((N_RAGGED, dr), device=dev)
        qr = torch.rand((N_VALID + 1, dr), device=dev)
        check_build(f"K2 gaussian_corr, {N_VALID + 1} x {N_RAGGED}, d={dr}",
                    km.gaussian_corr_fused(qr, xr, dl),
                    km.gaussian_corr_plain(qr, xr, dl))
    del xr, qr
    check_build_wrappers(x, xv)

    # K3: the serving slab, m = 65536, r = 10. rhs ~ N(0,1)/sqrt(n) keeps the
    # outputs O(0.1), as in the n = 300 test whose tolerance this is
    r = RHS_WIDTH
    rhs = torch.as_tensor((rng.standard_normal((n, r)) / np.sqrt(n))
                          .astype(np.float32), device=dev)
    out = sv.corr_matvec(xq, x, delta, rhs)
    torch.cuda.synchronize()
    err = check_close("K3 corr_matvec", out,
                      sv.corr_matvec_plain(xq, x, delta, rhs), 3e-5, 3e-5)
    vec = sv.corr_matvec(xq[:4096], x, delta, rhs[:, 0])
    check_close("K3 corr_matvec (vector rhs)", vec,
                sv.corr_matvec_plain(xq[:4096], x, delta, rhs[:, :1])[:, 0],
                3e-5, 3e-5)
    print(f"  K3 at m={M_SERVE}, r={r}: {sv._matvec_segments(M_SERVE, n, r)} "
          f"segments of n")
    for dr in (1, 20):
        xr = torch.rand((N_RAGGED, dr), device=dev)
        qr = torch.rand((M_RAGGED, dr), device=dev)
        dl = torch.full((dr,), DELTA * (dr / DIM) ** 0.5, device=dev)
        for rr in (1, 10, 17, 33):
            b = torch.randn((N_RAGGED, rr), device=dev) / N_RAGGED ** 0.5
            check_close(f"K3 corr_matvec, m={M_RAGGED}, n={N_RAGGED}, d={dr}, "
                        f"r={rr} ({sv._matvec_segments(M_RAGGED, N_RAGGED, rr)}"
                        f" segments)", sv.corr_matvec(qr, xr, dl, b),
                        sv.corr_matvec_plain(qr, xr, dl, b), 3e-5, 3e-5)
    t_wrap, _ = time_ms(lambda: sv.corr_matvec(xq, x, delta, rhs))
    t = launches_ms(matvec_entry(xq, x, delta, rhs))
    tp, _ = time_ms(lambda: sv.corr_matvec_plain(xq, x, delta, rhs), reps=3)
    m = M_SERVE
    rows["K3"] = (err, t, t_wrap, tp, bound(4.0 * (m * d + n * d + n * r + m * r),
                                    m * n * (3.0 * d + 1 + 2 * r), peaks),
                  None)

    # K4: the variance quadratic against W = L^-1. Both tiers are timed at
    # the serving request m = 65536 (512 blocks of the "high" body: several
    # waves on the card) and the timed runs' outputs are held against the
    # plain version and against fp64 arithmetic on the same fp32 W and c.
    m = M_SERVE
    got = {}
    t_high, got["high"] = time_ms(
        lambda: sv.corr_quad(xq, x, delta, w, quad_precision="high"), reps=3)
    t_highest, got["highest"] = time_ms(
        lambda: sv.corr_quad(xq, x, delta, w, quad_precision="highest"),
        reps=3)
    # the second-long calls: one warm-up and one timed run each
    tp, want = time_ms(lambda: sv.corr_quad_plain(xq, x, delta, w), reps=1)
    errs = {}
    for tier, rtol, atol in (("highest", 5e-4, 5e-5), ("high", 1e-3, 1e-4)):
        errs[tier] = check_close(f"K4 corr_quad ({tier}), m={m}", got[tier],
                                 want, rtol, atol)
    # fp64 on the same W and c (the fp32 correlation of the plain version,
    # which the kernels rebuild to an ulp), over all m in slices
    w64 = torch.tril(w.double())
    e64 = dict.fromkeys(got, 0.0)
    q_max = 0.0
    for s in range(0, m, M_QUAD_CHECK):
        sl = slice(s, s + M_QUAD_CHECK)
        u64 = km.sq_exp_plain(*sv._scaled(xq[sl], x, delta)).double() @ w64.T
        q64 = torch.sum(u64 * u64, dim=1)
        del u64
        q_max = max(q_max, float(q64.abs().max()))
        for tier in got:
            e64[tier] = max(e64[tier],
                            float((got[tier][sl].double() - q64).abs().max()))
    for tier in got:
        print(f"  K4 corr_quad ({tier}), m={m}, vs fp64 of the same W and c: "
              f"max abs {e64[tier]:.3e} (|quad| max {q_max:.3e})")
    for tier, budget in (("high", QUAD_HIGH_FP64_BUDGET),
                         ("highest", QUAD_HIGHEST_FP64_BUDGET)):
        if e64[tier] > budget:
            raise SmokeFailure(f"K4 {tier}: {e64[tier]:.3e} from fp64 exceeds "
                               f"{budget:g}")
    # "high" against its own arithmetic (the same TF32 hi/lo operands, bit
    # for bit) on the first and the last 4096 queries: only the order and
    # rounding of the fp32 sums differ, so it gets the budget of two fp32
    # summations, the "highest" tier's
    for end, sl in (("first", slice(0, M_QUAD_CHECK)),
                    ("last", slice(m - M_QUAD_CHECK, m))):
        check_close(f"K4 corr_quad (high) vs corr_quad_tf32x3_plain, {end} "
                    f"{M_QUAD_CHECK} queries", got["high"][sl],
                    sv.corr_quad_tf32x3_plain(xq[sl], x, delta, w), 5e-4, 5e-5)
    # the strict upper triangle is never read
    xc = xq[:M_QUAD_CHECK]
    w_dirty = w + torch.triu(torch.randn_like(w), 1)
    for tier in got:
        if not torch.equal(
                sv.corr_quad(xc, x, delta, w_dirty, quad_precision=tier),
                sv.corr_quad(xc, x, delta, w, quad_precision=tier)):
            raise SmokeFailure(f"K4 {tier}: a dirty upper triangle changed "
                               "the result")
    print("  K4 corr_quad (both tiers): dirty upper triangle gives an "
          "identical result")
    del w_dirty
    # "highest" at ragged shapes, on W = L^-1 of a random SPD matrix
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.randn((N_RAGGED, N_RAGGED), device=dev) / N_RAGGED ** 0.5
    w_r = torch.eye(N_RAGGED, device=dev)
    w_r = torch.tril(chol.tri_inverse(torch.linalg.cholesky(
        torch.addmm(w_r, g, g.T))))
    del g
    for dr in (1, 20):
        xr = torch.rand((N_RAGGED, dr), device=dev)
        qr = torch.rand((M_RAGGED, dr), device=dev)
        dl = torch.full((dr,), DELTA * (dr / DIM) ** 0.5, device=dev)
        check_close(f"K4 corr_quad (highest), m={M_RAGGED}, n={N_RAGGED}, "
                    f"d={dr} ({sv.quad_splits(M_RAGGED, N_RAGGED, sms)} "
                    f"splits)", sv.corr_quad(qr, xr, dl, w_r),
                    sv.corr_quad_plain(qr, xr, dl, w_r), 5e-4, 5e-5)
    del w_r
    # the m = 4096 "highest" request's K4: factor tiles split over blocks
    # (as served) and in one block per query tile
    xs_c, xt_c = sv._scaled(xc, x, delta)
    splits = sv.quad_splits(M_QUAD_CHECK, n, sms)
    t_split, q_split = time_ms(lambda: sv.corr_quad(xc, x, delta, w))
    q_one = torch.zeros_like(q_split)

    def unsplit():
        _build.check(sv._launch_quad_fp32(xs_c, xt_c, w, q_one, splits=1),
                     sv._QUAD_SOURCE, "corr_quad (highest, one split)")
        return q_one
    t_one, _ = time_ms(unsplit)
    check_close(f"K4 corr_quad (highest), m={M_QUAD_CHECK}, {splits} splits "
                f"vs one", q_split, q_one, 5e-4, 5e-5)
    print(f"  K4 highest at the m={M_QUAD_CHECK} request: {t_split:.4f} ms "
          f"with {splits} splits, {t_one:.4f} ms unsplit ({card})")
    # the error of the products' split alone (products summed in fp64, on
    # the first 4096 queries): this body's 3xTF32 and the JAX package's
    # bf16x3, against the "high" tier's budget
    c = km.sq_exp_plain(*sv._scaled(xc, x, delta))
    u64 = c.double() @ w64.T
    q64 = torch.sum(u64 * u64, dim=1)
    w_tri = torch.tril(w)
    for name, ((c_hi, c_lo), (w_hi, w_lo)) in (
            ("3xTF32", (sv.tf32_split(c), sv.tf32_split(w_tri))),
            ("bf16x3", bf16x3_split(c, w_tri))):
        c_hi, c_lo = c_hi.double(), c_lo.double()
        w_hi, w_lo = w_hi.double(), w_lo.double()
        u64 = c_hi @ w_hi.T + c_hi @ w_lo.T + c_lo @ w_hi.T
        err = float((torch.sum(u64 * u64, dim=1) - q64).abs().max())
        print(f"  K4 split error alone, {name}, lo*lo dropped: max abs {err:.3e} "
              f"on quad (budget {QUAD_HIGH_FP64_BUDGET:g})")
    del c, u64, q64, w64, w_tri, c_hi, c_lo, w_hi, w_lo
    k4_bytes = 4.0 * (m * d + n * d + n * (n + 1) / 2 + m)
    rebuild_ops = m * n * (3.0 * d + 1)
    tri_ops = m * n * (n + 1.0)
    # library yardstick, never called by the port: cuBLAS doing the whole
    # square contraction c @ W^T in fp32 (TF32 off) on a prebuilt c
    c = km.gaussian_corr_fused(xq, x, delta)
    with fp32_exact_matmul():
        t_lib, _ = time_ms(lambda: torch.matmul(c, w.T), reps=1)
    del c
    print(f"  K4 high: the JAX package's bf16x3 arithmetic (three bf16 "
          f"passes) would be bound at {3.0 * tri_ops / peaks[3] * 1e3:.4f} ms "
          f"at the bf16 peak")
    alone = {tier: launches_ms(quad_entry(xq, x, delta, w, tier))
             for tier in ("high", "highest")}
    rows["K4 high"] = (errs["high"], alone["high"], t_high, tp,
                       bound(k4_bytes, rebuild_ops, peaks, 3.0 * tri_ops), t_lib)
    rows["K4 highest"] = (errs["highest"], alone["highest"], t_highest, tp,
                          bound(k4_bytes, rebuild_ops + tri_ops, peaks), t_lib)
    for name, (_, t, t_wrap, tp, (b, by), lib) in rows.items():
        extra = "" if lib is None else f", cuBLAS fp32 product {lib:.4f} ms"
        print(f"  {name}: {t:.4f} ms alone, {t_wrap:.4f} ms through the "
              f"wrapper (plain {tp:.4f} ms, bound {b:.4f} ms by {by}{extra}) "
              f"on {card}")
    del w, xq, x, xv
    torch.cuda.empty_cache()
    return rows


def phase_serve(dev, card):
    """The serving path at full width, through the user's entry points."""
    print(f"[phase 3] serving path, n={N_TRAIN}, d={DIM}, fp32 ({card})")
    x_np, y_np = problem(N_TRAIN + N_VALID)
    emul = Emulator.from_arrays(x_np, y_np, tv_config=(65, 64, 1),
                                dtype=torch.float32, device=dev, seed=0)
    emul.params = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0,
                                    np.log(NUGGET), device=dev,
                                    dtype=torch.float32)
    rng = np.random.default_rng(2)
    xq = rng.uniform(size=(M_SERVE, DIM))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "emulator"
        save_emulator(ckpt, emul)
        reset_counters()
        t0 = time.perf_counter()
        served = load_emulator(ckpt, device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    n_train = served.train_view()[0].shape[0]
    if n_train != N_TRAIN:
        raise SmokeFailure(f"expected {N_TRAIN} training rows, got {n_train}")
    mean_g, var_g = served.predict(xq[:M_GEMM])
    served.predict(xq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_f, var_f = served.predict(xq)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    mean_c, cov = served.predict(xq[:M_COV], full_cov=True)
    diag = served.validate_against(0)
    torch.cuda.synchronize()
    launches = counters()
    print(f"  launches in the serving run (K4 \"high\"): {launches}")
    if min(launches.values()) <= 0:
        raise SmokeFailure(f"a kernel of the path never launched: {launches}")
    # the exact fp32 K4 body through the same entry point, counted apart
    reset_counters()
    _, var_h = served.predict(xq[:M_QUAD_CHECK], quad_precision="highest")
    torch.cuda.synchronize()
    side = counters()
    print(f"  launches in the quad_precision=\"highest\" request: {side}")
    if side["K3"] <= 0 or side["K4"] <= 0:
        raise SmokeFailure(f"the \"highest\" request did not launch K3 and "
                           f"K4: {side}")

    for name, v in (("mean_gemm", mean_g), ("var_gemm", var_g),
                    ("mean_fused", mean_f), ("var_fused", var_f),
                    ("var_fused_highest", var_h),
                    ("mean_cov", mean_c), ("cov", cov),
                    ("mahalanobis", diag["mahalanobis"]),
                    ("std_err", diag["std_err"])):
        if not bool(torch.isfinite(v).all()):
            raise SmokeFailure(f"{name}: non-finite values")
    shapes = {"mean_gemm": (mean_g.shape, (M_GEMM,)),
              "mean_fused": (mean_f.shape, (M_SERVE,)),
              "var_fused": (var_f.shape, (M_SERVE,)),
              "cov": (cov.shape, (M_COV, M_COV)),
              "std_err": (diag["std_err"].shape, (N_VALID,))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise SmokeFailure(f"{name}: shape {tuple(got)}, expected {want}")
    if float(var_f.min()) < 0 or float(var_g.min()) < 0:
        raise SmokeFailure("negative predictive variance")

    # fused tier vs gemm tier on the card (tests/test_serve_facade.py:35-38)
    s2 = float(served.state.sigma2)
    m_ref, v_ref = served.predict(xq[:M_COMPARE], serve="gemm")
    check_close("fused vs gemm mean", mean_f[:M_COMPARE], m_ref,
                1e-4, 1e-4 * max(1.0, s2))
    check_close("fused vs gemm var", var_f[:M_COMPARE], v_ref,
                2e-3, 1e-4 * s2)
    check_close("gemm m=1000 vs fused", mean_g, mean_f[:M_GEMM],
                1e-4, 1e-4 * max(1.0, s2))
    # K4 "high" vs "highest" in the served variance: each tier's quad within
    # the 4.7e-5 budget of fp64, times sigma2
    check_close("fused var, K4 high vs highest", var_f[:M_QUAD_CHECK], var_h,
                0.0, 2 * QUAD_HIGH_FP64_BUDGET * s2)
    # each tier's mean against an fp64 evaluation of the same fp32 state
    # (c e summed in fp64): which side of the gap is summation error
    xs, hs = served._prepare_inputs(xq[:M_COMPARE])
    st = served.state
    inv = 1.0 / torch.exp(st.params.log_delta).double()
    c64 = km.sq_exp_plain(xs.double() * inv,
                          served.train_view()[0].double() * inv)
    m64 = hs.double() @ st.beta.double() + c64 @ st.e.double()
    fused_err = float((mean_f[:M_COMPARE].double() - m64).abs().max())
    print(f"  mean vs fp64 sum of the same state: fused {fused_err:.3e}, "
          f"gemm {float((m_ref.double() - m64).abs().max()):.3e}; "
          f"|e| max {float(st.e.abs().max()):.3e}")
    del c64
    if fused_err > MEAN_FP64_BUDGET:
        raise SmokeFailure(f"fused mean: {fused_err:.3e} from fp64 exceeds "
                           f"{MEAN_FP64_BUDGET:g}")
    jitter = float(served.state.jitter)
    pts = M_SERVE / serve_s
    print(f"  jitter used: {jitter:.6g} ({card})")
    print(f"  fit (load_emulator) : {fit_s * 1e3:.1f} ms ({card})")
    print(f"  serve m={M_SERVE}: {serve_s * 1e3:.1f} ms = {pts:.0f} "
          f"mean+var points/s ({card})")
    print(f"  validate: mahalanobis {float(diag['mahalanobis']):.4g} "
          f"(expect {float(diag['mahalanobis_mean']):.4g} "
          f"+- {float(diag['mahalanobis_sd']):.4g})")
    del served, emul
    torch.cuda.empty_cache()
    return launches, side["K4"]


def phase_reference(dev):
    """A small fp32 card run against the fp64 CPU path (test_fp32 budgets)."""
    print("[phase 3b] small fp32 card run vs fp64 CPU")
    x_np, y_np = problem(640, seed=3)
    xq = np.random.default_rng(4).uniform(size=(1024, DIM))
    results = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        emul = Emulator.from_arrays(x_np, y_np, tv_config=(5, 4, 1),
                                    dtype=dtype, device=device, seed=0)
        emul.params = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0,
                                        np.log(1e-2), device=device,
                                        dtype=dtype)
        x, y, h = emul.train_view()
        emul.state = gp.fit(emul.params, x, y, h)
        mean, var = emul.predict(xq)   # fused tier on the card (m >= 1024)
        results[str(device)] = (mean.cpu().double(), var.cpu().double(),
                                float(emul.state.sigma2))
    m32, v32, _ = results[str(dev)]
    m64, v64, s64 = results["cpu"]
    rel_mean = float((m32 - m64).abs().max() / m64.abs().max())
    rel_var = float((v32 - v64).abs().max() / s64)
    print(f"  mean rel err {rel_mean:.3e} (< 1e-3), var err / sigma2 "
          f"{rel_var:.3e} (< 1e-2)")
    if not (rel_mean < 1e-3 and rel_var < 1e-2):
        raise SmokeFailure("fp32 card run disagrees with the fp64 CPU path")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    peak_name, peaks = _peaks(kind)
    print(f"[phase 1] card: {card}; {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; bound peaks: "
          f"H100 {peak_name} {peaks[0] / 1e12:g} TB/s, {peaks[1] / 1e12:g} "
          f"TFLOP/s fp32, {peaks[2] / 1e12:g} TFLOP/s TF32, "
          f"{peaks[3] / 1e12:g} TFLOP/s bf16")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"  built {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                       "arning")):
                print(f"  {src}: {line.strip()}")
    log = _build.build_log.get(km._SOURCE)
    plan = (ctypes.c_int * 3)()
    for name, self_, (m, n), body in (
            ("K1", 1, (N_TRAIN, N_TRAIN), "corr_build_kernelILb1E"),
            ("K2", 0, (N_VALID, N_TRAIN), "corr_build_kernelILb0E")):
        _build.kernel(km._SOURCE, "gp_corr_build_plan",
                      (ctypes.c_int,) * 3 + (ctypes.c_void_p,))(
            self_, m, n, ctypes.addressof(plan))
        report = ("not rebuilt in this run" if log is None
                  else "; ".join(ptxas_report(log, body)))
        print(f"  {name} body ptxas: {report}; at {m} x {n}: {plan[0]} tiles "
              f"on {plan[1]} blocks, {plan[2]} bytes of dynamic shared "
              f"memory a block")

    rows = phase_kernels(dev, peaks, card)
    launches, launches_highest = phase_serve(dev, card)
    phase_reference(dev)

    where = {
        "K1": ("gaussian_corr_self", "gp_emu_uqsa_torch/csrc/corr_build.cu",
               "gp_emu_uqsa_tpu/ops/kernel_matrix.py:181"),
        "K2": ("gaussian_corr", "gp_emu_uqsa_torch/csrc/corr_build.cu",
               "gp_emu_uqsa_tpu/ops/kernel_matrix.py:122"),
        "K3": ("corr_matvec", "gp_emu_uqsa_torch/csrc/corr_matvec.cu",
               "gp_emu_uqsa_tpu/ops/serve.py:103"),
        "K4 high": ("corr_quad (high, 3xTF32 wgmma)",
                    "gp_emu_uqsa_torch/csrc/corr_quad.cu",
                    "gp_emu_uqsa_tpu/ops/serve.py:371"),
        "K4 highest": ("corr_quad (highest, fp32)",
                       "gp_emu_uqsa_torch/csrc/corr_quad.cu",
                       "gp_emu_uqsa_tpu/ops/serve.py:371"),
    }
    launches = {**launches, "K4 high": launches["K4"],
                "K4 highest": launches_highest}
    entries = []
    for key, (name, source, replaces) in where.items():
        err, t, t_wrap, tp, (b, by), lib = rows[key]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": err, "ms": t, "wrapper_ms": t_wrap,
                        "plain_ms": tp, "bound_ms": b, "bound_by": by,
                        "library_ms": lib})
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
