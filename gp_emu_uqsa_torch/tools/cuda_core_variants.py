"""Time variants of the CUDA-core bodies, K4 "highest", K3 and K1/K2, on the card.

    python -m gp_emu_uqsa_torch.tools.cuda_core_variants [quad] [matvec] [build]

Each variant is `csrc/corr_quad.cu` or `csrc/corr_matvec.cu` with a few
lines replaced (`QUAD_VARIANTS`, `MATVEC_VARIANTS`), built with the port's
nvcc flags (`k4_high_variants.build_variants`: all builds started together)
and called through its C entry point at the serving shapes of
`chip_smoke.py` phase 2: m = 65536 queries, n = 16384 training points,
d = 8; K4 on W = L^-1 of the training correlation (delta 0.8, nugget 1e-4),
K3 on an rhs of r = 10 columns ~ N(0, 1/n). For each variant it prints the
median CUDA-event time of 3 calls after a warm-up, the max abs error
against fp64 arithmetic on the same inputs, and ptxas's register and spill
report. The variants that drop work give wrong answers on purpose: they
time what is left. K3 as built is also timed with each forced number of
segments of n, and K4 "highest" as built at the m = 4096 request with each
number of splits. While K4 "highest" as built and cuBLAS's fp32 product of
the same contraction (`torch.matmul(c, W^T)` on a prebuilt c, the
`library_ms` of `chip_smoke.py`) run, nvidia-smi samples the SM clock and
the power draw every 50 ms.

`BUILD_VARIANTS` are edits of `csrc/corr_build.cu` (K1/K2): each is timed
through its C entry point on preallocated buffers (CUDA events around 20
back-to-back launches) for K1 at n = 16384 and K2 at 256 x 16384, d = 8,
with the max abs error against the plain versions; beside them, the time
of `fill_(1.0)` on the same 16384^2 fp32 output, what the card's store path
gives. The arguments name the sections to run (all by default).

Needs one NVIDIA Hopper card and nvcc; imports no JAX.
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops import cholesky as chol
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops import serve as sv
from gp_emu_uqsa_torch.ops.precision import fp32_exact_matmul
from gp_emu_uqsa_torch.tools.k4_high_variants import (
    build_variants, launches_ms, time_ms,
)

N, D, M, R = 16384, 8, 65536, 10
DELTA, NUGGET = 0.8, 1e-4

_REBUILD = "      rebuild(b ^ 1);\n"
_LOAD_W = "      load_w(nxt, b ^ 1);\n"
_UNROLL = "#pragma unroll 16\n      for (int jj = 0; jj < fp::kChunkJ; ++jj) {"
_CHUNK = "constexpr int kChunkJ = 64;     // factor columns per stage, one fp32 fold"
_QEXP = "sc[(cj + jj) * fp::kTileQ] = Family::corr(d2[jj]);"
_LANES = ("  const int tx = tid % fp::kGroups;\n"
          "  const int ty = tid / fp::kGroups;")
_C0 = "const float4 c0 = *reinterpret_cast<const float4*>(sc + jj * fp::kTileQ + 4 * ty);"
_C1 = "const float4 c1 = *reinterpret_cast<const float4*>(sc + jj * fp::kTileQ + 64 + 4 * ty);"
_W0 = "const float4 w0 = *reinterpret_cast<const float4*>(sw + jj * fp::kTileK + 4 * tx);"
_W1 = "const float4 w1 = *reinterpret_cast<const float4*>(sw + jj * fp::kTileK + 64 + 4 * tx);"
# name -> (what it changes, [(text of corr_quad.cu, replacement)])
QUAD_VARIANTS = {
    "as built": ("nothing", []),
    "no rebuild": ("c is never rebuilt after the first chunk (wrong "
                   "answers)", [(_REBUILD, "")]),
    "no W loads": ("Wt is never loaded after the first chunk (wrong "
                   "answers)", [(_LOAD_W, "")]),
    "neither": ("both of the above (wrong answers)",
                [(_REBUILD, ""), (_LOAD_W, "")]),
    "unroll 4": ("the FMA loop unrolled 4 times",
                 [(_UNROLL, _UNROLL.replace("unroll 16", "unroll 4"))]),
    "unroll 8": ("the FMA loop unrolled 8 times",
                 [(_UNROLL, _UNROLL.replace("unroll 16", "unroll 8"))]),
    "chunk 16": ("16 factor columns a stage (and a fold)",
                 [(_CHUNK, _CHUNK.replace("64;", "16;"))]),
    "chunk 32": ("32 factor columns a stage (and a fold)",
                 [(_CHUNK, _CHUNK.replace("64;", "32;"))]),
    "__expf": ("the Gaussian with the fast exp intrinsic in the rebuild",
               [(_QEXP, _QEXP.replace("Family::corr(d2[jj])",
                                      "__expf(-d2[jj])"))]),
    "warp 4 x 8": ("a warp holds 4 query groups x 8 factor groups (the "
                   "final sum over factor groups is wrong)",
                   [(_LANES, "  const int tx = tid / 32 % 2 * 8 + tid % 8;\n"
                             "  const int ty = tid / 64 * 4 + tid % 32 / 8;")]),
    "no c loads": ("c read from registers in the FMA loop (wrong answers)",
                   [(_C0, "const float4 c0 = make_float4(jj, 1.f, 2.f, 3.f);"),
                    (_C1, "const float4 c1 = make_float4(4.f, jj, 6.f, 7.f);")]),
    "no W reads": ("W read from registers in the FMA loop (wrong answers)",
                   [(_W0, "const float4 w0 = make_float4(jj, 1.f, 2.f, 3.f);"),
                    (_W1, "const float4 w1 = make_float4(4.f, jj, 6.f, 7.f);")]),
}
_BOUNDS = "__global__ void __launch_bounds__(kThreads)\ncorr_matvec_kernel("
_MEXP = "const float cij = Family::corr(d2);"
_TILE = ("constexpr int kThreads = 256;   // queries per block, one a thread\n"
         "constexpr int kChunk = 256;     // training points staged per step")
MATVEC_VARIANTS = {
    "as built": ("nothing", []),
    "4 blocks an SM": ("__launch_bounds__(256, 4): at most 64 registers",
                       [(_BOUNDS, _BOUNDS.replace("(kThreads)",
                                                  "(kThreads, 4)"))]),
    "128 threads": ("blocks of 128 queries, 128 staged points",
                    [(_TILE, _TILE.replace("256", "128"))]),
    "__expf": ("the Gaussian with the fast exp intrinsic",
               [(_MEXP, "const float cij = __expf(-d2);")]),
    "no exp": ("c = 1 - d2 (wrong answers)",
               [(_MEXP, "const float cij = 1.f - d2;")]),
}
_MIRROR = "constexpr bool kMirror = true;"
_TMA = "constexpr bool kTmaStore = true;"
_PERSISTENT = "constexpr bool kPersistent = true;"
_TMA_STORES = "    if (tma) {\n      if (tid == 0) {"
_THREAD_STORES = "    } else {\n      store_tile(s_d,"
BUILD_VARIANTS = {
    "as built": ("nothing", []),
    "no mirror": ("K1 computes every tile and stores it once",
                  [(_MIRROR, _MIRROR.replace("true", "false"))]),
    "st.global.cs.v4": ("16-byte evict-first stores from the threads, not "
                        "TMA", [(_TMA, _TMA.replace("true", "false"))]),
    "not persistent": ("one block a tile pair",
                       [(_PERSISTENT, _PERSISTENT.replace("true", "false"))]),
    "no mirror, not persistent": ("both of the above",
                                  [(_MIRROR, _MIRROR.replace("true", "false")),
                                   (_PERSISTENT,
                                    _PERSISTENT.replace("true", "false"))]),
    "no stores": ("tiles built in shared memory, never stored (wrong "
                  "answers)",
                  [(_TMA_STORES, _TMA_STORES.replace("(tma)", "(n < 0)")),
                   (_THREAD_STORES, _THREAD_STORES.replace(
                       "} else {", "} else if (n < 0) {"))]),
}


def quad_highest(lib, xs, xt, w, splits=1):
    """quad from one variant's gp_corr_quad, launched as ops/serve.py
    launches it."""
    quad = torch.zeros((xs.shape[0],), dtype=torch.float32, device=xs.device)
    err = sv._launch_quad_fp32(xs, xt, w, quad, splits=splits, lib=lib)
    if err:
        raise RuntimeError(f"gp_corr_quad: CUDA error {err}")
    return quad


def matvec(lib, xs, xt, rhs, segments=None):
    """(out, segments) from one variant's gp_corr_matvec, launched as
    ops/serve.py launches it; segments from the variant's own plan unless
    forced."""
    m, n, r = xs.shape[0], *rhs.shape
    if segments is None:
        segments = sv._matvec_segments(m, n, r, lib)
    out = torch.zeros((m, r), dtype=torch.float32, device=xs.device)
    err = sv._launch_matvec(xs, xt, rhs, out, segments=segments, lib=lib)
    if err:
        raise RuntimeError(f"gp_corr_matvec: CUDA error {err}")
    return out, segments


def sampled(fn):
    """(fn's result, median SM clock in MHz, max power draw in W) while fn
    runs, from nvidia-smi samples every 50 ms."""
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(1.0)   # nvidia-smi's own start
        out = fn()
    finally:
        proc.terminate()
        lines = proc.communicate(timeout=30)[0].splitlines()
    samples = [tuple(float(v) for v in line.split(","))
               for line in lines if line.count(",") == 1]
    clocks = [c for c, _ in samples]
    return (out, float(np.median(clocks)) if clocks else float("nan"),
            max((p for _, p in samples), default=float("nan")))


def build_section(dev, card) -> None:
    """K1 at n = 16384 and K2 at 256 x 16384 for each of BUILD_VARIANTS."""
    libs = build_variants("corr_build.cu", BUILD_VARIANTS,
                          "corr_build_kernelILb1E")
    x = torch.as_tensor(np.random.default_rng(0).uniform(size=(N, D))
                        .astype(np.float32), device=dev)
    xv = torch.as_tensor(np.random.default_rng(3).uniform(size=(256, D))
                         .astype(np.float32), device=dev)
    delta = torch.full((D,), DELTA, dtype=torch.float32, device=dev)
    want_a = km.gaussian_corr_self_plain(x, delta, NUGGET)
    want_c = km.gaussian_corr_plain(xv, x, delta)
    a = torch.empty_like(want_a)
    c = torch.empty_like(want_c)
    stream = _build.stream_ptr(x)
    t_fill = launches_ms(lambda: a.fill_(1.0))
    print(f"K1/K2 variants, K1 at n={N}, K2 at 256 x {N}, d={D} on {card}; "
          f"fill_(1.0) of the {N}^2 output {t_fill:.4f} ms")

    for name, (lib, report) in libs.items():
        k1 = _build.entry(lib, "gp_corr_self", km._SELF_ARGTYPES)
        k2 = _build.entry(lib, "gp_corr_cross", km._CROSS_ARGTYPES)
        args1 = (x.data_ptr(), delta.data_ptr(), None, NUGGET, a.data_ptr(),
                 N, D, stream)
        args2 = (xv.data_ptr(), x.data_ptr(), delta.data_ptr(), c.data_ptr(),
                 256, N, D, stream)
        for fn, args in ((k1, args1), (k2, args2)):
            err = fn(*args)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        t1 = launches_ms(lambda: k1(*args1))
        t2 = launches_ms(lambda: k2(*args2))
        e1 = float((a - want_a).abs().max())
        e2 = float((c - want_c).abs().max())
        print(f"  {name:26s} K1 {t1:8.4f} ms ({t1 / t_fill:.2f} of fill), "
              f"err {e1:.3e}, symmetric {bool(torch.equal(a, a.T))}; "
              f"K2 {t2 * 1e3:7.2f} us, err {e2:.3e}  "
              f"[{'; '.join(report)}]  ({BUILD_VARIANTS[name][0]})")

    # the host's time per call of K2's wrapper and of what it is made of, at
    # 256 x 256 (a kernel shorter than the host's work): perf_counter around
    # 200 back-to-back calls
    def host_us(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / reps * 1e6

    nugget = torch.tensor(NUGGET, device=dev)
    c = torch.empty((256, 256), device=dev)
    k2 = _build.kernel(km._SOURCE, "gp_corr_cross", km._CROSS_ARGTYPES)
    args2 = (xv.data_ptr(), xv.data_ptr(), delta.data_ptr(), c.data_ptr(),
             256, 256, D, stream)
    parts = {
        "K2 wrapper": lambda: km.gaussian_corr_fused(xv, xv, delta),
        "K1 wrapper (n=256)": lambda: km.gaussian_corr_self_fused(
            xv, delta, nugget),
        "K2 C entry point": lambda: k2(*args2),
        "torch.empty": lambda: torch.empty((256, 256), device=dev),
        "x.to(float32)": lambda: xv.to(torch.float32),
        "_delta_arg": lambda: km._delta_arg(delta, xv),
        "_check_cuda": lambda: km._check_cuda("k", xv, xv, delta),
        "stream_ptr": lambda: _build.stream_ptr(xv),
        "current_device": torch.cuda.current_device,
        "one PyTorch op (x * 2)": lambda: xv * 2.0,
        "Event(enable_timing).record()": lambda: torch.cuda.Event(
            enable_timing=True).record(),
    }
    print(f"  host us per call at 256 x 256 on {card}: " + ", ".join(
        f"{name} {host_us(fn):.2f}" for name, fn in parts.items()))


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("cuda_core_variants: no CUDA device", file=sys.stderr)
        return 1
    sections = (sys.argv[1:] if argv is None else argv) or [
        "quad", "matvec", "build"]
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    if "build" in sections:
        build_section(dev, card)
        torch.cuda.empty_cache()
    if "quad" not in sections and "matvec" not in sections:
        print(card)
        return 0
    if "quad" in sections:
        quad_libs = build_variants("corr_quad.cu", QUAD_VARIANTS,
                                   "corr_quad_fp32_kernelIN5gpemu8Gaussian")
    if "matvec" in sections:
        matvec_libs = build_variants(
            "corr_matvec.cu", MATVEC_VARIANTS,
            f"corr_matvec_kernelILi{R}EN5gpemu8Gaussian")
    # chip_smoke.py phase 2's data: bench.py::_problem's x, seed 0
    x = torch.as_tensor(np.random.default_rng(0).uniform(size=(N, D))
                        .astype(np.float32), device=dev)
    xq = torch.as_tensor(np.random.default_rng(1).uniform(size=(M, D))
                         .astype(np.float32), device=dev)
    rhs = torch.as_tensor((np.random.default_rng(2).standard_normal((N, R))
                           / np.sqrt(N)).astype(np.float32), device=dev)
    delta = torch.full((D,), DELTA, dtype=torch.float32, device=dev)
    l, _ = chol.cholesky_with_jitter(km.gaussian_corr_self_fused(x, delta,
                                                                 NUGGET))
    w = torch.tril(chol.tri_inverse(l)).contiguous()
    del l
    xs, xt = sv._scaled(xq, x, delta)
    # fp64 arithmetic on the same fp32 inputs, in slices of 4096 queries
    w64 = w.double()
    q64, mv64 = [], []
    for s in range(0, M, 4096):
        c = km.sq_exp_plain(xs[s:s + 4096], xt).double()
        q64.append(torch.sum((c @ w64.T) ** 2, dim=1))
        mv64.append(c @ rhs.double())
    q64, mv64 = torch.cat(q64), torch.cat(mv64)
    del w64, c

    if "quad" in sections:
        print(f"K4 \"highest\" variants at m={M}, n={N}, d={D} on {card}")
        for name, (lib, report) in quad_libs.items():
            t, quad = time_ms(lambda: quad_highest(lib, xs, xt, w))
            err = float((quad.double() - q64).abs().max())
            print(f"  {name:16s} {t:9.2f} ms  vs fp64 {err:.3e}  "
                  f"[{'; '.join(report)}]  ({QUAD_VARIANTS[name][0]})")
        lib = quad_libs["as built"][0]
        (t, _), clock, power = sampled(
            lambda: time_ms(lambda: quad_highest(lib, xs, xt, w), reps=5))
        print(f"  as built again  {t:9.2f} ms  SM clock median {clock:.0f} MHz, "
              f"power max {power:.1f} W")
        c = km.gaussian_corr_fused(xq, x, delta)
        with fp32_exact_matmul():
            (t, _), clock, power = sampled(
                lambda: time_ms(lambda: torch.matmul(c, w.T), reps=3))
        del c
        print(f"  cuBLAS fp32 product {t:9.2f} ms  SM clock median {clock:.0f} "
              f"MHz, power max {power:.1f} W")
        for splits in (1, 2, 4, 8):
            t, _ = time_ms(lambda: quad_highest(lib, xs[:4096], xt, w, splits))
            print(f"  as built, m=4096, {splits} splits {t:9.2f} ms")
    if "matvec" in sections:
        print(f"K3 variants at m={M}, n={N}, d={D}, r={R} on {card}")
        for name, (lib, report) in matvec_libs.items():
            t, (out, segs) = time_ms(lambda: matvec(lib, xs, xt, rhs))
            err = float((out.double() - mv64).abs().max())
            print(f"  {name:16s} {t:9.4f} ms  {segs} segments  vs fp64 "
                  f"{err:.3e}  [{'; '.join(report)}]  "
                  f"({MATVEC_VARIANTS[name][0]})")
        lib = matvec_libs["as built"][0]
        for segs in (1, 2, 3, 4, 6, 8, 16):
            t, (out, _) = time_ms(lambda: matvec(lib, xs, xt, rhs, segs))
            err = float((out.double() - mv64).abs().max())
            print(f"  as built, {segs:2d} segments {t:9.4f} ms  vs fp64 {err:.3e}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
