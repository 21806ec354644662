#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gp_emu_uqsa_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
PyTorch built for CUDA and the CUDA toolkit (nvcc). Imports no JAX. Phases,
each of which fails the run with a non-zero exit:

1. Print the card's name and power limit (nvidia-smi); build the CUDA
   kernels from `gp_emu_uqsa_torch/csrc/` and print the build time.
2. Hold each kernel (K1-K4) against its plain PyTorch version on the card at
   the serving path's shapes, with the tolerances of
   tests/test_pallas_kernels.py; time kernel and plain version (CUDA events,
   median) and compute the bound from the same shapes.
3. Serve at full width (BASELINE config 5 on one card, the data of
   bench.py::_problem: seed 0, d=8, delta 0.8, nugget 1e-4, linear basis,
   fp32): save a trained emulator with n=16384 training rows and one
   256-row V-set, `load_emulator` it on the card (refit: K1, Cholesky,
   jitter ladder), answer requests through `Emulator.predict` (m=1000 on
   the gemm tier, m=65536 twice on the fused tier, full_cov at m=256) and
   `validate_against(0)`, with every launch counter read around that run.
   Check the results, the fused tier against the gemm tier, and a small
   fp32 card run against the fp64 CPU path.
4. Print the kernels JSON line, the card line, and as the last line
   {"ok": true, "device": {...}}.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gp_emu_uqsa_torch import Emulator, gp, load_emulator, params_from_numpy, save_emulator
from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops import cholesky as chol
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops import serve as sv

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
# HBM bytes/s, fp32 FLOP/s outside the tensor cores.
_PEAKS = {
    "PCIe": (2.0e12, 51e12),
    "NVL": (3.9e12, 60e12),
    "SXM": (3.35e12, 67e12),
}


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


def time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


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


def bound(bytes_moved: float, flops: float, peaks):
    bw, fp32 = peaks
    t_bytes, t_ops = bytes_moved / bw * 1e3, flops / fp32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters():
    return {"K1": km.gaussian_corr_self_fused.launches,
            "K2": km.gaussian_corr_fused.launches,
            "K3": sv.corr_matvec.launches,
            "K4": sv.corr_quad.launches}


def reset_counters():
    for fn in (km.gaussian_corr_self_fused, km.gaussian_corr_fused,
               sv.corr_matvec, sv.corr_quad):
        fn.launches = 0


def phase_kernels(dev, peaks, card):
    """Kernel vs plain version at the serving path's shapes; times; bounds."""
    print(f"[phase 2] kernels vs plain versions ({card})")
    x_np, _ = problem(N_TRAIN + N_VALID)
    x = torch.as_tensor(x_np[:N_TRAIN], device=dev)
    xv = torch.as_tensor(x_np[N_TRAIN:], device=dev)
    delta = torch.full((DIM,), DELTA, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(1)
    xq = torch.as_tensor(rng.uniform(size=(M_SERVE, DIM)).astype(np.float32),
                         device=dev)
    n, d = N_TRAIN, DIM
    rows = {}

    # K1: the training build at n = 16384
    a = km.gaussian_corr_self_fused(x, delta, NUGGET)
    torch.cuda.synchronize()
    err = check_close("K1 gaussian_corr_self", a,
                      km.gaussian_corr_self_plain(x, delta, NUGGET), 2e-5, 2e-6)
    if not torch.equal(a, a.T):
        raise SmokeFailure("K1: output is not exactly symmetric")
    t = time_ms(lambda: km.gaussian_corr_self_fused(x, delta, NUGGET))
    tp = time_ms(lambda: km.gaussian_corr_self_plain(x, delta, NUGGET), reps=3)
    rows["K1"] = (err, t, tp, bound(4.0 * (n * d + n * n),
                                    n * n * (3.0 * d + 1), peaks))
    # W = L^-1 of the same matrix, as the serving predictor builds it
    l, jitter = chol.cholesky_with_jitter(a)
    w = torch.tril(chol.tri_inverse(l))
    del a, l
    print(f"  (K4 check factor: jitter {float(jitter):.4g})")

    # K2: the validation cross block, 256 x 16384
    c = km.gaussian_corr_fused(xv, x, delta)
    torch.cuda.synchronize()
    err = check_close("K2 gaussian_corr", c,
                      km.gaussian_corr_plain(xv, x, delta), 2e-5, 2e-6)
    t = time_ms(lambda: km.gaussian_corr_fused(xv, x, delta))
    tp = time_ms(lambda: km.gaussian_corr_plain(xv, x, delta))
    mv = xv.shape[0]
    rows["K2"] = (err, t, tp, bound(4.0 * (mv * n + (mv + n) * d),
                                    mv * n * (3.0 * d + 1), peaks))

    # K3: the serving slab, m = 65536, r = 10. rhs ~ N(0,1)/sqrt(n) keeps the
    # outputs O(0.1), as in the n = 300 test whose tolerance this is
    r = RHS_WIDTH
    rhs = torch.as_tensor(rng.standard_normal((n, r)).astype(np.float32)
                          / np.sqrt(n), device=dev)
    out = sv.corr_matvec(xq, x, delta, rhs)
    torch.cuda.synchronize()
    err = check_close("K3 corr_matvec", out,
                      sv.corr_matvec_plain(xq, x, delta, rhs), 3e-5, 3e-5)
    vec = sv.corr_matvec(xq[:4096], x, delta, rhs[:, 0])
    check_close("K3 corr_matvec (vector rhs)", vec,
                sv.corr_matvec_plain(xq[:4096], x, delta, rhs[:, :1])[:, 0],
                3e-5, 3e-5)
    t = time_ms(lambda: sv.corr_matvec(xq, x, delta, rhs))
    tp = time_ms(lambda: sv.corr_matvec_plain(xq, x, delta, rhs), reps=3)
    m = M_SERVE
    rows["K3"] = (err, t, tp, bound(4.0 * (m * d + n * d + n * r + m * r),
                                    m * n * (3.0 * d + 1 + 2 * r), peaks))

    # K4: the variance quadratic against W = L^-1, checked at m = 4096 in
    # both tiers, timed at the serving request m = 65536
    xc = xq[:M_QUAD_CHECK]
    want = sv.corr_quad_plain(xc, x, delta, w)
    errs = {}
    for tier, rtol, atol in (("highest", 5e-4, 5e-5), ("high", 1e-3, 1e-4)):
        got = sv.corr_quad(xc, x, delta, w, quad_precision=tier)
        torch.cuda.synchronize()
        errs[tier] = check_close(f"K4 corr_quad ({tier})", got, want, rtol, atol)
    t = time_ms(lambda: sv.corr_quad(xq, x, delta, w, quad_precision="high"),
                reps=3)
    tp = time_ms(lambda: sv.corr_quad_plain(xq, x, delta, w), reps=3)
    rows["K4"] = (max(errs.values()), t, tp,
                  bound(4.0 * (m * d + n * d + n * (n + 1) / 2 + m),
                        m * n * (3.0 * d + 1) + m * n * (n + 1.0), peaks))
    for name, (_, t, tp, (b, by)) in rows.items():
        print(f"  {name}: {t:.4f} ms (plain {tp:.4f} ms, bound {b:.4f} ms by "
              f"{by}) on {card}")
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
    print(f"  launches in the serving run: {launches}")
    if min(launches.values()) <= 0:
        raise SmokeFailure(f"a kernel of the path never launched: {launches}")

    for name, v in (("mean_gemm", mean_g), ("var_gemm", var_g),
                    ("mean_fused", mean_f), ("var_fused", var_f),
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
    # each tier's mean against an fp64 evaluation of the same fp32 state
    # (c e summed in fp64): which side of the gap is summation error
    xs, hs = served._prepare_inputs(xq[:M_COMPARE])
    st = served.state
    inv = 1.0 / torch.exp(st.params.log_delta).double()
    c64 = km.sq_exp_plain(xs.double() * inv,
                          served.train_view()[0].double() * inv)
    m64 = hs.double() @ st.beta.double() + c64 @ st.e.double()
    print(f"  mean vs fp64 sum of the same state: fused "
          f"{float((mean_f[:M_COMPARE].double() - m64).abs().max()):.3e}, "
          f"gemm {float((m_ref.double() - m64).abs().max()):.3e}; "
          f"|e| max {float(st.e.abs().max()):.3e}")
    del c64
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
    return launches


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
          "TFLOP/s fp32")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"  built {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {src}: {line.strip()}")

    rows = phase_kernels(dev, peaks, card)
    launches = phase_serve(dev, card)
    phase_reference(dev)

    where = {
        "K1": ("gaussian_corr_self", "gp_emu_uqsa_torch/csrc/corr_build.cu",
               "gp_emu_uqsa_tpu/ops/kernel_matrix.py:181"),
        "K2": ("gaussian_corr", "gp_emu_uqsa_torch/csrc/corr_build.cu",
               "gp_emu_uqsa_tpu/ops/kernel_matrix.py:122"),
        "K3": ("corr_matvec", "gp_emu_uqsa_torch/csrc/corr_matvec.cu",
               "gp_emu_uqsa_tpu/ops/serve.py:103"),
        "K4": ("corr_quad", "gp_emu_uqsa_torch/csrc/corr_quad.cu",
               "gp_emu_uqsa_tpu/ops/serve.py:371"),
    }
    kernels = []
    for key, (name, source, replaces) in where.items():
        err, t, tp, (b, by) = rows[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "max_abs_err": err, "ms": t, "plain_ms": tp,
                        "bound_ms": b, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
