"""Time variants of K4's "high" body on the card, to see what holds it back.

    python -m gp_emu_uqsa_torch.tools.k4_high_variants

Each variant is `csrc/corr_quad.cu` with a few lines replaced (`VARIANTS`),
built with the port's nvcc flags into `_build/variants/` (all builds started
together) and called through its C entry point `gp_corr_quad_tf32x3` at the
serving shape: m = 65536 queries, n = 16384 training points, d = 8, and
W = L^-1 of the training correlation (delta 0.8, nugget 1e-4), the data and
factor of `chip_smoke.py` phase 2. For each variant it prints the median
CUDA-event time of 3 calls after a warm-up, the max abs error on quad
against fp64 arithmetic on the same W and c, and ptxas's register and
spill report. The variants that drop work give wrong answers on purpose:
they time what is left. The unchanged body is also timed at d = 1, 2 and 4
(the first d coordinates), since only the correlation rebuild grows with d.

Needs one NVIDIA Hopper card and nvcc; imports no JAX.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops import cholesky as chol
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops import serve as sv

N, D, M = 16384, 8, 65536
DELTA, NUGGET = 0.8, 1e-4

_FOLD = "constexpr int kFoldStages = 4;"
_EXP = "const float c = expf(-d2[s][i]);"
_SPLIT = "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
# name -> (what it changes, [(text of corr_quad.cu, replacement)])
VARIANTS = {
    "as built": ("nothing", []),
    "fold every stage": ("the fp32 fold after each stage (4 k8 steps)",
                         [(_FOLD, "constexpr int kFoldStages = 1;")]),
    "fold every 16 stages": ("the fp32 fold after 16 stages",
                             [(_FOLD, "constexpr int kFoldStages = 16;")]),
    "no fold": ("the tensor cores sum each k tile's whole j sweep",
                [(_FOLD, "constexpr int kFoldStages = 1 << 20;")]),
    "no rebuild": ("c is a constant: no distances, exp or split (wrong "
                   "answers)", [(_EXP, "const float c = 0.5f;")]),
    "no rebuild, no fold": ("both of the above (wrong answers)",
                            [(_EXP, "const float c = 0.5f;"),
                             (_FOLD, "constexpr int kFoldStages = 1 << 20;")]),
    "__expf": ("the fast exp intrinsic in the rebuild",
               [(_EXP, "const float c = __expf(-d2[s][i]);")]),
    "cvt.rna split": ("the split by cvt.rna.tf32.f32 instead of add-and-mask",
                      [(_SPLIT, 'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;"'
                                ' : "=r"(r) : "f"(x));\n  return r;')]),
}


def build_variants(source: str = "corr_quad.cu", variants=None,
                   kernel: str = "tf32x3"):
    """{name: (ctypes library, ptxas lines of `kernel`)} for each variant of
    `source` (default: this module's VARIANTS of the "high" body)."""
    variants = VARIANTS if variants is None else variants
    src = (_build.CSRC / source).read_text()
    out = _build.BUILD_ROOT / "variants" / Path(source).stem
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (_, edits)) in enumerate(variants.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {source} "
                                   "exactly once")
            text = text.replace(old, new)
        cu = out / f"v{i}.cu"
        cu.write_text(text)
        so = out / f"v{i}.{os.getpid()}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = (ctypes.CDLL(str(so)), ptxas_report(log, kernel))
    return libs


def ptxas_report(log: str, kernel: str) -> list[str]:
    """ptxas's register and spill lines for the entry function whose
    (mangled) name contains `kernel`, from nvcc's -Xptxas -v output."""
    lines = log.splitlines()
    at = next(i for i, line in enumerate(lines)
              if "Compiling entry function" in line and kernel in line)
    return [line.split("info    :")[-1].strip()
            for line in lines[at + 1:at + 4]
            if "spill" in line or "registers" in line]


def launch(lib, xs, xt, w):
    """quad from one variant's gp_corr_quad_tf32x3, launched as
    ops/serve.py launches it."""
    quad = torch.zeros((xs.shape[0],), dtype=torch.float32, device=xs.device)
    err = sv._launch_quad_tf32x3(xs, xt, w, quad, lib=lib)
    if err:
        raise RuntimeError(f"gp_corr_quad_tf32x3: CUDA error {err}")
    return quad


def time_ms(fn, reps: int = 3):
    """(median CUDA-event ms of fn() over reps after a warm-up, last result)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times)), out


def launches_ms(fn, reps: int = 20) -> float:
    """CUDA-event ms of `reps` back-to-back fn() calls, divided by reps,
    after a warm-up: for a C entry point on preallocated buffers, the
    kernel's time without the wrapper's host work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_high_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    libs = build_variants()
    # chip_smoke.py phase 2's data: bench.py::_problem's x, seed 0
    x_np = np.random.default_rng(0).uniform(size=(N, D)).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    xq = torch.as_tensor(np.random.default_rng(1).uniform(size=(M, D))
                         .astype(np.float32), device=dev)
    delta = torch.full((D,), DELTA, dtype=torch.float32, device=dev)
    l, _ = chol.cholesky_with_jitter(km.gaussian_corr_self_fused(x, delta,
                                                                 NUGGET))
    w = torch.tril(chol.tri_inverse(l)).contiguous()
    del l
    xs, xt = sv._scaled(xq, x, delta)
    # fp64 arithmetic on the same fp32 W and c, in slices of 4096 queries
    w64 = w.double()
    q64 = torch.cat([
        torch.sum((km.sq_exp_plain(xs[s:s + 4096], xt).double() @ w64.T) ** 2,
                  dim=1) for s in range(0, M, 4096)])
    del w64
    print(f"K4 \"high\" variants at m={M}, n={N}, d={D} on {card}")
    for name, (lib, report) in libs.items():
        t, quad = time_ms(lambda: launch(lib, xs, xt, w))
        err = float((quad.double() - q64).abs().max())
        print(f"  {name:22s} {t:9.2f} ms  vs fp64 {err:.3e}  "
              f"[{'; '.join(report)}]  ({VARIANTS[name][0]})")
    for d in (1, 2, 4):
        t, _ = time_ms(lambda: launch(libs["as built"][0],
                                      xs[:, :d].contiguous(),
                                      xt[:, :d].contiguous(), w))
        print(f"  as built, d={d:<13d} {t:9.2f} ms")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
