"""Time variants of K4's "high" body on the card, to see what holds it back.

    python -m gp_emu_uqsa_torch.tools.k4_high_variants [--parent DIR]

Each variant is `csrc/corr_quad.cu` with a few lines replaced (`VARIANTS`),
built with the port's nvcc flags into `_build/variants/` (all builds started
together) and called through its C entry point `gp_corr_quad_tf32x3` at the
serving shape: m = 65536 queries, n = 16384 training points, d = 8, and
W = L^-1 of the training correlation (delta 0.8, nugget 1e-4), the data and
factor of `chip_smoke.py` phase 2. For each variant it prints the median
CUDA-event time of 3 calls after a warm-up, the max abs error on quad
against fp64 arithmetic on the same W and c, and ptxas's register and
spill report with any advisory that the wgmma were serialized or that
setmaxnreg was ignored. The variants that drop work give wrong answers on
purpose: they time what is left. The body as built is then timed alone
(`launches_ms`: the C entry point, W's split included, on fixed buffers) at
d = 1, 2, 4, 8 and 20 (the first d coordinates; d = 20 on 12 more uniform
ones, with the same W), since only the correlation rebuild grows with d.
With `--parent DIR` the same source of another checkout (for instance the
parent commit unpacked with `git archive`) is built and timed beside it,
and its quad is compared with this one's (max abs difference, and that
over the largest quad: at d != 8 the W is not the points' own factor, so
quad is not bounded by 1 there).

Needs one NVIDIA Hopper card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
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
# the Gaussian instance of the "high" body, by its mangled name
GAUSSIAN_HIGH = "corr_quad_tf32x3_kernelIN5gpemu8Gaussian"
DELTA, NUGGET = 0.8, 1e-4

_PAIR = "constexpr int kPairK = 2;"
_ONE = "constexpr int kPairK = 1;"
_FOLD = "constexpr int kFoldStages = 4;"
_EXP = "const float c = Family::corr(d2[4 * v + e]);"
_SPLIT = "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
# name -> (what it changes, [(text of corr_quad.cu, replacement)]). As
# built, two k tiles share each rebuilt c stage and so fold every stage; the
# fold schedules need one k tile a pass.
VARIANTS = {
    "as built": ("nothing", []),
    "one k tile a pass": ("each rebuilt c stage feeds one k tile, folded "
                          "every 4 stages: the parent body's work and "
                          "schedule", [(_PAIR, _ONE)]),
    "fold every stage": ("one k tile a pass, the fp32 fold after each stage "
                         "(4 k8 steps)",
                         [(_PAIR, _ONE), (_FOLD, "constexpr int kFoldStages = 1;")]),
    "fold every 16 stages": ("one k tile a pass, the fp32 fold after 16 "
                             "stages", [(_PAIR, _ONE),
                                        (_FOLD, "constexpr int kFoldStages = 16;")]),
    "no fold": ("one k tile a pass, the tensor cores sum each k tile's "
                "whole j sweep",
                [(_PAIR, _ONE), (_FOLD, "constexpr int kFoldStages = 1 << 20;")]),
    "no rebuild": ("the rebuild warps write a constant c: no distances, exp "
                   "or split (wrong answers)",
                   [(_EXP, "const float c = 0.5f;")]),
    "no rebuild, no fold": ("one k tile a pass, constant c, no fold (wrong "
                            "answers)",
                            [(_PAIR, _ONE), (_EXP, "const float c = 0.5f;"),
                             (_FOLD, "constexpr int kFoldStages = 1 << 20;")]),
    "__expf": ("the Gaussian with the fast exp intrinsic in the rebuild",
               [(_EXP, "const float c = __expf(-d2[4 * v + e]);")]),
    "cvt.rna split": ("the split by cvt.rna.tf32.f32 instead of add-and-mask",
                      [(_SPLIT, 'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;"'
                                ' : "=r"(r) : "f"(x));\n  return r;')]),
}


def build_variants(source: str = "corr_quad.cu", variants=None,
                   kernel: str | tuple[str, ...] = GAUSSIAN_HIGH,
                   label: str | None = None):
    """{name: (ctypes library, ptxas lines of `kernel`, a name or a tuple of
    names)} for each variant of `source` (a file of csrc/ or a path;
    default: this module's VARIANTS of the "high" body), built into
    `_build/variants/<label or stem>/`."""
    variants = VARIANTS if variants is None else variants
    path = _build.CSRC / source
    src = path.read_text()
    out = _build.BUILD_ROOT / "variants" / (label or Path(source).stem)
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
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(path.parent),
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


def ptxas_report(log: str, kernel: str | tuple[str, ...]) -> list[str]:
    """ptxas's register and spill lines for the entry function whose
    (mangled) name contains `kernel`, from nvcc's -Xptxas -v output, and
    every advisory about that function that its wgmma were serialized or
    its setmaxnreg ignored; a line saying so when no entry function has
    that name (a source from before the family template argument). For a
    tuple of names, each one's lines after the name."""
    if not isinstance(kernel, str):
        return [f"{k}: {line}" for k in kernel for line in ptxas_report(log, k)]
    lines = log.splitlines()
    at = next((i for i, line in enumerate(lines)
               if "Compiling entry function" in line and kernel in line), None)
    if at is None:
        return [f"no entry function named *{kernel}*"]
    report = [line.split("info    :")[-1].strip()
              for line in lines[at + 1:at + 4]
              if "spill" in line or "registers" in line]
    return report + [line.strip() for line in lines
                     if ("serialized" in line or "setmaxnreg" in line)
                     and kernel in line]


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


def entry_ms(lib, xs, xt, w) -> tuple[float, torch.Tensor]:
    """(launches_ms of one variant's gp_corr_quad_tf32x3 alone on fixed
    buffers prepared as ops/serve.py prepares them, its quad)."""
    (m, d), n = xs.shape, xt.shape[0]
    ld = -(-n // 4) * 4
    xt_t = torch.zeros((d, ld), dtype=torch.float32, device=xs.device)
    xt_t[:, :n] = xt.T
    w_split = torch.empty((2, n, ld), dtype=torch.float32, device=xs.device)
    quad = torch.zeros((m,), dtype=torch.float32, device=xs.device)
    fn = _build.entry(lib, "gp_corr_quad_tf32x3", sv._QUAD_TF32X3_ARGTYPES)
    args = (xs.data_ptr(), xt_t.data_ptr(), w.data_ptr(), w_split.data_ptr(),
            quad.data_ptr(), m, n, d, ld, _build.stream_ptr(xs))

    def call():
        err = fn(*args)
        if err:
            raise RuntimeError(f"gp_corr_quad_tf32x3: CUDA error {err}")
    return launches_ms(call), quad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose corr_quad.cu is timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_high_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    libs = build_variants()
    parent = None
    if args.parent:
        src = Path(args.parent).resolve() / "gp_emu_uqsa_torch/csrc/corr_quad.cu"
        parent = build_variants(str(src), {"parent": ("as committed there", [])},
                                label="parent")["parent"]
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
    if parent is not None:
        print(f"  parent ptxas: [{'; '.join(parent[1])}]")
    # d = 20: 12 more uniform coordinates (timing only; W stays d = 8's)
    more = np.random.default_rng(2).uniform(size=(N + M, 20 - D)) \
        .astype(np.float32)
    x20 = torch.cat([x, torch.as_tensor(more[:N], device=dev)], dim=1)
    xq20 = torch.cat([xq, torch.as_tensor(more[N:], device=dev)], dim=1)
    xs20, xt20 = sv._scaled(xq20, x20, torch.full((20,), DELTA,
                                                  dtype=torch.float32,
                                                  device=dev))
    for d in (1, 2, 4, 8, 20):
        a, b = (xs20, xt20) if d == 20 else (xs[:, :d].contiguous(),
                                              xt[:, :d].contiguous())
        t, quad = entry_ms(libs["as built"][0], a, b, w)
        line = f"  as built alone, d={d:<6d} {t:9.3f} ms"
        if parent is not None:
            tp, quad_p = entry_ms(parent[0], a, b, w)
            diff = float((quad - quad_p).abs().max())
            rel = diff / float(quad_p.abs().max())
            line += (f"   parent {tp:9.3f} ms   max |quad - parent's| "
                     f"{diff:.3e} ({rel:.2e} of max |quad|; bitwise equal: "
                     f"{torch.equal(quad, quad_p)})")
        print(line)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
