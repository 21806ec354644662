"""K3 and K4 per correlation family on the card: ptxas, error and time.

    python -m gp_emu_uqsa_torch.tools.family_kernels [--parent DIR] [--m M]

At the serving shape (m = 65536 queries, n = 16384 training points, d = 8,
delta 0.8, nugget 1e-4: the data of `chip_smoke.py` phase 2), for each
family of `ops.serve.FAMILIES`: W = L^-1 of that family's training
correlation (fp32 build, Cholesky and inverse on the card), then K3 (r =
10, an rhs ~ N(0, 1/n), the serving width at d = 8), K4 "high" and K4
"highest", each through its C entry point alone on fixed buffers (CUDA
events around 20 back-to-back launches, W's split or transpose included)
and held against fp64 arithmetic on the same fp32 inputs (max abs error;
quad lies in [0, 1] for a GP's own W); first, the largest relative error
of a single correlation entry (`entry_error`, through the wrapper). The
entry points are those of this checkout's `corr_matvec.cu` and
`corr_quad.cu` built as `k4_high_variants.build_variants` builds a variant
with no edits, and ptxas's registers, spills and advisories (setmaxnreg
ignored, wgmma serialized) are printed for every instance of the serving
bodies.

With `--parent DIR` (another checkout, for instance the parent commit
unpacked with `git archive`), its `corr_matvec.cu` and `corr_quad.cu` are
built the same way; their entry points without a family suffix are the Gaussian's, so the
Gaussian instances of this build are compared with them: K3's slab and
both K4 quads bit for bit, the time of each, and ptxas's count for each
body.

Needs one NVIDIA Hopper card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops import cholesky as chol
from gp_emu_uqsa_torch.ops import serve as sv
from gp_emu_uqsa_torch.tools.k4_high_variants import (
    build_variants, launches_ms,
)

N, D, M, R = 16384, 8, 65536, 10
DELTA, NUGGET = 0.8, 1e-4
# the template argument of each family's instances (csrc/common.cuh)
TEMPLATE = {"gaussian": "Gaussian", "matern52": "Matern52"}


def bodies(source: str, family: str | None = None) -> tuple[str, ...]:
    """The mangled names of the serving bodies' instances in `source` (K3
    at R = 1, 10 and 16; K4's two bodies): of the family's instance, or
    with family None of a source from before the family argument."""
    arg = "" if family is None else (f"N5gpemu{len(TEMPLATE[family])}"
                                     f"{TEMPLATE[family]}")
    if source == sv._MATVEC_SOURCE:
        return tuple(f"corr_matvec_kernelILi{r}E{arg}E" for r in (1, 10, 16))
    return tuple(f"corr_quad_{body}_kernel{'I' + arg if arg else ''}E"
                 for body in ("fp32", "tf32x3"))


def build_sources(root: Path, label: str, families=(None,)) -> dict:
    """{source: ctypes library} of a checkout's serving sources, built as
    `k4_high_variants.build_variants` builds a variant with no edits, so
    every run prints ptxas's report, whatever `_build` holds already: of each
    family's instances (`bodies`), or of a source from before the family
    argument with families (None,)."""
    libs = {}
    for source in (sv._MATVEC_SOURCE, sv._QUAD_SOURCE):
        names = tuple(name for family in families
                      for name in bodies(source, family))
        lib, report = build_variants(
            str(root / "gp_emu_uqsa_torch" / "csrc" / source),
            {label: ("as committed there", [])}, kernel=names,
            label=f"{label}_{Path(source).stem}")[label]
        libs[source] = lib
        for line in report:
            print(f"  {label} ptxas {line}")
    return libs


def calls(xs, xt, w, rhs, family: str, libs: dict):
    """{kernel: a no-argument call of its C entry point in `libs` (from
    `build_sources`) on fixed buffers, returning its output}, as
    ops/serve.py prepares them."""
    m, n = xs.shape[0], xt.shape[0]
    dev = xs.device
    segments = sv._matvec_segments(m, n, R, libs[sv._MATVEC_SOURCE], family)
    slab = torch.zeros((m, R), dtype=torch.float32, device=dev)
    partial = torch.empty((segments, m, R), dtype=torch.float32, device=dev)
    q_high = torch.zeros((m,), dtype=torch.float32, device=dev)
    q_fp32 = torch.zeros((m,), dtype=torch.float32, device=dev)
    ld4, ld256 = -(-n // 4) * 4, -(-n // 256) * 256
    xt_t4 = torch.zeros((D, ld4), dtype=torch.float32, device=dev)
    xt_t4[:, :n] = xt.T
    xt_t256 = torch.zeros((D, ld256), dtype=torch.float32, device=dev)
    xt_t256[:, :n] = xt.T
    w_split = torch.empty((2, n, ld4), dtype=torch.float32, device=dev)
    wt = torch.empty((ld256, ld256), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = sv.quad_splits(m, n, sms)
    q_part = torch.empty((splits, m), dtype=torch.float32, device=dev)
    stream = _build.stream_ptr(xs)

    def entry(source, name, argtypes):
        return _build.entry(libs[source], sv._symbol(name, family), argtypes)

    def run(fn, args, out):
        def call(_keep=(xs, xt, w, rhs, slab, partial, xt_t4, xt_t256,
                        w_split, wt, q_part)):
            err = fn(*args, stream)
            if err:
                raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
            return out
        return call

    return {
        "K3": run(entry(sv._MATVEC_SOURCE, "gp_corr_matvec", sv._MATVEC_ARGTYPES),
                  (xs.data_ptr(), xt.data_ptr(), rhs.data_ptr(),
                   partial.data_ptr(), slab.data_ptr(), m, n, D, R, segments),
                  slab),
        "K4 high": run(entry(sv._QUAD_SOURCE, "gp_corr_quad_tf32x3",
                             sv._QUAD_TF32X3_ARGTYPES),
                       (xs.data_ptr(), xt_t4.data_ptr(), w.data_ptr(),
                        w_split.data_ptr(), q_high.data_ptr(), m, n, D, ld4),
                       q_high),
        "K4 highest": run(entry(sv._QUAD_SOURCE, "gp_corr_quad",
                                sv._QUAD_ARGTYPES),
                          (xs.data_ptr(), xt_t256.data_ptr(), w.data_ptr(),
                           wt.data_ptr(), q_part.data_ptr(), q_fp32.data_ptr(),
                           m, n, D, ld256, splits),
                          q_fp32),
    }


def fp64_answers(xs, xt, w, rhs, family: str):
    """(K3's slab, quad) in fp64 arithmetic on the same fp32 inputs, in
    slices of 4096 queries."""
    w64, rhs64 = w.double(), rhs.double()
    slabs, quads = [], []
    for s in range(0, xs.shape[0], 4096):
        c = sv.corr_plain(xs[s:s + 4096].double(), xt.double(), family)
        slabs.append(c @ rhs64)
        quads.append(torch.sum((c @ w64.T) ** 2, dim=1))
    return torch.cat(slabs), torch.cat(quads)


def entry_error(family: str, dev, m: int = 1 << 20):
    """(max relative error, its d2) of the correlation entries the family's
    K3 rebuilds, against fp64 on the same fp32 inputs. At n = 1 with rhs =
    1, K3 returns each entry c(x*_i, x_0) itself (one product with 1, no
    sum); the queries lie at squared distances uniform over [0, 40]."""
    g = torch.Generator().manual_seed(3)
    direction = torch.randn((m, D), generator=g, dtype=torch.float64)
    direction /= direction.norm(dim=1, keepdim=True)
    radius = torch.sqrt(40.0 * torch.rand((m, 1), generator=g,
                                          dtype=torch.float64))
    xq = (direction * radius).float().to(dev)
    x0 = torch.zeros((1, D), dtype=torch.float32, device=dev)
    ones = torch.ones((1, 1), dtype=torch.float32, device=dev)
    got = sv.corr_matvec(xq, x0, torch.ones(D, device=dev), ones,
                         family=family)[:, 0].double()
    d2 = sv.sq_dists_plain(xq.double(), x0.double())[:, 0]
    want = sv.corr_plain(xq.double(), x0.double(), family)[:, 0]
    rel = (got - want).abs() / want
    at = int(rel.argmax())
    return float(rel[at]), float(d2[at])


def factor(xt, family: str):
    """W = L^-1 (lower triangle, fp32) of the family's training correlation."""
    a = sv.corr_plain(xt, xt, family)
    a.diagonal().add_(NUGGET)
    l, _ = chol.cholesky_with_jitter(a)
    del a
    return torch.tril(chol.tri_inverse(l)).contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout whose Gaussian kernels are compared")
    ap.add_argument("--m", type=int, default=M)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("family_kernels: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"K3/K4 by family at m={args.m}, n={N}, d={D} on {card}")
    libs = build_sources(Path(__file__).resolve().parents[2], "this",
                         sv.FAMILIES)
    parent_libs = (build_sources(Path(args.parent).resolve(), "parent")
                   if args.parent else None)
    # chip_smoke.py phase 2's data: bench.py::_problem's x, seed 0
    x = torch.as_tensor(np.random.default_rng(0).uniform(size=(N, D))
                        .astype(np.float32), device=dev)
    xq = torch.as_tensor(np.random.default_rng(1).uniform(size=(args.m, D))
                         .astype(np.float32), device=dev)
    rhs = torch.as_tensor((np.random.default_rng(2).standard_normal((N, R))
                           / np.sqrt(N)).astype(np.float32), device=dev)
    delta = torch.full((D,), DELTA, dtype=torch.float32, device=dev)
    xs, xt = sv._scaled(xq, x, delta)
    for family in sv.FAMILIES:
        rel, d2 = entry_error(family, dev)
        print(f"  {family:9s} c entries (K3 at n = 1) vs fp64: max relative "
              f"error {rel:.3e} (at d2 = {d2:.3f}; u = 2^-24 = 5.96e-8)")
    times = {}
    for family in sv.FAMILIES:
        w = factor(xt, family)
        slab64, quad64 = fp64_answers(xs, xt, w, rhs, family)
        for kernel, call in calls(xs, xt, w, rhs, family, libs).items():
            ms = launches_ms(call)
            out = call()
            want = slab64 if kernel == "K3" else quad64
            err = float((out.double() - want).abs().max())
            times[(family, kernel)] = ms
            line = (f"  {family:9s} {kernel:10s} {ms:9.3f} ms alone   vs fp64 "
                    f"max abs {err:.3e}")
            if family != "gaussian":
                line += f"   {ms / times[('gaussian', kernel)]:.3f} x the Gaussian"
            if parent_libs is not None and family == "gaussian":
                pcall = calls(xs, xt, w, rhs, family, parent_libs)[kernel]
                tp = launches_ms(pcall)
                same = torch.equal(out, pcall())
                line += f"   parent {tp:9.3f} ms, bitwise equal: {same}"
            print(line, flush=True)
        del w
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
