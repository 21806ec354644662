"""Time pass 2 of `parallel.ring_predict` on one card: dense against runs.

    python -m gp_emu_uqsa_torch.tools.ring_pass2 [--m M] [--reps R]

Pass 2 adds |t W_rows^T|^2 over the p visiting blocks of W = L^-1's rows.
This tool runs what one rank of a p = 4 ring computes in one call, with no
process group: t = c(X*, X) for m queries (65536, the queries a rank of
`cfg5.ring_4card` serves in a call) against n = 16384 training points, d
= 8, and the four 4096-row blocks of W that visit it. X, X* and W are the
data of `chip_smoke.py` phase 2 (uniform inputs, delta 0.8, nugget 1e-4;
W the fp32 inverse of the fp32 Cholesky factor). The rows are dealt as
`predictor_large` deals them, in layout blocks of 512 and of 256 rows
round-robin over the 4 ranks, and as the contiguous rows of a whole W
(block 4096).

For each layout it prints the dense pass 2 (one `t @ rows.mT` a visitor,
the product before runs were taken) and the pass over runs of each row
count in `SUBS` (`ring.add_quad`, with the extents `ring.row_extents`
reads), each as the median of R CUDA-event timings after a warm-up; the
time of reading the four visitors' extents to the host; the counter
`ring.pass2`'s share of the dense pairs; the max |difference| of quad
between the two; and each one's max |error| against fp64 arithmetic on
the same fp32 t and W over the first 2048 queries. Every product runs with
TF32 off, as in `ring_predict`.

Needs one NVIDIA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from gp_emu_uqsa_torch.ops import serve as sv
from gp_emu_uqsa_torch.ops.precision import fp32_exact_matmul
from gp_emu_uqsa_torch.parallel import ring
from gp_emu_uqsa_torch.parallel.mesh import RowBlocks
from gp_emu_uqsa_torch.tools.family_kernels import factor
from gp_emu_uqsa_torch.tools.k4_high_variants import time_ms

N, D, M, P = 16384, 8, 65536, 4
DELTA = 0.8
# layout blocks: `predictor_large`'s at block 512 and 256 (the ring cell's
# traffic), and the whole W's contiguous rows
BLOCKS = (512, 256, N // P)
SUBS = (256, 512, 1024)
CHECK = 2048


def problem(m: int, dev):
    """(t, W) in fp32 on dev: t = c(X*, X), W = L^-1 of A = c(X, X) + nugget."""
    x = torch.as_tensor(np.random.default_rng(0).uniform(size=(N, D))
                        .astype(np.float32), device=dev)
    xq = torch.as_tensor(np.random.default_rng(1).uniform(size=(m, D))
                         .astype(np.float32), device=dev)
    delta = torch.full((D,), DELTA, dtype=torch.float32, device=dev)
    xs, xt = sv._scaled(xq, x, delta)
    return sv.corr_plain(xs, xt), factor(xt, "gaussian")


def visitors(w: torch.Tensor, block: int) -> list[torch.Tensor]:
    """The P ranks' rows of w in `RowBlocks` order (a rank's rows ascending)."""
    return [w[RowBlocks(N, P, r, block).index_tensor(w.device)]
            for r in range(P)]


def dense_pass2(t, rows_of):
    quad = torch.zeros(t.shape[0], dtype=t.dtype, device=t.device)
    for rows in rows_of:
        u = t @ rows.mT
        quad += torch.sum(u * u, 1)
    return quad


def runs_pass2(t, rows_of, extents, sub):
    quad = torch.zeros(t.shape[0], dtype=t.dtype, device=t.device)
    for rows, ext in zip(rows_of, extents):
        ring.add_quad(quad, t, rows, ext, sub)
    return quad


def read_extents(rows_of, sub):
    return [ring.row_extents(rows, sub).tolist() for rows in rows_of]


def fp64_quad(t, rows_of):
    quad = torch.zeros(t.shape[0], dtype=torch.float64, device=t.device)
    for rows in rows_of:
        u = t.double() @ rows.double().mT
        quad += torch.sum(u * u, 1)
    return quad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_pass2: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"ring pass 2, one rank of {P}: m = {args.m}, n = {N}, d = {D}, "
          f"visitors of {N // P} rows, median of {args.reps}; {card}",
          flush=True)
    with fp32_exact_matmul():
        t, w = problem(args.m, dev)
        for block in BLOCKS:
            rows_of = visitors(w, block)
            want = fp64_quad(t[:CHECK], rows_of)
            ms, dense = time_ms(lambda: dense_pass2(t, rows_of), args.reps)
            err = float((dense[:CHECK].double() - want).abs().max())
            print(f"layout block {block}: dense {ms:.2f} ms, vs fp64 max abs "
                  f"{err:.3e}", flush=True)
            for sub in SUBS:
                ext_ms, extents = time_ms(lambda: read_extents(rows_of, sub),
                                          args.reps)
                ring.pass2.reset()
                run_ms, quad = time_ms(
                    lambda: runs_pass2(t, rows_of, extents, sub), args.reps)
                diff = float((quad - dense).abs().max())
                err = float((quad[:CHECK].double() - want).abs().max())
                print(f"  runs of {sub:4d} rows: {run_ms:.2f} ms "
                      f"({run_ms / ms:.4f} x dense), share "
                      f"{ring.pass2.share:.4f}, extents {ext_ms:.3f} ms, "
                      f"max |quad - dense| {diff:.3e}, vs fp64 max abs "
                      f"{err:.3e}", flush=True)
            del rows_of
            torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
