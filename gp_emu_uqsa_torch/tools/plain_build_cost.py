"""Cost of the plain correlation build on the card, for one checkout.

The plain build (`kernels.scaled_sq_dists`) is what every path takes that
K1/K2 do not cover: fp64, fp32 below the kernels' sizes, d > 20, the
non-gaussian families. This times, on the CUDA card, each with its peak
`torch.cuda.max_memory_allocated`:

- the distance alone, n x n at n = 16384, d = 8, fp64 and fp32;
- an fp64 refit, `gp.fit` at n = 16384 (build, Cholesky, solves);
- an fp64 `gp.predict` at m = 65536 against those n = 16384 rows;
- one value and gradient of the gp4ml likelihood (autograd through the
  build) for 8 restarts at n = 4096 in fp64.

`--repo DIR` imports `gp_emu_uqsa_torch` from another checkout (an unpacked
older commit), so that two trees are compared on one machine:

    python gp_emu_uqsa_torch/tools/plain_build_cost.py [--repo DIR] \\
        [--label NAME] [--out FILE]

It prints one JSON line (and appends it to FILE).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N, M, D, N_GRAD, RESTARTS = 16384, 65536, 8, 4096, 8
DELTA, NUGGET = 0.8, 1e-4


def _timed(fn, reps=3):
    """(median ms over `reps` calls after one warm-up, peak GiB, result)."""
    out = fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        del out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return float(np.median(times)), peak, out


def _data(n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, D))
    y = np.sin(2 * np.pi * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x[:, 3]
    return (torch.tensor(x, dtype=dtype, device="cuda"),
            torch.tensor(y, dtype=dtype, device="cuda"))


def measure(repo: Path) -> dict:
    sys.path.insert(0, str(repo))
    from gp_emu_uqsa_torch import gp, kernels
    from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis

    if not Path(kernels.__file__).resolve().is_relative_to(repo):
        raise RuntimeError(f"imported {kernels.__file__}, not from {repo}")
    res = {}
    for dtype, name in ((torch.float64, "fp64"), (torch.float32, "fp32")):
        x, _ = _data(N, dtype, 0)
        delta = torch.full((D,), DELTA, dtype=dtype, device="cuda")
        ms, gib, out = _timed(lambda: kernels.scaled_sq_dists(x, x, delta))
        res[f"dist_{name}_n{N}"] = {"ms": ms, "peak_gib": gib}
        del out, x

    f64 = torch.float64
    x, y = _data(N, f64, 0)
    spec = linear_basis(D)
    h = basis_matrix(x, spec)
    params = kernels.params_from_numpy(np.log(np.full(D, DELTA)), 0.0,
                                       np.log(NUGGET), device="cuda",
                                       dtype=f64)
    ms, gib, state = _timed(lambda: gp.fit(params, x, y, h))
    res[f"refit_fp64_n{N}"] = {"ms": ms, "peak_gib": gib,
                               "nll": float(state.nll)}
    xs, _ = _data(M, f64, 1)
    hs = basis_matrix(xs, spec)
    ms, gib, (mean, var) = _timed(
        lambda: gp.predict(state, x, h, xs, hs))
    res[f"predict_fp64_m{M}_n{N}"] = {
        "ms": ms, "peak_gib": gib, "mean_sum": float(mean.sum()),
        "var_sum": float(var.sum())}
    del state, mean, var, xs, hs, x, y, h

    x, y = _data(N_GRAD, f64, 2)
    h = basis_matrix(x, spec)
    rng = np.random.default_rng(3)
    log_delta = torch.tensor(np.log(rng.uniform(0.3, 1.5, (RESTARTS, D))),
                             dtype=f64, device="cuda")
    log_s2 = torch.zeros(RESTARTS, dtype=f64, device="cuda")
    log_nug = torch.full((RESTARTS,), np.log(1e-4), dtype=f64, device="cuda")

    def value_and_grad():
        ld = log_delta.clone().requires_grad_(True)
        ls = log_s2.clone().requires_grad_(True)
        v = gp.nll(kernels.GPParams(ld, ls, log_nug), x, y, h, mode="gp4ml")
        g = torch.autograd.grad(v.sum(), (ld, ls))
        return v.detach(), g[0]

    ms, gib, (v, g) = _timed(value_and_grad)
    res[f"gp4ml_value_grad_fp64_{RESTARTS}x{N_GRAD}"] = {
        "ms": ms, "peak_gib": gib, "nll_sum": float(v.sum()),
        "grad_abs_max": float(g.abs().max())}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout to import gp_emu_uqsa_torch from "
                         "(default: this one)")
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    repo = Path(args.repo).resolve()
    line = json.dumps({"tree": args.label or str(repo), "card": card,
                       **measure(repo)})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
