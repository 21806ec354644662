"""Time and check the library calls of the training path on the card.

    python -m gp_emu_uqsa_torch.tools.train_linalg [calls] [factors]

`calls`: the library calls of one likelihood evaluation at `chip_smoke.py`
phase 4(a)'s shapes (n = 4096, d = 8, fp32, the 8 LHC starts of the mucm
bounds; the data of `chip_smoke.py::problem`), each timed batched over the
restarts (as the port makes it) and as one call per restart: the Cholesky
in fp32 and, on the same A, in fp64; the triangular solve of [y | H]; and
A^-1 for the adjoint as L^-T L^-1 (the port's form) and as
`cholesky_inverse`. Median CUDA-event time of 3 runs after a warm-up.

`factors`: iterative refinement of the fp32 solve of
tests/test_fp32.py::test_refined_solve_error_bound_n4096's system (n =
4096, d = 4, near-duplicate pairs, kappa about 3e5; a random b), with the
fp64 residual of `gp.fit(refine=...)`, from fp32 factors of several
origins: cuSOLVER (what `torch.linalg.cholesky_ex` takes on the card),
MAGMA, the CPU's LAPACK, and the fp64 factor rounded to fp32. For each it
prints the factor's backward error |L L^T - A| / |A|, the solve's relative
error against the fp64 solve of the same fp32 matrix unrefined and after
one and two sweeps (corrections solved in fp32, and in fp64 with the same
fp32 factor); then the port's `cho_solve_refined` (corrections through
the fp64 factor) from the cuSOLVER factor. Times, at n = 4096 and n =
16384: each factorization, `cho_solve` of 10 columns and
`cho_solve_refined` of 10 columns with one sweep.

Needs one NVIDIA card; imports no JAX.
"""
from __future__ import annotations

import contextlib
import subprocess
import sys

import numpy as np
import torch

from gp_emu_uqsa_torch import kernels
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference import lbfgs
from gp_emu_uqsa_torch.ops import cholesky as chol
from gp_emu_uqsa_torch.ops.precision import fp32_exact_matmul

N_FIT, D, TRIES, NUGGET = 4096, 8, 8, 1e-4


def time_ms(fn, reps: int = 3) -> float:
    """Median CUDA-event time of fn() over `reps` runs after one warm-up."""
    fn()
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


def fit_problem(n: int, d: int = D, seed: int = 0):
    """chip_smoke.py::problem: x ~ U[0,1]^d, y = sin(3x0) + x1 x2 + 0.1 sum x."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x.sum(1)
    return x, y.astype(np.float32)


def calls(dev, card):
    x_np, y_np = fit_problem(N_FIT)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    h = basis_matrix(x, linear_basis(D))
    cfg = lbfgs.MLEConfig(tries=TRIES, nugget=NUGGET)
    lo, hi = lbfgs._default_bounds(cfg, D)
    z0 = lbfgs._lhc_starts(torch.Generator().manual_seed(0), TRIES, lo, hi,
                           torch.float64)
    params = lbfgs._unpack(z0.float().to(dev), cfg, D, torch.float32)
    a = kernels.corr_self(x, params)
    b = a.shape[0]
    l = torch.linalg.cholesky_ex(a)[0]
    rhs = torch.cat([y[:, None], h], dim=1)
    print(f"[calls] one evaluation's library calls, {b} x {N_FIT}^2, fp32 "
          f"({card})")
    with fp32_exact_matmul():
        a64 = a.double()
        cases = (
            ("cholesky_ex", lambda: torch.linalg.cholesky_ex(a),
             lambda: [torch.linalg.cholesky_ex(a[i]) for i in range(b)]),
            ("cholesky_ex of the same A in fp64",
             lambda: torch.linalg.cholesky_ex(a64),
             lambda: [torch.linalg.cholesky_ex(a64[i]) for i in range(b)]),
            (f"solve_triangular, {rhs.shape[1]} right-hand sides",
             lambda: chol.tri_solve(l, rhs),
             lambda: [chol.tri_solve(l[i], rhs) for i in range(b)]),
            ("A^-1 = L^-T L^-1 (tri_inverse and a product)",
             lambda: (lambda w: w.mT @ w)(chol.tri_inverse(l)),
             lambda: [(lambda w: w.mT @ w)(chol.tri_inverse(l[i]))
                      for i in range(b)]),
            ("A^-1 = cholesky_inverse", lambda: torch.cholesky_inverse(l),
             lambda: [torch.cholesky_inverse(l[i]) for i in range(b)]),
        )
        for name, batched, looped in cases:
            print(f"  {name}: {time_ms(batched):.3f} ms batched, "
                  f"{time_ms(looped):.3f} ms one call per restart")
    del a, a64, l
    torch.cuda.empty_cache()


def refine_system(n: int, dev):
    """tests/test_fp32.py::_clustered_kernel_system (d = 4, delta 1.2,
    nugget 1e-2; the matmul-expansion build in fp64) rounded to fp32, and
    its random b in fp32."""
    rng = np.random.default_rng(3)
    base = rng.uniform(size=(n // 2, 4))
    xs = np.vstack([base, base + 1e-3 * rng.standard_normal((n // 2, 4))])
    aa = xs / 1.2
    sq = (aa * aa).sum(1)
    a = np.exp(-np.maximum(sq[:, None] + sq[None, :] - 2.0 * aa @ aa.T, 0.0))
    a += 1e-2 * np.eye(n)
    b = rng.standard_normal(n)
    return (torch.as_tensor(a, device=dev).float(),
            torch.as_tensor(b, device=dev).float())


@contextlib.contextmanager
def linalg_library(name):
    """torch's preferred CUDA linear-algebra library for the block."""
    saved = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(name)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)


def _factor(origin, a32):
    if origin == "fp64 factor rounded":
        return lambda: torch.linalg.cholesky_ex(a32.double())[0].float()
    if origin == "LAPACK (CPU)":
        return lambda: torch.linalg.cholesky_ex(a32.cpu())[0].to(a32.device)
    lib = {"cuSOLVER": "cusolver", "MAGMA": "magma"}[origin]

    def run():
        with linalg_library(lib):
            return torch.linalg.cholesky_ex(a32[None])[0][0]
    return run


def factors(dev, card):
    n = N_FIT
    a32, b32 = refine_system(n, dev)
    a64, b64 = a32.double(), b32.double()
    x_true = torch.linalg.solve(a64, b64)

    def rel(x):
        return float((x.double() - x_true).norm() / x_true.norm())

    print(f"[factors] refinement of the fp32 solve, n={n}, from fp32 "
          f"factors of four origins ({card})")
    origins = ("cuSOLVER", "MAGMA", "LAPACK (CPU)", "fp64 factor rounded")
    for origin in origins:
        l = _factor(origin, a32)()
        l64 = l.double()
        back = float((l64 @ l64.mT - a64).norm() / a64.norm())
        rows = []
        for corr in ("fp32", "fp64"):
            x = chol.cho_solve(l, b32[:, None])[:, 0]
            errs = [rel(x)]
            for _ in range(2):
                r = b64 - a64 @ x.double()
                dx = (chol.cho_solve(l, r.float()[:, None])[:, 0]
                      if corr == "fp32"
                      else chol.cho_solve(l64, r[:, None])[:, 0].float())
                x = x + dx
                errs.append(rel(x))
            rows.append(f"corrections in {corr}: " + " -> ".join(
                f"{e:.3e}" for e in errs))
        print(f"  {origin}: |LL^T - A|/|A| {back:.3e}; unrefined, one sweep, "
              f"two sweeps: {'; '.join(rows)}")
    l = _factor("cuSOLVER", a32)()
    errs = [rel(chol.cho_solve_refined(l, a32, b32[:, None], iters=k)[:, 0])
            for k in (0, 1, 2)]
    print("  the port's cho_solve_refined (corrections through the fp64 "
          "factor), from the cuSOLVER factor: " + " -> ".join(
              f"{e:.3e}" for e in errs))
    for n_t in (N_FIT, 16384):
        a_t = a32 if n_t == n else refine_system(n_t, dev)[0]
        times = {o: time_ms(_factor(o, a_t)) for o in origins
                 if o != "LAPACK (CPU)"}
        l_t = _factor("cuSOLVER", a_t)()
        b_t = torch.ones(n_t, 10, device=dev)
        times["cho_solve, 10 columns"] = time_ms(
            lambda: chol.cho_solve(l_t, b_t))
        times["cho_solve_refined, 10 columns, one sweep"] = time_ms(
            lambda: chol.cho_solve_refined(l_t, a_t, b_t, iters=1))
        del l_t
        print(f"  at n={n_t}: " + ", ".join(
            f"{o} {t:.3f} ms" for o, t in times.items()))
        del a_t
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("train_linalg: no CUDA device", file=sys.stderr)
        return 1
    sections = (sys.argv[1:] if argv is None else argv) or ["calls",
                                                           "factors"]
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for section in sections:
        {"calls": calls, "factors": factors}[section](dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
