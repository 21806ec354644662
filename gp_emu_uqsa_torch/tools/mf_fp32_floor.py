"""fp32 against fp64 for the matrix-free estimator, across nuggets.

    python -m gp_emu_uqsa_torch.tools.mf_fp32_floor [--n 131072 16384]
        [--nuggets 5e-4 1e-3 2e-3 4e-3 8e-3] [--delta 1.40 2.29]
        [--device cuda]

On `examples/matrix-free`'s data (its simulator, x ~ U[0,1)^2 from seed 0,
noise sd 0.05, linear basis, fp32 inputs) at each n and nugget:
- `inference.matrix_free.nll_and_grad_from_probes` with the example's
  MFConfig (8 probes, 24 Lanczos steps, rank-48 preconditioner, cg_tol
  1e-5) in fp32 (K3 and K2 on the card) and in fp64 (the plain chunked
  build, cg_tol 1e-8) from the same Rademacher probes: the NLL's relative
  difference and the (log delta, log nugget) gradients' cosine and norm
  ratio, which is fp32's rounding alone;
- `ops.cg.fit_matrix_free` in fp32 (tol 1e-5): PCG iterations, the true
  residual |b - A x| / |b| with A applied in fp64, and the served mean's
  RMSE against the noiseless simulator at 65536 queries.
The delta default is the fp32 subset MLE's in `chip_smoke.py` phase 7 (b).
One line a case, then one JSON line of all of them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference import matrix_free as mf
from gp_emu_uqsa_torch.kernels import GPParams
from gp_emu_uqsa_torch.ops import cg as cgmod

CFG = mf.MFConfig(num_probes=8, lanczos_k=24, cg_tol=1e-5, cg_maxiter=500,
                  chunk=256, precond_rank=48)
TOL64 = 1e-8
M_QUERIES = 65536


def simulator(x):
    """examples/matrix-free/run_matrix_free.py's simulator."""
    return (np.sin(3 * x[:, 0]) + np.sin(2 * x[:, 1])
            + 0.3 * x[:, 0] * x[:, 1])


def data(n, m, dev):
    """The example's data rule: (x, y, h, xs, hs, the simulator at xs),
    fp32 on dev."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(n, 2))
    y = simulator(x) + 0.05 * rng.standard_normal(n)
    xs = rng.uniform(size=(m, 2))
    spec = linear_basis(2)
    tx = torch.as_tensor(x, dtype=torch.float32, device=dev)
    txs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    return (tx, torch.as_tensor(y, dtype=torch.float32, device=dev),
            basis_matrix(tx, spec), txs, basis_matrix(txs, spec),
            simulator(xs))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def evaluate(p, x, y, h, probes, cfg, dt):
    """(NLL, (log delta, log nugget) gradient in fp64, PCG iterations,
    seconds) of nll_and_grad_from_probes in dtype dt."""
    t0 = time.perf_counter()
    nll, g, aux = mf.nll_and_grad_from_probes(
        GPParams(*(t.to(dt) for t in p)), x.to(dt), y.to(dt), h.to(dt),
        tuple(t.to(dt) for t in probes), cfg)
    _sync(x.device)
    return (float(nll), torch.cat([g.log_delta, g.log_nugget[None]])
            .double().cpu(), aux["cg_info"]["iters"],
            time.perf_counter() - t0)


def case(n, nugget, delta, dev, m):
    """One (n, nugget) row."""
    x, y, h, xs, hs, truth = data(n, m, dev)
    p = GPParams(torch.log(torch.tensor(delta, device=dev)),
                 torch.zeros((), device=dev),
                 torch.tensor(math.log(nugget), device=dev))
    probes = mf.matrix_free_probes(torch.Generator(device=dev).manual_seed(1),
                                   n, CFG, torch.float32)
    r32 = evaluate(p, x, y, h, probes, CFG, torch.float32)
    r64 = evaluate(p, x, y, h, probes, dataclasses.replace(CFG, cg_tol=TOL64),
                   torch.float64)
    g32, g64 = r32[1], r64[1]
    ff = cgmod.fit_matrix_free(p, x, y, h, chunk=CFG.chunk, tol=CFG.cg_tol,
                               maxiter=1000, precond_rank=CFG.precond_rank)
    mean = cgmod.predict_mean_matrix_free(ff, x, xs, hs, p)
    rhs = torch.cat([y[:, None], h], dim=1).double()
    sol = torch.cat([(ff["e"] + ff["ainv_h"] @ ff["beta"])[:, None],
                     ff["ainv_h"]], dim=1).double()
    a64 = cgmod.make_corr_matvec(x.double(), GPParams(*(t.double() for t in p)),
                                 chunk=CFG.chunk)
    resid = float((torch.linalg.vector_norm(rhs - a64(sol), dim=0)
                   / torch.linalg.vector_norm(rhs, dim=0)).max())
    rmse = float(np.sqrt(np.mean((mean.double().cpu().numpy() - truth) ** 2)))
    return {"n": n, "nugget": nugget,
            "nll_rel_diff": abs(r32[0] - r64[0]) / abs(r64[0]),
            "grad_cosine": float(g32 @ g64 / (g32.norm() * g64.norm())),
            "grad_norm_ratio": float(g32.norm() / g64.norm()),
            "grad_fp32": g32.tolist(), "grad_fp64": g64.tolist(),
            "pcg_iters_fp32": r32[2], "pcg_iters_fp64": r64[2],
            "fit_pcg_iters": ff["info"]["iters"], "fit_true_resid": resid,
            "rmse": rmse, "seconds_fp32": r32[3], "seconds_fp64": r64[3]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[131072, 16384])
    ap.add_argument("--nuggets", type=float, nargs="+",
                    default=[5e-4, 1e-3, 2e-3, 4e-3, 8e-3])
    ap.add_argument("--delta", type=float, nargs=2, default=[1.40, 2.29])
    ap.add_argument("--m", type=int, default=M_QUERIES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    rows = []
    for n in args.n:
        for nugget in args.nuggets:
            r = case(n, nugget, args.delta, dev, args.m)
            rows.append(r)
            print(f"n={n} nugget={nugget:g}: fp32 vs fp64 NLL rel diff "
                  f"{r['nll_rel_diff']:.3e}, gradient cosine "
                  f"{r['grad_cosine']:.4f}, norm ratio "
                  f"{r['grad_norm_ratio']:.3f} ({r['grad_fp32']} / "
                  f"{r['grad_fp64']}); PCG {r['pcg_iters_fp32']} / "
                  f"{r['pcg_iters_fp64']}; fit: PCG {r['fit_pcg_iters']}, "
                  f"true resid {r['fit_true_resid']:.3e}, RMSE "
                  f"{r['rmse']:.4e}; {r['seconds_fp32']:.2f} / "
                  f"{r['seconds_fp64']:.2f} s", flush=True)
    print(json.dumps({"delta": args.delta, "rows": rows}))


if __name__ == "__main__":
    main()
