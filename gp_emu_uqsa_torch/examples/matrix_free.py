"""The matrix-free GP workflow: training and serving without a dense A.

Port of examples/matrix-free/run_matrix_free.py:

    python -m gp_emu_uqsa_torch.examples.matrix_free [--device cpu]

  1. warm-start the hyperparameters with an exact subset MLE,
  2. refine them matrix-free on all points (`mle_fit_matrix_free`: PCG
     solves, preconditioned SLQ log-determinant, Hutchinson gradients),
  3. serving weights by CG (`fit_matrix_free`) and the mean at 500 held-out
     points by kernel matvecs (`predict_mean_matrix_free`; K3 for fp32 on
     the card).
fp64, as the script (it enables x64).
"""
from __future__ import annotations

import numpy as np
import torch

from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.examples._common import common_kwargs, parser
from gp_emu_uqsa_torch.inference import MLEConfig, mle_fit
from gp_emu_uqsa_torch.inference.matrix_free import (
    MFConfig, mle_fit_matrix_free,
)
from gp_emu_uqsa_torch.ops.cg import fit_matrix_free, predict_mean_matrix_free


def simulator(x):
    return np.sin(3 * x[:, 0]) + np.sin(2 * x[:, 1]) + 0.3 * x[:, 0] * x[:, 1]


def main(n=800, n_sub=200, d=2, seed=0, verbose=True, *, steps=60,
         dtype=torch.float64, device=None, workdir=None):
    """run_matrix_free.main: (params, fit, rmse), rmse the serving RMSE
    against the noiseless simulator. steps: Adam steps of the matrix-free
    refinement. It writes nothing (workdir is taken for a uniform call)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x_np = rng.uniform(size=(n, d))
    y_np = simulator(x_np) + 0.05 * rng.standard_normal(n)
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    y = torch.as_tensor(y_np, dtype=dtype, device=dev)
    spec = linear_basis(d)
    h = basis_matrix(x, spec)

    # 1. exact subset MLE as warm start
    p0, _ = mle_fit(
        torch.Generator().manual_seed(seed), x[:n_sub], y[:n_sub], h[:n_sub],
        MLEConfig(mode="mucm", tries=4, train_nugget=True,
                  nugget_bounds=(1e-6, 1.0)),
    )

    # 2. matrix-free refinement on ALL points
    cfg = MFConfig(num_probes=8, lanczos_k=24, cg_tol=1e-7,
                   cg_maxiter=500, chunk=256, precond_rank=48)
    p, info = mle_fit_matrix_free(
        torch.Generator(device=dev).manual_seed(seed + 1), x, y, h,
        steps=steps, learning_rate=0.03, min_nugget=1e-4, init=p0, cfg=cfg,
    )
    if verbose:
        tr = info["nll_trace"].cpu().numpy()
        print(f"NLL {tr[0]:.1f} -> {tr[-1]:.1f} over {len(tr)} steps")
        print("delta", torch.exp(p.log_delta).cpu().numpy(),
              "nugget", float(torch.exp(p.log_nugget)))

    # 3. matrix-free serving
    ff = fit_matrix_free(p, x, y, h, chunk=256, tol=1e-8, maxiter=1000,
                         precond_rank=48)
    xs_np = rng.uniform(size=(500, d))
    xs = torch.as_tensor(xs_np, dtype=dtype, device=dev)
    mean = predict_mean_matrix_free(ff, x, xs, basis_matrix(xs, spec), p,
                                    chunk=256)
    rmse = float(np.sqrt(np.mean((mean.cpu().double().numpy()
                                  - simulator(xs_np)) ** 2)))
    if verbose:
        print(f"serving RMSE on 500 held-out points: {rmse:.4f}")
    return p, ff, rmse


if __name__ == "__main__":
    main(**common_kwargs(parser(__doc__).parse_args()))
