"""BASELINE config 1: the 1-D toy simulator, fitted from its config files,
LOO-validated and predicted on a grid.

The JAX package ships this example as data only (examples/toy-sim); this
is its workflow on the port:

    python -m gp_emu_uqsa_torch.examples.toy_sim [--device cpu] [--workdir DIR]

`setup` -> `train` (optimize, validate, fold in the V-sets, `final_build`,
which writes the `-f` beliefs and reordered data beside the inputs) on a
copy of the tree in `workdir`, then `gp.loo_diagnostics` on all the data
and a prediction on a `grid`-point grid over the input range.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gp_emu_uqsa_torch import gp, setup, train
from gp_emu_uqsa_torch.examples._common import (
    common_kwargs, parser, work_tree,
)

X_RANGE = (0.0, 2.0)          # make_data.py draws x ~ U(0, 2)


def toy_sim(x, noise=0.0, rng=None):
    """examples/toy-sim/make_data.py's simulator."""
    y = 3.0 * x[:, 0] * np.sin(5.0 * np.pi * x[:, 0] / 2.0)
    if noise:
        rng = rng or np.random.default_rng(0)
        y = y + noise * rng.standard_normal(len(y))
    return y


def main(seed=0, verbose=True, *, grid=201, max_iters=None,
         dtype=torch.float64, device=None, workdir=None, src=None):
    """(emul, (loo_mean, loo_var, std_err), (x_grid, mean, var)).

    max_iters caps each optimize's L-BFGS iterations (default: MLEConfig's
    200); src: the tree to copy (default examples/toy-sim)."""
    work = work_tree("toy-sim", workdir, src)
    emul = setup(work / "toy-sim_config", dtype=dtype, device=device,
                 seed=seed)
    if max_iters is not None:
        emul.mle_config = dataclasses.replace(emul.mle_config,
                                              max_iters=max_iters)
    train(emul, message=verbose)

    x, y, h = emul.train_view()
    loo_mean, loo_var = gp.loo_diagnostics(emul.state, x, h, y)
    std_err = (y - loo_mean) / torch.sqrt(loo_var)
    xg = np.linspace(*X_RANGE, grid)[:, None]
    mean, var = emul.predict(xg)
    if verbose:
        rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - toy_sim(xg)) ** 2)))
        se = std_err.cpu().numpy()
        print(f"LOO: n={len(se)}, |std err| > 2 at {(np.abs(se) > 2).sum()}, "
              f"max |std err| {np.abs(se).max():.3g}")
        print(f"grid of {grid} points: RMSE against the simulator "
              f"{rmse:.3e}, max sd {float(var.max()) ** 0.5:.3e}")
        print(f"wrote {sorted(p.name for p in work.glob('*-f'))} in {work}")
    return emul, (loo_mean, loo_var, std_err), (xg, mean, var)


if __name__ == "__main__":
    main(**common_kwargs(parser(__doc__).parse_args()))
