"""BASELINE config 3: a 10-D synthetic simulator at 500 points,
multi-restart MLE and the full Sobol table.

Port of examples/synthetic-10d/run_10d.py:

    python -m gp_emu_uqsa_torch.examples.synthetic_10d [--device cpu]

The simulator is a smooth Sobol g-function (small a_i: important input),
so the first-order indices have a known ordering. fp64, as the script.
"""
from __future__ import annotations

import numpy as np
import torch

import gp_emu_uqsa_torch.sensitivity as s
from gp_emu_uqsa_torch import Emulator
from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.design_inputs import optLatinHyperCube
from gp_emu_uqsa_torch.examples._common import common_kwargs, parser

A_COEF = np.array([0.0, 0.5, 1.5, 3.0, 6.0, 9.0, 12.0, 15.0, 20.0, 30.0])


def smooth_g(x):
    """Smooth analog of the Sobol g-function (cos instead of |4x-2|).

    f = prod_i (1 + b_i cos(2 pi x_i)),  b_i = 1/(1+a_i) * 0.8
    For independent U(0,1)-ish inputs the factors decouple; inputs with
    larger b_i dominate. Smoothness keeps the GP emulator accurate at n=500.
    """
    b = 0.8 / (1.0 + A_COEF)
    return np.prod(1.0 + b * np.cos(2 * np.pi * x), axis=1)


def main(n=500, tries=8, seed=0, verbose=True, *, x=None,
         dtype=torch.float64, device=None, workdir=None):
    """run_10d.main: (emul, sens, si, ti). x: a given (n, 10) design in
    place of the port's LHC. It writes nothing (workdir is taken for a
    uniform call)."""
    dev = resolve_device(device)
    if x is None:
        x = optLatinHyperCube(10, n, 50, [[0.0, 1.0]] * 10, seed=seed,
                              device=dev)
    x = np.asarray(x, dtype=np.float64)
    y = smooth_g(x)

    emul = Emulator.from_arrays(
        x, y, tries=tries, nugget=1e-8, scale_inputs=False, seed=seed,
        tv_config=(10, 0, 1), dtype=dtype, device=dev)
    emul.train_full(message=verbose)

    sens = s.setup(emul, np.full(10, 0.5), np.full(10, 0.02))
    si = sens.sensitivity()
    ti = sens.totaleffectvariance()
    if verbose:
        print("S_i  =", np.round(si["S_i"].cpu().numpy(), 4))
        print("S_Ti =", np.round(ti["S_Ti"].cpu().numpy(), 4))
    return emul, sens, si, ti


if __name__ == "__main__":
    main(**common_kwargs(parser(__doc__).parse_args()))
