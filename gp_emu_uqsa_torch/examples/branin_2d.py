"""BASELINE config 2: a 2-D Branin emulator with a trained nugget, and its
main-effect sensitivity indices.

Port of examples/branin-2d/run_branin.py:

    python -m gp_emu_uqsa_torch.examples.branin_2d [--device cpu]

Maximin LHC design -> noisy Branin evaluations -> GP emulator with a
trained nugget (`Emulator.from_arrays(train_nugget=True)`, `train_full`)
-> the analytic indices (`sensitivity`, `totaleffectvariance`,
`uncertainty`). fp64, as the script (it enables x64).
"""
from __future__ import annotations

import numpy as np
import torch

import gp_emu_uqsa_torch.sensitivity as s
from gp_emu_uqsa_torch import Emulator
from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.design_inputs import optLatinHyperCube
from gp_emu_uqsa_torch.examples._common import common_kwargs, parser

MINMAX = [[-5.0, 10.0], [0.0, 15.0]]


def branin(x1, x2):
    """Branin-Hoo on its standard domain x1 in [-5,10], x2 in [0,15]."""
    a, b, c = 1.0, 5.1 / (4 * np.pi**2), 5 / np.pi
    r, t = 6.0, 1 / (8 * np.pi)
    return (a * (x2 - b * x1**2 + c * x1 - r) ** 2
            + 10 * (1 - t) * np.cos(x1) + 10)


def main(n=80, noise_sd=2.0, seed=0, verbose=True, *, tries=8, x=None,
         dtype=torch.float64, device=None, workdir=None):
    """run_branin.main: (emul, sens). x: a given (n, 2) design in place of
    the port's LHC (whose candidates differ from the JAX package's); tries:
    the L-BFGS restarts. It writes nothing (workdir is taken for a uniform
    call)."""
    dev = resolve_device(device)
    if x is None:
        x = optLatinHyperCube(2, n, 200, MINMAX, seed=seed, device=dev)
    x = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed)
    y = branin(x[:, 0], x[:, 1]) + noise_sd * rng.standard_normal(len(x))

    emul = Emulator.from_arrays(
        x, y, tries=tries, train_nugget=True, nugget_bounds=(1e-8, 1.0),
        seed=seed, dtype=dtype, device=dev)
    emul.train_full(message=verbose)

    # input distribution: independent normals at domain centers (scaled space)
    sens = s.setup(emul, [0.5, 0.5], [0.04, 0.04])
    si = sens.sensitivity()
    ti = sens.totaleffectvariance()
    unc = sens.uncertainty()
    if verbose:
        print("E*[E Y] =", float(unc["E_EY"]))
        print("S_i  =", si["S_i"].cpu().numpy())
        print("S_Ti =", ti["S_Ti"].cpu().numpy())
    return emul, sens


if __name__ == "__main__":
    main(**common_kwargs(parser(__doc__).parse_args()))
