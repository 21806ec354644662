"""Heteroscedastic noise fitting, on arrays and from the config files.

Port of examples/noise-fit/run_noisefit.py (`main`) and
run_noisefit_files.py (`main_files`):

    python -m gp_emu_uqsa_torch.examples.noise_fit [--files] [--device cpu] \
        [--workdir DIR]

A 1-D simulator whose noise sd grows with x (0.1 + 0.4 x). The alternating
fit (`noise_fit.noisefit_arrays`) recovers the signal emulator and the
input-dependent noise surface. `main_files` runs `noisefit` on a copy of
the tree in `workdir`, where it writes the per-iteration noise files, the
final `noisefit_output-noise` and the `-f` beliefs of both GPs. The noise
fit runs in fp64, as the scripts.
"""
from __future__ import annotations

import numpy as np
import torch

from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.examples._common import (
    common_kwargs, parser, work_tree,
)
from gp_emu_uqsa_torch.noise_fit import (
    noisefit, noisefit_arrays, predict_noise,
)


def simulator(x, rng):
    signal = 2.0 * np.sin(2 * np.pi * x)
    noise_sd = 0.1 + 0.4 * x          # heteroscedastic: quiet left, loud right
    return signal + noise_sd * rng.standard_normal(x.shape), noise_sd


def _fp64(dtype):
    if dtype != torch.float64:
        raise ValueError(f"the noise fit runs in float64, not {dtype}")


def main(n=200, seed=0, verbose=True, *, stopat=5, tries=3,
         dtype=torch.float64, device=None, workdir=None):
    """run_noisefit.main: (result, est_sd, true_sd) on a 19-point grid.
    It writes nothing (workdir is taken for a uniform call)."""
    _fp64(dtype)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, n)
    y, _ = simulator(x, rng)

    result = noisefit_arrays(x, y, stopat=stopat, tries=tries, seed=seed,
                             message=verbose, device=resolve_device(device))

    xg = np.linspace(0.05, 0.95, 19)
    est_sd = np.sqrt(predict_noise(result, xg))
    true_g = 0.1 + 0.4 * xg
    if verbose:
        print("x      true sd   estimated sd")
        for xi, ti, ei in zip(xg[::3], true_g[::3], est_sd[::3]):
            print(f"{xi:5.2f}  {ti:8.3f}  {ei:12.3f}")
        ratio = est_sd / true_g
        print(f"mean est/true sd ratio: {ratio.mean():.3f}")
    return result, est_sd, true_g


def main_files(stopat=5, olhcmult=100, verbose=True, *,
               dtype=torch.float64, device=None, workdir=None, src=None):
    """run_noisefit_files.py as a function: (result, est_sd on a 10-point
    grid of the scaled input, work), work the directory it wrote in."""
    _fp64(dtype)
    work = work_tree("noise-fit", workdir, src)
    result = noisefit(work / "noisefit_data_config",
                      work / "noisefit_noise_config", stopat=stopat,
                      olhcmult=olhcmult, message=verbose,
                      device=resolve_device(device))
    xg = np.linspace(0.05, 0.95, 10)
    est_sd = np.sqrt(predict_noise(result, xg))
    if verbose:
        print("x, estimated sd (true sd = 0.1 + 0.4 x):")
        for xi, ei in zip(xg, est_sd):
            print(f"{xi:5.2f}  {ei:8.3f}")
    return result, est_sd, work


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--files", action="store_true",
                    help="run_noisefit_files.py's workflow on the config "
                         "files")
    args = ap.parse_args()
    (main_files if args.files else main)(**common_kwargs(args))
