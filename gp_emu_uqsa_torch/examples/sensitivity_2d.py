"""The file-driven sensitivity workflow: config, beliefs and data files ->
training -> the analytic UQSA table.

Port of examples/sensitivity-2d/run_sensitivity.py:

    python -m gp_emu_uqsa_torch.examples.sensitivity_2d [--device cpu] \
        [--workdir DIR]

`setup` + `train` from the text files, then the MUCM indices for inputs
x_i ~ N(0.5, 0.02) in the scaled input space, the table written with
`to_file("sens2d_indices")` and the main effect of x1 on 40 points. Runs
on a copy of the tree in `workdir`, where `train` and `to_file` write.
"""
from __future__ import annotations

import dataclasses

import torch

import gp_emu_uqsa_torch.sensitivity as s
from gp_emu_uqsa_torch import setup, train
from gp_emu_uqsa_torch.examples._common import (
    common_kwargs, parser, work_tree,
)


def main(verbose=True, *, max_iters=None, dtype=torch.float64, device=None,
         workdir=None, src=None):
    """run_sensitivity.py as a function: (emul, sens, work), work the
    directory the workflow ran and wrote in. max_iters caps the L-BFGS
    iterations (default: MLEConfig's 200); src: the tree to copy."""
    work = work_tree("sensitivity-2d", workdir, src)
    emul = setup(work / "sens2d_config", dtype=dtype, device=device)
    if max_iters is not None:
        emul.mle_config = dataclasses.replace(emul.mle_config,
                                              max_iters=max_iters)
    train(emul, auto=True, message=verbose)

    sens = s.setup(emul, [0.5, 0.5], [0.02, 0.02])
    res = sens.sensitivity()
    tot = sens.totaleffectvariance()
    unc = sens.uncertainty()
    if verbose:
        print(f"E*[E(Y)] = {float(unc['E_EY']):.5g}  "
              f"V*[E(Y)] = {float(unc['V_EY']):.3g}")
        for i in range(2):
            print(f"x{i+1}: S_i = {float(res['S_i'][i]):.4f}  "
                  f"S_Ti = {float(tot['S_Ti'][i]):.4f}")
    sens.to_file(work / "sens2d_indices")
    sens.main_effect(0, points=40)
    return emul, sens, work


if __name__ == "__main__":
    main(**common_kwargs(parser(__doc__).parse_args()))
