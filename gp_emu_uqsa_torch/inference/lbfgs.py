"""Hyperparameter-fit configuration (port of `gp_emu_uqsa_tpu.inference.lbfgs`).

The serving path needs only the configuration that an `Emulator` and its
checkpoint carry. The batched multi-restart L-BFGS (`mle_fit`) comes with
the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MLEConfig:
    """Hyperparameter-fit configuration (reference config-file surface).

    delta/sigma/nugget bounds are in NATURAL space, like the reference's
    `delta_bounds`/`sigma_bounds` config entries; None => wide defaults.
    """

    mode: str = "mucm"                # "mucm" (sigma2 profiled) or "gp4ml"
    family: str = "gaussian"          # correlation family (kernels.CORR_FAMILIES)
    tries: int = 8                    # restarts (reference `tries`)
    max_iters: int = 200
    tol: float = 1e-8                 # gradient-norm stop
    train_nugget: bool = False        # reference `fix_nugget F/T`
    nugget: float = 1e-8              # value when fixed
    delta_bounds: Optional[tuple] = None    # (lo, hi) scalars or (d,) arrays
    sigma_bounds: Optional[tuple] = None
    nugget_bounds: Optional[tuple] = None
    constraints: str = "bounds"       # "bounds" | "none" (reference `constraints`)
