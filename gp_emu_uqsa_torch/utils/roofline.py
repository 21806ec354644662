"""Shared measurement problems (port of part of
`gp_emu_uqsa_tpu.utils.roofline`).

Only `gp_test_posterior` so far: the card's roofs and the timing helpers
of the JAX module are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference.lbfgs import MLEConfig


def gp_test_posterior(n: int, d: int, dtype=torch.float32, device=None):
    """The shared synthetic GP-hyperparameter posterior every sampler
    measurement uses: (x, y, h, MLEConfig) on `device` (None: the card).

    x: seed-0 uniform inputs (n, d); y = sin(3 x0) + x1 x2; linear basis;
    MUCM likelihood with nugget 1e-4 (at fp32 a 1e-6 nugget makes the
    n = 1024 factorization fail and every proposal reject). The same data
    as the JAX package's function, drawn in fp64 and cast.
    """
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(size=(n, d)), dtype=dtype,
                        device=resolve_device(device))
    y = torch.sin(3.0 * x[:, 0]) + x[:, 1] * x[:, 2]
    h = basis_matrix(x, linear_basis(d))
    return x, y, h, MLEConfig(mode="mucm", nugget=1e-4)
