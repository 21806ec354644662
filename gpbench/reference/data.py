"""The benchmark's data recipes, made from the run's seed.

Both sides of a comparison get these same tensors: the program as its
inputs, the reference in float64.

  design   x ~ U[0, 1]^d, drawn on the device by a torch.Generator seeded
           with the run's seed, or with the configuration's data seed
           where it states one (float32, as the configurations serve)
  response y = sin(3 x_0) + x_1 x_2 + sum_coef * sum_l x_l, in float64
           and rounded to x's dtype (the configuration file gives
           sum_coef: 0.1 for BASELINE configuration 5's serving data, 0
           for configuration 4's sampler posterior)
"""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def design(n: int, d: int, seed: int, device, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((n, d), generator=gen, device=device, dtype=dtype)


def response(x: torch.Tensor, sum_coef: float) -> torch.Tensor:
    x64 = x.double()
    y = torch.sin(3.0 * x64[:, 0]) + x64[:, 1] * x64[:, 2] + sum_coef * x64.sum(1)
    return y.to(x.dtype)


def training_set(config: dict, seed: int, device):
    """(x, y) of a configuration's training set, in its dtype, on device:
    drawn from the run's seed, or from the configuration's own data seed
    where it states one (a sampler's work follows the posterior's shape,
    so such a configuration samples one posterior in every run)."""
    dtype = DTYPES[config["dtype"]]
    seed = config["data"].get("seed", seed)
    x = design(config["n"], config["d"], seed, device, dtype)
    return x, response(x, config["data"]["sum_coef"])
