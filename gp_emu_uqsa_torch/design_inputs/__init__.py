"""Optimized (maximin) Latin-hypercube experimental design.

Port of `gp_emu_uqsa_tpu.design_inputs`, reference
`optLatinHyperCube(dim, n, N, minmax, filename)`: draw N candidate LHCs,
keep the one maximizing the minimum pairwise distance, rescale to the
per-dimension [min, max] ranges, write a whitespace file.

The candidates come from an explicit CPU `torch.Generator(seed)`, so the
designs differ from the JAX package's `jax.random` draws. The maximin score
sums exact per-feature differences (the JAX package's matmul expansion
cancels for close points, the very pairs the score looks for).
"""
from __future__ import annotations

import numpy as np
import torch

from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.dataio import save_matrix


def _candidate_lhc(generator: torch.Generator, dim: int, n: int) -> torch.Tensor:
    """One stratified LHC sample in [0,1]^dim, fp64 on the CPU: per-dim
    permuted strata plus a uniform offset in each stratum."""
    perms = torch.stack([torch.randperm(n, generator=generator)
                         for _ in range(dim)], dim=1)        # (n, dim)
    u = torch.rand((n, dim), generator=generator, dtype=torch.float64)
    return (perms.to(torch.float64) + u) / n


def _min_sq_dist(x: torch.Tensor) -> torch.Tensor:
    """Smallest squared distance between two distinct rows of x (n, dim)."""
    d2 = torch.zeros((x.shape[0], x.shape[0]), dtype=x.dtype, device=x.device)
    for l in range(x.shape[1]):
        t = x[:, l, None] - x[None, :, l]
        d2.addcmul_(t, t)
    d2.fill_diagonal_(float("inf"))              # ignore self-distances
    return torch.min(d2)


def _best_lhc(generator: torch.Generator, dim: int, n: int,
              n_candidates: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw n_candidates LHCs, score them on `device`: (best design, its
    maximin score)."""
    designs = torch.stack([_candidate_lhc(generator, dim, n)
                           for _ in range(n_candidates)]).to(device)
    scores = torch.stack([_min_sq_dist(x) for x in designs])
    best = int(torch.argmax(scores))
    return designs[best], scores[best]


def optLatinHyperCube(
    dim: int,
    n: int,
    N: int,
    minmax,
    filename: str | None = None,
    *,
    seed: int = 0,
    device=None,
):
    """Maximin-optimized LHC design (reference API).

    Args:
      dim: number of inputs.
      n: number of design points.
      N: number of candidate LHCs to draw.
      minmax: per-dim [min, max] list, shape (dim, 2).
      filename: if given, write the whitespace design file.
      seed: seed of the CPU torch.Generator that draws the candidates.
      device: where the candidates are scored; None means the CUDA card.

    Returns the (n, dim) design as a NumPy array in raw (unscaled) space.
    """
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    design, _ = _best_lhc(generator, dim, n, N, dev)
    mm = np.asarray(minmax, dtype=np.float64).reshape(dim, 2)
    out = design.cpu().numpy() * (mm[:, 1] - mm[:, 0]) + mm[:, 0]
    if filename:
        save_matrix(filename, out)
    return out
