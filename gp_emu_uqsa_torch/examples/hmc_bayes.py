"""BASELINE config 4: HMC over the GP's hyperparameters, 64 chains.

Port of examples/hmc-bayes/run_hmc.py:

    python -m gp_emu_uqsa_torch.examples.hmc_bayes [--device cpu]
    torchrun --nproc_per_node=4 -m gp_emu_uqsa_torch.examples.hmc_bayes

In one process all chains run as one batch (each leapfrog step one batched
log density and gradient, `inference.hmc.make_gp_logdensity`). Under
torchrun, or inside any process group, the chains split over the ranks
through `hmc_sample(..., group=)`, whose step-size and metric adaptation
average over every rank's chains (the script's `pmean` over its "chains"
mesh axis). fp64, as the script.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.design_inputs import optLatinHyperCube
from gp_emu_uqsa_torch.examples._common import (
    common_kwargs, parser, seconds_since,
)
from gp_emu_uqsa_torch.inference import MLEConfig, hmc
from gp_emu_uqsa_torch.inference.hmc import (
    HMCConfig, ess, hmc_sample, make_gp_logdensity, split_rhat,
)
from gp_emu_uqsa_torch.parallel import init_multihost
from gp_emu_uqsa_torch.parallel.mesh import mesh_device, make_mesh


def simulator(x):
    return np.sin(5 * x[:, 0]) * np.exp(-x[:, 1]) + x[:, 2] ** 2


def default_z0(n_chains: int, dtype=torch.float64) -> torch.Tensor:
    """The script's starts: log 0.5 + 0.2 N(0, 1), from a CPU
    torch.Generator seeded 0 (the JAX package draws them from key 0)."""
    g = torch.Generator().manual_seed(0)
    return math.log(0.5) + 0.2 * torch.randn((n_chains, 3), generator=g,
                                             dtype=dtype)


def _replayed(logdensity, cfg: HMCConfig, draws: Callable):
    """An HMC step that takes its normals and uniforms from draws(z)."""
    def ld_grad(z):
        return hmc.value_and_grad(logdensity, z)

    def step(z, generator, eps, inv_mass):
        noise, u = draws(z)
        return hmc._hmc_transition(ld_grad, z, noise, u, eps, inv_mass, cfg)
    return step


def main(n=120, n_chains=64, n_warmup=400, n_samples=400, verbose=True, *,
         n_leapfrog=12, x=None, z0=None, generator=None,
         draws: Optional[Callable] = None, dtype=torch.float64, device=None,
         workdir=None):
    """run_hmc.main: (samples (n_chains, n_samples, 3), stats), every
    rank's chains in rank order.

    x: a given (n, 3) design in place of the port's LHC; z0: the (n_chains,
    3) starts (default `default_z0`); generator: the sampler's, on the
    chains' device (default seeded 1). draws: z -> (normals, uniforms) of
    one transition in place of the generator's (the tests feed the JAX
    package's). It writes nothing (workdir is taken for a uniform call).
    """
    dev = resolve_device(device)
    group, me = None, 0
    if dist.is_initialized():
        group = dist.group.WORLD
        me = dist.get_rank()
        dev = mesh_device(make_mesh({"chains": dist.get_world_size()},
                                    device_type=dev.type))
    say = print if verbose and me == 0 else (lambda *_: None)
    if x is None:
        x = optLatinHyperCube(3, n, 80, [[0, 1]] * 3, seed=0, device=dev)
    x = np.asarray(x, dtype=np.float64)
    xt = torch.as_tensor(x, dtype=dtype, device=dev)
    yt = torch.as_tensor(simulator(x), dtype=dtype, device=dev)
    h = basis_matrix(xt, linear_basis(3))
    logdensity = make_gp_logdensity(xt, yt, h, MLEConfig(nugget=1e-6))

    world = 1 if group is None else dist.get_world_size()
    if n_chains % world:
        raise ValueError(f"{n_chains} chains do not split over {world} ranks")
    k = n_chains // world
    z0 = default_z0(n_chains) if z0 is None else torch.tensor(z0)
    z0 = z0.to(device=dev, dtype=dtype)[me * k:(me + 1) * k]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(1)
    cfg = HMCConfig(n_warmup=n_warmup, n_samples=n_samples,
                    n_leapfrog=n_leapfrog)

    t0 = time.perf_counter()
    if draws is None:
        samples, stats = hmc_sample(generator, logdensity, z0, cfg,
                                    group=group)
    else:
        samples, stats = hmc.adaptive_mcmc(
            generator, _replayed(logdensity, cfg, draws), z0, cfg,
            group=group)
    samples = hmc._all_chains(samples, group)
    wall = seconds_since(t0, dev)
    total = n_chains * n_samples
    say(f"{n_chains} chains x {n_samples} samples on {world} "
        f"{dev.type} rank(s) in {wall:.1f}s ({total / wall:.0f} samples/s "
        f"incl warmup)")
    say("accept:", float(stats["accept_rate"]),
        "divergence rate:", float(stats["divergence_rate"]))
    say("R-hat:", split_rhat(samples).cpu().numpy())
    say("ESS:", ess(samples))
    return samples, stats


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    init_multihost(device_type=resolve_device(args.device).type)
    try:
        main(**common_kwargs(args))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
