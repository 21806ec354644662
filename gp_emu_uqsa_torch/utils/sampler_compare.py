"""NUTS-vs-HMC measurement harness (port of
`gp_emu_uqsa_tpu.utils.sampler_compare`).

Measures both samplers on the REAL target posterior (a marginalized-GP
hyperparameter log density, `gp_test_posterior`'s data at a small size) on
one CUDA card:

  * sampling seconds for a fixed draw budget (CUDA events, warmup and
    sampling together, as the JAX harness times its whole run)
  * min/median bulk-ESS per second (quality-adjusted throughput: NUTS
    spends more gradient evaluations per draw but decorrelates better)
  * split R-hat (sanity: both must actually converge)

`compile_s` is null: the port runs eagerly and compiles nothing before its
first draw (the CUDA kernels are built once per process, not per
sampler). The JAX harness's sharded variant belongs to the multi-device
path, which is not ported.

Run: python -m gp_emu_uqsa_torch.utils.sampler_compare
"""
from __future__ import annotations

import json

import numpy as np
import torch


def compare(n: int = 128, d: int = 4, n_chains: int = 16,
            n_warmup: int = 300, n_samples: int = 500,
            n_leapfrog: int = 32, max_depth: int = 6, seed: int = 0,
            device=None) -> dict:
    """Measure HMC vs NUTS on a GP-hyperparameter posterior on the card.

    n_leapfrog=32 for HMC vs max_depth=6 (<=63 leapfrogs, dynamic) for
    NUTS keeps the per-draw gradient budgets comparable; ESS/s is the
    decision metric, not raw samples/s. The data: seed-`seed` uniform
    inputs, y = sin(3 x0) + x1 x2, linear basis, fp32 with nugget 1e-4
    (the JAX harness's fp32 setting: at 1e-6 the fp32 factor fails and
    every proposal rejects).
    """
    from gp_emu_uqsa_torch._device import resolve_device
    from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
    from gp_emu_uqsa_torch.inference import MLEConfig
    from gp_emu_uqsa_torch.inference.hmc import (
        HMCConfig, ess, hmc_sample, make_gp_logdensity, split_rhat,
        value_and_grad,
    )
    from gp_emu_uqsa_torch.inference.nuts import nuts_sample

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("compare() times the samplers with CUDA events: "
                         "it needs a CUDA device")
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(size=(n, d)), dtype=torch.float32,
                        device=dev)
    y = torch.sin(3.0 * x[:, 0]) + x[:, 1] * x[:, 2]
    h = basis_matrix(x, linear_basis(d))
    ld = make_gp_logdensity(x, y, h, MLEConfig(mode="mucm", nugget=1e-4))
    cfg = HMCConfig(n_warmup=n_warmup, n_samples=n_samples,
                    n_leapfrog=n_leapfrog)
    z0 = torch.zeros((n_chains, d), dtype=torch.float32, device=dev)
    value_and_grad(ld, z0)     # load the solver libraries before timing

    def bench(sample_fn):
        gen = torch.Generator(device=dev).manual_seed(2)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        samples, stats = sample_fn(gen)
        stop.record()
        stop.synchronize()
        run_s = start.elapsed_time(stop) / 1e3
        e = ess(samples)                 # (dim,) bulk ESS across chains
        return {
            "compile_s": None,
            "run_s": round(run_s, 3),
            "ess_min": round(float(np.min(e)), 1),
            "ess_median": round(float(np.median(e)), 1),
            "ess_min_per_s": round(float(np.min(e)) / run_s, 2),
            "rhat_max": round(float(split_rhat(samples).max()), 4),
            "accept_rate": round(float(stats["accept_rate"]), 3),
        }

    out = {
        "posterior": f"gp-hyper n={n} d={d}",
        "chains": n_chains,
        "draws": n_samples,
        "dtype": "float32",
        "device": torch.cuda.get_device_name(dev),
        "hmc": bench(lambda g: hmc_sample(g, ld, z0, cfg)),
    }
    out["nuts"] = bench(
        lambda g: nuts_sample(g, ld, z0, cfg, max_depth=max_depth))
    return out


if __name__ == "__main__":
    print(json.dumps(compare(), indent=1), flush=True)
