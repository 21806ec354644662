"""Roofline measurement of the hot ops, and the shared measurement problems.

Port of `gp_emu_uqsa_tpu.utils.roofline`: `measure` times the kernel build,
the Cholesky, the fit, the gemm-tier prediction, K1 alone and the fused
mean on one card against its published roofs; `measure_hmc` and
`measure_nuts` give the samplers' post-warmup draws/s and min-ESS/s on
BASELINE config 4's posterior (`gp_test_posterior`).

Every measurement here runs on a CUDA card (`device=None` is the card) and
reports `torch.cuda.get_device_name`; without a card it raises. The JAX
package's TPU roofs and its `cholesky_blocked_padded` (an XLA:TPU
out-of-memory workaround) are not ported: the Cholesky is
`torch.linalg.cholesky_ex`.

Run: python -m gp_emu_uqsa_torch.utils.roofline
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference.lbfgs import MLEConfig

# Published peaks of the H100 parts (NVIDIA data sheets, dense, at the full
# power limit): FLOP/s in fp32 outside the tensor cores, the fp32-accurate
# roof, and in TF32 on the tensor cores (one pass, about three decimal
# digits: the roof of a product that runs with TF32 on). Matched in order
# on torch.cuda.get_device_name(), the plain "H100" (SXM) last.
PEAK_FLOPS = {
    "H100 PCIe": {"fp32": 51e12, "tf32": 378e12},
    "H100 NVL": {"fp32": 60e12, "tf32": 417.5e12},
    "H100": {"fp32": 67e12, "tf32": 495e12},
}

# HBM bandwidth roofs (bytes/s). An op whose arithmetic intensity sits below
# peak_flops/peak_bw is judged against the BANDWIDTH roof: the n = 16384
# kernel build (2d operations a 4-byte entry) is bound by writing its
# output.
PEAK_BW = {
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
    "H100": 3.35e12,
}


def _match(table: dict, device_str: str):
    s = device_str.lower()
    for k, v in table.items():
        if k.lower() in s:
            return v
    return None


def _peak(device_str: str) -> dict | None:
    """Roof dict for a device name, or None when the card is unknown
    (reporting a made-up roof would make the roofline % meaningless)."""
    return _match(PEAK_FLOPS, device_str)


def _peak_bw(device_str: str) -> float | None:
    return _match(PEAK_BW, device_str)


def _time(fn, sync, reps=10):
    """Per-call seconds with adaptive reps (utils/timing.py): CUDA events
    around the reps on the card."""
    from gp_emu_uqsa_torch.utils.timing import timed

    return timed(fn, sync, start_reps=reps)


def _card(device):
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the roofline measurements time the card: they "
                         "need a CUDA device")
    return dev


def _sync(_out):
    torch.cuda.synchronize()


def measure(n: int = 4096, d: int = 8, m: int = 8192, dtype=torch.float32,
            device=None):
    """Measure the hot ops at size n on the card; returns a dict of
    (seconds, tflops, % of the roofs) per op."""
    from gp_emu_uqsa_torch import gp
    from gp_emu_uqsa_torch.kernels import gaussian_corr_self, make_params
    from gp_emu_uqsa_torch.ops.kernel_matrix import gaussian_corr_self_fused
    from gp_emu_uqsa_torch.ops.serve import serve_mean

    dev = _card(device)
    name = torch.cuda.get_device_name(dev)
    peak = _peak(name)
    peak_bw = _peak_bw(name)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(size=(n, d)), dtype=dtype, device=dev)
    params = make_params(np.full(d, 0.8), nugget=1e-4, dtype=dtype,
                         device=dev)
    spec = linear_basis(d)
    h = basis_matrix(x, spec)
    y = torch.sin(3.0 * x[:, 0]) + x[:, 1]
    xs = torch.as_tensor(rng.uniform(size=(m, d)), dtype=dtype, device=dev)
    hs = basis_matrix(xs, spec)
    a = gaussian_corr_self(x, params)

    results = {}

    def add(op, secs, flops, bytes_accessed=None):
        tf = flops / secs / 1e12
        entry = {"seconds": round(secs, 6), "tflops": round(tf, 3)}
        if peak is not None:
            # fp32 inputs: judge against the fp32-accurate roof, and also
            # record the optimistic TF32 roof for context
            entry["pct_of_fp32_roof"] = round(100 * tf * 1e12 / peak["fp32"], 1)
            entry["pct_of_tf32_roof"] = round(100 * tf * 1e12 / peak["tf32"], 1)
        if bytes_accessed is not None:
            entry["gb_per_s"] = round(bytes_accessed / secs / 1e9, 1)
            if peak_bw is not None:
                entry["pct_of_bw_roof"] = round(
                    100 * bytes_accessed / secs / peak_bw, 1)
        results[op] = entry

    # the build moves the n^2 output and the n d inputs; its arithmetic
    # intensity (2d operations a 4-byte entry) pins it to the BANDWIDTH roof
    item = torch.finfo(dtype).bits // 8
    build_bytes = item * (n * n + 2 * n * d)
    add("kernel_build", _time(lambda: gaussian_corr_self(x, params), _sync),
        2 * n * n * d, build_bytes)
    add("cholesky", _time(lambda: torch.linalg.cholesky_ex(a)[0], _sync),
        n ** 3 / 3)
    state = gp.fit(params, x, y, h)
    add("fit_total", _time(lambda: gp.fit(params, x, y, h), _sync),
        n ** 3 / 3 + 2 * n * n * d)
    pred = gp.predictor(state)
    # dominant predict cost: the (m, n) x (n, n) W product
    add("predict_fast", _time(lambda: gp.predict_fast(pred, x, xs, hs),
                              _sync), 2 * m * n * n)
    if dtype == torch.float32 and d <= 20:
        delta = params.delta
        add("kernel_build_k1", _time(
            lambda: gaussian_corr_self_fused(x, delta, params.nugget), _sync),
            2 * n * n * d, build_bytes)
        # fused mean: K3 with r = 1, 3d + 1 + 2 operations a pair
        add("serve_mean_k3", _time(lambda: serve_mean(pred, x, xs, hs),
                                   _sync), m * n * (3 * d + 3))
    results["device"] = name
    results["n"] = n
    return results


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


def measure_hmc(n_chains: int = 64, n: int = 1024, d: int = 8,
                n_samples: int = 32, n_warmup: int = 32,
                n_leapfrog: int = 8, device=None):
    """HMC post-warmup draws/s and min-ESS/s on the card (BASELINE config 4).

    All chains run in lockstep as one batch. Draws/s counts POST-WARMUP
    draws only: a run with the same warmup and one sampling draw is timed
    too and subtracted, so the rate covers n_samples - 1 draws. Each run
    ends in a synchronize and is timed on the host clock. The port runs
    eagerly: no compile is timed or warmed.
    """
    from gp_emu_uqsa_torch.inference.hmc import (
        HMCConfig, ess, hmc_sample, make_gp_logdensity,
    )

    dev = _card(device)
    x, y, h, mle_cfg = gp_test_posterior(n, d, device=dev)
    ld = make_gp_logdensity(x, y, h, mle_cfg)
    cfg = HMCConfig(n_warmup=n_warmup, n_samples=n_samples,
                    n_leapfrog=n_leapfrog)
    cfg_w = HMCConfig(n_warmup=n_warmup, n_samples=1, n_leapfrog=n_leapfrog)
    z0 = torch.zeros((n_chains, d), dtype=torch.float32, device=dev)

    def run(c, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples, stats = hmc_sample(
            torch.Generator(device=dev).manual_seed(seed), ld, z0, c)
        torch.cuda.synchronize()
        return samples, stats, time.perf_counter() - t0

    samples, stats, secs_full = run(cfg, 1)
    _, _, secs_warm = run(cfg_w, 1)
    secs_sampling = secs_full - secs_warm
    e = ess(samples.cpu().numpy())
    total_post = n_chains * (n_samples - 1)
    out = {
        "device": torch.cuda.get_device_name(dev),
        "n_chains": n_chains,
        "n_train": n,
        "d": d,
        "n_leapfrog": n_leapfrog,
        "seconds_total": round(secs_full, 3),
        "seconds_warmup": round(secs_warm, 3),
        "seconds_sampling": round(secs_sampling, 3),
        "min_ess": round(float(np.min(e)), 1),
        "accept_rate": round(float(stats["accept_rate"]), 3),
    }
    # two single-shot wall clocks: null the rates, with the reason, when
    # the sampling window is not resolved above their jitter
    if secs_sampling < 0.1 * secs_full:
        out["samples_per_s_per_chip"] = None
        out["min_ess_per_s"] = None
        out["measurement_error"] = (
            "sampling window unresolved: secs_full - secs_warm = "
            f"{secs_sampling:.4f}s < 10% of secs_full ({secs_full:.4f}s)")
    else:
        out["samples_per_s_per_chip"] = round(total_post / secs_sampling, 1)
        out["min_ess_per_s"] = round(float(np.min(e)) / secs_sampling, 2)
    return out


def measure_nuts(n_chains: int = 64, n: int = 1024, d: int = 8,
                 n_warmup: int = 32, max_depth: int = 6,
                 warmup_max_depth: int = 4, segment_draws: int = 8,
                 n_segments: int = 8, device=None):
    """NUTS post-warmup draws/s and min-ESS/s on the same posterior as
    measure_hmc, on the card.

    One warmup run (depth-capped at warmup_max_depth), then `n_segments`
    sampling-only `nuts_continue` segments of `segment_draws` draws each;
    the timing covers the segments only (host clock, ending in a
    synchronize).
    """
    from gp_emu_uqsa_torch.inference.hmc import (
        HMCConfig, ess, make_gp_logdensity, split_rhat,
    )
    from gp_emu_uqsa_torch.inference.nuts import nuts_continue, nuts_sample

    dev = _card(device)
    x, y, h, mle_cfg = gp_test_posterior(n, d, device=dev)
    ld = make_gp_logdensity(x, y, h, mle_cfg)
    cfg = HMCConfig(n_warmup=n_warmup, n_samples=1)
    z0 = torch.zeros((n_chains, d), dtype=torch.float32, device=dev)
    samples, stats = nuts_sample(torch.Generator(device=dev).manual_seed(0),
                                 ld, z0, cfg, max_depth=warmup_max_depth)
    z = samples[:, -1]
    eps, im = stats["step_size"], stats["inv_mass"]
    gen = torch.Generator(device=dev).manual_seed(2)
    chunks = []
    accepts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_segments):
        zs, seg_stats, gen = nuts_continue(gen, ld, z, eps, im, segment_draws,
                                           max_depth=max_depth)
        z = zs[:, -1]
        chunks.append(zs)
        accepts.append(seg_stats["accept_rate"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    draws = torch.cat(chunks, dim=1).cpu()
    e = ess(draws.numpy())
    total = n_chains * segment_draws * n_segments
    return {
        "device": torch.cuda.get_device_name(dev),
        "sampler": "nuts",
        "n_chains": n_chains,
        "n_train": n,
        "d": d,
        "max_depth": max_depth,
        "n_draws_per_chain": segment_draws * n_segments,
        "n_segments": n_segments,
        "seconds_sampling": round(secs, 3),
        "samples_per_s_per_chip": round(total / secs, 1),
        "min_ess": round(float(np.min(e)), 1),
        "min_ess_per_s": round(float(np.min(e)) / secs, 2),
        "rhat_max": round(float(split_rhat(draws).max()), 4),
        "accept_rate": round(float(np.mean([float(a) for a in accepts])), 3),
    }


if __name__ == "__main__":
    import json

    print(json.dumps(measure(), indent=1))
