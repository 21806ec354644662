"""HMC over GP hyperparameters, all chains on one batch axis.

Port of `gp_emu_uqsa_tpu.inference.hmc`. Every chain sits on the leading
axis of one tensor: a leapfrog step evaluates the batched log density of
all chains at once (for the GP posterior: one K1 build a chain on the card,
one batched Cholesky and the analytic adjoint of `gp._NllMucm`). Where the
JAX package runs one `lax.scan` over the steps, the port runs a Python loop
of tensor operations that stay on the chains' device.

Randomness comes from an explicit `torch.Generator` on the chains' device.
Each transition splits into a draw (`_hmc_draws`: the momenta's normals and
the accept uniforms, drawn from the generator in one call) and a
deterministic transition (`_hmc_transition`) that acts on them, so the same
transition can be fed the JAX package's own draws.

Warmup schedule (`adaptive_mcmc`, Stan-like, as in the JAX package):
  stage 1 [0, w/4):       step-size search, identity mass
  stage 2 [w/4, 3w/4):    step-size search + Welford variance accumulation
  boundary at 3w/4:       set inv-mass from pooled variance, reset dual
                          averaging around the current step size
  stage 3 [3w/4, w):      re-adapt step size under the new metric
The step index is a Python int, so the stage boundaries are plain `if`s;
the per-step statistics (mean accept, dual averaging, Welford) stay on the
device and the loop reads nothing back to the host.

Divergences are energy errors > `divergence_threshold`; diverging
proposals are rejected, never propagated.

The target is `logdensity(z)`, batched: z (chains, dim) -> (chains,),
differentiable with autograd (`make_gp_logdensity` for the GP marginal
posterior).

Chains over several ranks (the JAX package's `axis_name`): `group` is a
process group, or a (DeviceMesh, axis name) pair, and None means one
device. Each rank runs its own chains; the statistics that the JAX code
reduces with `lax.pmean` (the mean accept of dual averaging, the Welford
variance of the metric switch, the reported accept and divergence rates)
are means over the chains of every rank (`_pmean`: the chains' values
all-gathered, then one mean), so every rank adapts the same step size
and metric as one process running all the chains would. Each rank draws
from its own generator, derived from a draw of the caller's generator and
the rank (`rank_generator`, the counterpart of `fold_in(key,
axis_index)`): the same generator on every rank gives decorrelated
chains.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.inference.lbfgs import MLEConfig, _unpack
from gp_emu_uqsa_torch.ops.precision import fp32_exact
from gp_emu_uqsa_torch.parallel.mesh import all_gather, group_of, group_rank


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    n_warmup: int = 500
    n_samples: int = 500
    n_leapfrog: int = 16
    init_step_size: float = 0.1
    target_accept: float = 0.8
    divergence_threshold: float = 1000.0
    da_t0: float = 10.0          # dual-averaging offset
    da_gamma: float = 0.05
    da_kappa: float = 0.75
    thin: int = 1


def _all_chains(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """x with its chain axis `dim` extended to every rank's chains, in rank
    order (x itself without a group)."""
    if group is None:
        return x
    parts = all_gather(x, group)                     # (ranks, ...)
    return torch.cat(list(parts), dim)


def _pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the chains (axis 0) of every rank of the group. The ranks'
    chains are gathered and averaged as one batch, so the adaptation is
    the one-process run's to the last bit: a mean of the ranks' means
    rounds differently, and dual averaging and the trajectories amplify
    that (to about 1e-8 after 70 transitions)."""
    return torch.mean(_all_chains(x, group), 0)


def rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator for `rank` on generator's device, seeded by
    np.random.SeedSequence([two integers drawn from generator, rank]).

    The caller's generator advances by that one draw, the same on every
    rank that holds the same generator; so each rank gets its own stream,
    the same streams on every run, and a second call with the advanced
    generator gives new ones (as a split key would)."""
    words = torch.randint(0, 2 ** 62, (2,), generator=generator,
                          device=generator.device).tolist()
    seed = np.random.SeedSequence([*words, rank]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=generator.device).manual_seed(int(seed))


def _rank_streams(generator, group):
    """(the process group, this rank's generator)."""
    group = group_of(group)
    if group is None:
        return None, generator
    return group, rank_generator(generator, group_rank(group))


def value_and_grad(logdensity: Callable, z: torch.Tensor):
    """(log densities (chains,), gradients (chains, dim)) at z, detached.

    Unlike `lbfgs.value_and_grad`, a row keeps its gradient whatever its
    value: the samplers reject on a NaN gradient.
    """
    with torch.enable_grad():
        z = z.detach().requires_grad_(True)
        v = logdensity(z)
        (g,) = torch.autograd.grad(v.sum(), z)
    return v.detach(), g


def _leapfrog(ld_grad, z, p, ld, g, inv_mass, eps, n_steps):
    """Batched leapfrog; z, p, g are (chains, dim), ld (chains,).

    Starts from the log density and gradient at z and returns them at the
    end point: (z, p, ld, g). The gradient at the end of one step is the
    one the next step starts from, so a trajectory of L steps costs L
    evaluations (the JAX package recomputes it, 2L; the values are the
    same).
    """
    for _ in range(n_steps):
        p = p + 0.5 * eps * g
        z = z + eps * (inv_mass * p)
        ld, g = ld_grad(z)
        p = p + 0.5 * eps * g
    return z, p, ld, g


def _hmc_draws(generator: torch.Generator, z: torch.Tensor):
    """One HMC transition's randomness: standard normals for the momenta
    (chains, dim) and the accept uniforms (chains,), from `generator` on
    z's device."""
    noise = torch.randn(z.shape, generator=generator, dtype=z.dtype,
                        device=z.device)
    u = torch.rand(z.shape[:1], generator=generator, dtype=z.dtype,
                   device=z.device)
    return noise, u


@fp32_exact
def _hmc_transition(ld_grad, z, noise, u, eps, inv_mass, cfg: HMCConfig):
    """The deterministic part of one fixed-trajectory HMC transition.

    noise: standard normals (chains, dim), p = noise / sqrt(inv_mass);
    u: accept uniforms (chains,). Returns (z_new, accept_prob (chains,),
    diverged (chains,)). A trajectory that reaches a non-finite energy (a
    NaN gradient where the GP factor failed) has accept_prob 0 and is
    rejected, as in the JAX package.
    """
    p = noise / torch.sqrt(inv_mass)
    ld0, g0 = ld_grad(z)
    ke0 = 0.5 * torch.sum(inv_mass * p * p, -1)
    z_new, p_new, ld1, _ = _leapfrog(ld_grad, z, p, ld0, g0, inv_mass, eps,
                                     cfg.n_leapfrog)
    ke1 = 0.5 * torch.sum(inv_mass * p_new * p_new, -1)
    # -dH = (ld1 - ke1) - (ld0 - ke0); accept with prob min(1, exp(-dH))
    energy_err = (ld1 - ke1) - (ld0 - ke0)
    # NaN-safe: treat non-finite proposals as -inf density
    energy_err = torch.where(torch.isfinite(energy_err), energy_err,
                             torch.full_like(energy_err, -math.inf))
    accept_prob = torch.clamp(torch.exp(energy_err), max=1.0)
    diverged = energy_err < -cfg.divergence_threshold
    take = (u < accept_prob) & ~diverged
    return torch.where(take[:, None], z_new, z), accept_prob, diverged


def make_hmc_step(logdensity: Callable, cfg: HMCConfig):
    """Batched fixed-trajectory HMC transition kernel.

    Returns step(z (chains, dim), generator, eps, inv_mass) ->
    (z_new, accept_prob (chains,), diverged (chains,)), the step_fn shape
    `adaptive_mcmc` / `mcmc_continue` drive.
    """
    def ld_grad(z):
        return value_and_grad(logdensity, z)

    def hmc_step(z, generator, eps, inv_mass):
        noise, u = _hmc_draws(generator, z)
        return _hmc_transition(ld_grad, z, noise, u, eps, inv_mass, cfg)

    return hmc_step


def hmc_sample(generator: torch.Generator, logdensity: Callable, z0,
               cfg: HMCConfig = HMCConfig(), *, group=None):
    """Run warmup + sampling for all chains.

    Args:
      generator: torch.Generator on the chains' device (the same on every
        rank of `group`; `adaptive_mcmc` derives each rank's own).
      logdensity: batched log density, z (chains, dim) -> (chains,).
      z0: (chains, dim) initial positions (this rank's chains).
      group: the ranks that share the adaptation (module docstring).

    Returns (samples (chains, n_kept, dim), stats dict).
    """
    return adaptive_mcmc(generator, make_hmc_step(logdensity, cfg),
                         torch.as_tensor(z0), cfg, group=group)


def _rates(accepts, diverged, dtype, group):
    """The accept and divergence rates: means over the draws and the
    chains of every rank."""
    return (torch.mean(_all_chains(torch.stack(accepts), group, 1)),
            torch.mean(_all_chains(torch.stack(diverged).to(dtype), group,
                                   1)))


def adaptive_mcmc(generator: torch.Generator, step_fn, z0, cfg: HMCConfig,
                  *, group=None):
    """Shared warmup+sampling driver for any batched MCMC transition kernel.

    step_fn(z (chains, dim), generator, eps, inv_mass) -> (z_new,
    accept_stat (chains,), diverged (chains,)); used by both HMC and NUTS.
    The adaptation statistics are means over the chains of every rank of
    `group` (this device's chains when None); with a group, step_fn draws
    from this rank's `rank_generator`.
    """
    group, generator = _rank_streams(generator, group)
    z = torch.as_tensor(z0)
    dtype, dev = z.dtype, z.device
    dim = z.shape[1]

    w = cfg.n_warmup
    s2_end = 3 * w // 4
    s2_start = w // 4
    log_eps = torch.tensor(np.log(cfg.init_step_size), dtype=dtype,
                           device=dev)
    log_eps_bar = log_eps.clone()
    hbar = torch.zeros((), dtype=dtype, device=dev)
    mu = torch.tensor(np.log(10.0 * cfg.init_step_size), dtype=dtype,
                      device=dev)
    welf_n = 0.0
    welf_mean = torch.zeros_like(z)
    welf_m2 = torch.zeros_like(z)
    inv_mass = torch.ones((dim,), dtype=dtype, device=dev)
    warm_accepts = []
    for step_idx in range(w):
        eps = torch.exp(log_eps)
        z, accept_prob, _ = step_fn(z, generator, eps, inv_mass)
        # --- dual averaging over the chains --------------------------------
        mean_accept = _pmean(accept_prob, group)
        t = step_idx + 1.0
        # the DA clock restarts after the metric switch (stage 3)
        t_eff = t - s2_end if step_idx >= s2_end else t
        hbar = (1.0 - 1.0 / (t_eff + cfg.da_t0)) * hbar + (
            cfg.target_accept - mean_accept) / (t_eff + cfg.da_t0)
        log_eps_new = mu - math.sqrt(t_eff) / cfg.da_gamma * hbar
        pow_t = t_eff ** (-cfg.da_kappa)
        log_eps_bar = pow_t * log_eps_new + (1.0 - pow_t) * log_eps_bar
        log_eps = log_eps_new
        # --- Welford accumulation (stage 2 only) ---------------------------
        if s2_start <= step_idx < s2_end:
            welf_n += 1.0
            delta = z - welf_mean
            welf_mean = welf_mean + delta / max(welf_n, 1.0)
            welf_m2 = welf_m2 + delta * (z - welf_mean)
        # --- metric switch at the end of stage 2 ---------------------------
        if step_idx == s2_end - 1:
            var = _pmean(welf_m2, group) / max(welf_n - 1.0, 1.0)
            # Stan-style regularization toward a small unit metric
            inv_mass = ((welf_n / (welf_n + 5.0)) * var
                        + (5.0 / (welf_n + 5.0)) * 1e-3)
            mu = math.log(10.0) + log_eps_bar   # re-center DA on current eps
            log_eps = log_eps_bar
            hbar = torch.zeros_like(hbar)
        warm_accepts.append(mean_accept)
    eps_final = torch.exp(log_eps_bar)

    zs, accepts, diverged = [], [], []
    for _ in range(cfg.n_samples):
        z, accept_prob, div = step_fn(z, generator, eps_final, inv_mass)
        zs.append(z)
        accepts.append(accept_prob)
        diverged.append(div)
    # (chains, n_samples, dim), thinned
    samples = torch.stack(zs, 1)[:, ::cfg.thin]
    accept_rate, divergence_rate = _rates(accepts, diverged, dtype, group)
    stats = {
        "step_size": eps_final,
        "inv_mass": inv_mass,
        "accept_rate": accept_rate,
        "divergence_rate": divergence_rate,
        "warmup_accept_trace": (torch.stack(warm_accepts) if warm_accepts
                                else torch.zeros(0, dtype=dtype, device=dev)),
    }
    return samples, stats


def mcmc_continue(generator: torch.Generator, step_fn, z, eps, inv_mass,
                  n_samples: int, *, thin: int = 1, group=None):
    """Sampling-only continuation with a FROZEN adapted metric.

    The exact-resume counterpart to `adaptive_mcmc` (which always re-runs
    warmup): given a checkpointed (z, step_size, inv_mass, generator state)
    (`utils.checkpoint.load_hmc_state`), this draws `n_samples` more
    post-warmup samples from the same stationary kernel, no re-adaptation.
    Chaining k of these calls, each from the previous one's last position
    and generator, makes one long chain; re-running a segment from its
    checkpoint (the same chains, the generator state restored) gives the
    same draws bit for bit.

    Returns (samples (chains, n_samples/thin, dim), stats, generator): the
    generator, advanced past the segment, is what the next segment takes.
    With a `group`, the draws come from this rank's `rank_generator` and
    that is the generator returned; the rates are means over every rank.
    """
    group, generator = _rank_streams(generator, group)
    z = torch.as_tensor(z)
    zs, accepts, diverged = [], [], []
    for _ in range(n_samples):
        z, accept_prob, div = step_fn(z, generator, eps, inv_mass)
        zs.append(z)
        accepts.append(accept_prob)
        diverged.append(div)
    samples = torch.stack(zs, 1)[:, ::thin]
    accept_rate, divergence_rate = _rates(accepts, diverged, z.dtype, group)
    stats = {
        "step_size": eps,
        "inv_mass": inv_mass,
        "accept_rate": accept_rate,
        "divergence_rate": divergence_rate,
    }
    return samples, stats, generator


def hmc_continue(generator: torch.Generator, logdensity, z, eps, inv_mass,
                 n_samples: int, cfg: HMCConfig = HMCConfig(), *,
                 group=None):
    """HMC sampling-only continuation (see mcmc_continue)."""
    return mcmc_continue(generator, make_hmc_step(logdensity, cfg),
                         torch.as_tensor(z), eps, inv_mass, n_samples,
                         thin=cfg.thin, group=group)


def split_rhat(samples) -> torch.Tensor:
    """Split-R-hat per dimension; samples (chains, n, dim)."""
    samples = torch.as_tensor(samples)
    c, n, d = samples.shape
    half = n // 2
    split = samples[:, : 2 * half].reshape(2 * c, half, d)
    chain_means = torch.mean(split, 1)                    # (2c, d)
    chain_vars = torch.var(split, 1, correction=1)        # (2c, d)
    w_var = torch.mean(chain_vars, 0)
    b_var = half * torch.var(chain_means, 0, correction=1)
    var_post = (half - 1) / half * w_var + b_var / half
    return torch.sqrt(var_post / w_var)


def ess(samples) -> np.ndarray:
    """Bulk effective sample size per dimension (Geyer initial positive seq).

    samples (chains, n, dim). Host-side diagnostic (NumPy, FFT
    autocorrelation), as in the JAX package: it runs once per chain batch,
    not in the hot path.
    """
    if torch.is_tensor(samples):
        samples = samples.detach().cpu().numpy()
    s = np.asarray(samples)
    c, n, d = s.shape
    x = s - s.mean(axis=1, keepdims=True)
    var = np.mean(s.var(axis=1, ddof=1), axis=0)             # (d,)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real / n
    rho = np.mean(acov, axis=0) / np.maximum(var, 1e-300)    # (n, d)
    out = np.empty(d)
    for k in range(d):
        pair = rho[1:-1:2, k] + rho[2::2, k]                 # (r1+r2), (r3+r4)..
        tau = 1.0
        for p in pair:
            if p <= 0:
                break
            tau += 2.0 * p
        out[k] = c * n / max(tau, 1.0)
    return out


class _RejectFailed(torch.autograd.Function):
    """-NLL where it is finite, else -1e12, with a NaN gradient row there.

    The JAX package replaces a non-finite NLL by 1e12 with `jnp.where`; its
    gradient on those rows is NaN, because the likelihood's custom VJP runs
    on the NaN factor. A NaN gradient is what makes a sampler reject a
    trajectory that touches a failed factor (HMC through a non-finite
    energy, NUTS through a divergence). `gp._NllMucm` gives such rows a
    zero gradient instead, which suits L-BFGS, so this Function restores
    the NaN: its z input gets a NaN cotangent on every failed row.
    """

    @staticmethod
    def forward(ctx, nll, z):
        ok = torch.isfinite(nll)
        ctx.save_for_backward(ok)
        ctx.z_shape = z.shape
        return torch.where(ok, -nll, torch.full_like(nll, -1e12))

    @staticmethod
    def backward(ctx, ct):
        (ok,) = ctx.saved_tensors
        zero = torch.zeros((), dtype=ct.dtype, device=ct.device)
        g_z = torch.where(ok[..., None], zero,
                          torch.full((), math.nan, dtype=ct.dtype,
                                     device=ct.device))
        return torch.where(ok, -ct, zero), g_z.expand(ctx.z_shape)


def make_gp_logdensity(x, y, h, cfg: MLEConfig, prior_scale: float = 3.0,
                       prior_mean: float = 0.0):
    """Log posterior density over the flat log-parameter vector z.

    density = -NLL(params(z)) + N(prior_mean, prior_scale^2) log-prior on z
    (weakly-informative log-normal priors on delta/sigma/nugget).

    Batched over chains: z (chains, p) -> (chains,), through `gp.nll`
    (for mucm the batched `_NllMucm`: K1 once a chain on the card).
    ladder=False: one plain Cholesky, as in the JAX package. Where the NLL
    is not finite the density is -1e12 and its gradient row NaN
    (`_RejectFailed`).
    """
    d = x.shape[1]

    def logdensity(z):
        params = _unpack(z, cfg, d, x.dtype)
        nll_val = gp.nll(params, x, y, h, mode=cfg.mode, ladder=False,
                         family=cfg.family)
        lp = -0.5 * torch.sum(((z - prior_mean) / prior_scale) ** 2, -1)
        return _RejectFailed.apply(nll_val, z) + lp

    return logdensity


@fp32_exact
def predict_marginalized(z_samples, x, y, h, xs, hs, cfg: MLEConfig,
                         max_draws: int = 64):
    """Posterior-predictive mean/var marginalized over hyperparameter draws.

    Mixture moments over S thinned draws (the JAX package's selection,
    `[::stride][:max_draws]`):
      E[y*] = mean_s m_s,  V[y*] = mean_s v_s + mean_s (m_s - E[y*])^2,
    the JAX package's mean_s (v_s + m_s^2) - E[y*]^2 without its
    cancellation. One `gp.fit` and `gp.predict` a draw (K2 on the card).
    """
    d = x.shape[1]
    flat = torch.as_tensor(z_samples).reshape(-1, z_samples.shape[-1])
    stride = max(1, flat.shape[0] // max_draws)
    flat = flat[::stride][:max_draws].to(device=x.device, dtype=x.dtype)
    means, variances = [], []
    for z in flat:
        params = _unpack(z, cfg, d, x.dtype)
        state = gp.fit(params, x, y, h, mode=cfg.mode, family=cfg.family)
        mean, var = gp.predict(state, x, h, xs, hs, family=cfg.family)
        means.append(mean)
        variances.append(var)
    means = torch.stack(means)
    e_mean = torch.mean(means, 0)
    e_var = (torch.mean(torch.stack(variances), 0)
             + torch.mean((means - e_mean) ** 2, 0))
    return e_mean, torch.clamp(e_var, min=0.0)
