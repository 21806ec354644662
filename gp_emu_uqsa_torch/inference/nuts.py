"""Iterative multinomial NUTS over GP hyperparameters.

Port of `gp_emu_uqsa_tpu.inference.nuts`: a batched transition kernel for
the shared `adaptive_mcmc` driver (hmc.py), so NUTS chains get the same
cross-chain dual-averaging + mass-matrix warmup as HMC.

Algorithm: dynamic trajectory doubling with multinomial (progressive)
sampling and fine-grained U-turn detection, in the ITERATIVE formulation
(Phan et al., the NumPyro scheme): a trajectory of up to 2^max_depth - 1
leapfrog steps is built as a sequence of doublings; within each doubling
subtree the recursive algorithm's per-power-of-two-block U-turn checks are
reproduced with an O(max_depth) checkpoint buffer:

  leaf index i (0-based within the subtree):
    i even -> store (z, r) at checkpoint slot popcount(i >> 1)
    i odd  -> check U-turn between the current leaf and every checkpoint in
              [idx_max - trailing_ones(i) + 1, idx_max], idx_max =
              popcount(i >> 1) -- exactly the aligned blocks the recursion
              would close at leaf i.

Chains advance in lockstep, as under the JAX package's `vmap` of
`while_loop`: the depth and the leaf index are the same for every chain
still running, so they, the checkpoint slots and the U-turn ranges are
Python ints computed on the host. Only masks differ by chain (`turned`,
`div`, `stopped`, `go_right`); a chain that has stopped is evaluated with
the others and its state is left as it was. The one host sync is one
`any(active)` a leaf, which ends the subtree loop (and the trajectory when
no chain is left).

Randomness: all of a transition's draws come up front from the generator
(`_nuts_draws`): the momenta's normals r0 (chains, dim), the direction
bits and subtree uniforms (chains, max_depth), and the leaf uniforms
(chains, max_depth, 2^(max_depth-1)); leaf i of the subtree at depth k
uses entry [k, i], as the JAX package's key splits give each leaf its own
key. `_nuts_transition` is deterministic given them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gp_emu_uqsa_torch.inference.hmc import (
    HMCConfig, adaptive_mcmc, mcmc_continue, value_and_grad,
)
from gp_emu_uqsa_torch.ops.precision import fp32_exact


def _trailing_ones(n: int) -> int:
    m = n + 1
    return _popcount((m & -m) - 1)


def _popcount(n: int) -> int:
    return bin(n).count("1")


class NutsDraws(NamedTuple):
    """One NUTS transition's randomness for every chain."""

    r0: torch.Tensor        # (chains, dim) standard normals (momenta)
    go_right: torch.Tensor  # (chains, max_depth) bool, direction of doubling k
    u_sub: torch.Tensor     # (chains, max_depth) subtree-merge uniforms
    u_leaf: torch.Tensor    # (chains, max_depth, 2^(max_depth-1)) leaf uniforms


def _nuts_draws(generator: torch.Generator, z: torch.Tensor,
                max_depth: int) -> NutsDraws:
    """Draw a whole transition's randomness from `generator` on z's device."""
    chains = z.shape[0]
    kw = dict(generator=generator, dtype=z.dtype, device=z.device)
    r0 = torch.randn(z.shape, **kw)
    u = torch.rand((chains, max_depth, 2 + (1 << (max_depth - 1))), **kw)
    return NutsDraws(r0, u[:, :, 0] < 0.5, u[:, :, 1], u[:, :, 2:])


def _where(mask, new, old):
    """Per-chain select: mask (chains,) against (chains, ...) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)),
                       new, old)


def _dot(a, b):
    return torch.sum(a * b, -1)


def new_counts() -> dict:
    """Counters of a NUTS step function (`make_nuts_step`): transitions,
    leaves evaluated (batched leapfrog steps), host syncs, chain-leaves
    evaluated (leaves x chains, every chain evaluated as under vmap) and
    the useful ones (of chains still building their subtree), the
    batched log-density evaluations (leaves and the start of each
    transition) and the tree depths summed over chains (the doublings each
    chain took part in). The two per-chain sums are tensors on the chains'
    device, so counting syncs nothing."""
    return {"transitions": 0, "leaves": 0, "host_syncs": 0,
            "chain_leaves": 0, "useful_chain_leaves": 0, "evaluations": 0,
            "tree_depths": 0}


@fp32_exact
def _nuts_transition(ld_grad, z0, draws: NutsDraws, eps, inv_mass,
                     max_depth: int, divergence_threshold: float,
                     counts: dict | None = None):
    """The deterministic part of one batched NUTS transition.

    Returns (z_prop, accept_stat (chains,), diverged (chains,)), where
    accept_stat is the Stan-style mean Metropolis statistic over all
    visited leaves. `counts` (see `new_counts`) is updated in place.
    """
    counts = new_counts() if counts is None else counts
    chains = z0.shape[0]
    dtype, dev = z0.dtype, z0.device
    r0 = draws.r0 / torch.sqrt(inv_mass)
    ld0, g0 = ld_grad(z0)
    counts["transitions"] += 1
    counts["evaluations"] += 1
    h0 = 0.5 * _dot(inv_mass * r0, r0) - ld0
    zeros = torch.zeros(chains, dtype=dtype, device=dev)
    false = torch.zeros(chains, dtype=torch.bool, device=dev)

    # trajectory state: the two ends, the proposal and its weight
    z_m, r_m, g_m = z0, r0, g0
    z_p, r_p, g_p = z0, r0, g0
    z_prop = z0
    logw = zeros                       # w relative to exp(-h0)
    stopped, diverged = false, false
    sum_acc, n_leaves = zeros, zeros
    for depth in range(max_depth):
        active = ~stopped
        go_right = draws.go_right[:, depth]
        direction = torch.where(go_right, 1.0, -1.0).to(dtype)[:, None]
        e = direction * eps
        z = _where(go_right, z_p, z_m)
        r = _where(go_right, r_p, r_m)
        g = _where(go_right, g_p, g_m)

        # --- build the subtree of 2^depth leaves ----------------------------
        t_prop = z
        t_logw = torch.full((chains,), -math.inf, dtype=dtype, device=dev)
        turned, div = false, false
        t_acc, t_leaves = zeros, zeros
        z_ck = [torch.zeros_like(z0) for _ in range(max_depth)]
        r_ck = [torch.zeros_like(z0) for _ in range(max_depth)]
        ran = 0
        for leaf in range(1 << depth):
            act = active & ~turned & ~div
            counts["host_syncs"] += 1
            if not bool(act.any()):
                break
            ran += 1
            counts["leaves"] += 1
            counts["evaluations"] += 1
            counts["chain_leaves"] += chains
            counts["useful_chain_leaves"] += act.sum()    # on the device
            r1 = r + 0.5 * e * g
            z1 = z + e * (inv_mass * r1)
            ld1, g1 = ld_grad(z1)
            r1 = r1 + 0.5 * e * g1
            dh = 0.5 * _dot(inv_mass * r1, r1) - ld1 - h0
            dh = torch.where(torch.isfinite(dh), dh,
                             torch.full_like(dh, math.inf))
            div_leaf = dh > divergence_threshold
            logw_leaf = -dh
            logw_new = torch.logaddexp(t_logw, logw_leaf)
            # u < NaN is False: two empty weights never take the leaf
            take = draws.u_leaf[:, depth, leaf] < torch.exp(logw_leaf
                                                            - logw_new)
            # --- checkpoint store / U-turn checks --------------------------
            idx_max = _popcount(leaf >> 1)
            if leaf % 2 == 0:
                z_ck[idx_max] = _where(act, z1, z_ck[idx_max])
                r_ck[idx_max] = _where(act, r1, r_ck[idx_max])
                turned_leaf = false
            else:
                idx_min = idx_max - (_trailing_ones(leaf) - 1)
                za = torch.stack(z_ck[idx_min:idx_max + 1])
                ra = torch.stack(r_ck[idx_min:idx_max + 1])
                # ordered by direction: the checkpoint is EARLIER
                dz = (z1 - za) * direction
                turned_leaf = ((_dot(dz, inv_mass * ra) < 0.0)
                               | (_dot(dz, inv_mass * r1) < 0.0)).any(0)
            acc = torch.clamp(torch.exp(-dh), max=1.0)
            t_prop = _where(act & take, z1, t_prop)
            z, r, g = _where(act, z1, z), _where(act, r1, r), _where(act, g1, g)
            t_logw = torch.where(act, logw_new, t_logw)
            turned = torch.where(act, turned_leaf, turned)
            div = torch.where(act, div_leaf, div)
            t_acc = t_acc + torch.where(act, acc, zeros)
            t_leaves = t_leaves + act.to(dtype)
        if ran == 0:
            break               # no chain left at leaf 0: all have stopped
        counts["tree_depths"] += active.sum()             # on the device
        sub_ok = ~(turned | div)

        # --- merge the subtree into the trajectory --------------------------
        # biased progressive sampling
        take_sub = draws.u_sub[:, depth] < torch.exp(
            torch.minimum(t_logw - logw, zeros))
        ext = active & sub_ok
        z_prop = _where(ext & take_sub, t_prop, z_prop)
        logw = torch.where(ext, torch.logaddexp(logw, t_logw), logw)
        nz_m = _where(go_right, z_m, z)
        nr_m = _where(go_right, r_m, r)
        ng_m = _where(go_right, g_m, g)
        nz_p = _where(go_right, z, z_p)
        nr_p = _where(go_right, r, r_p)
        ng_p = _where(go_right, g, g_p)
        dz = nz_p - nz_m
        traj_turn = ((_dot(dz, inv_mass * nr_m) < 0.0)
                     | (_dot(dz, inv_mass * nr_p) < 0.0))
        z_m, r_m, g_m = _where(ext, nz_m, z_m), _where(ext, nr_m, r_m), \
            _where(ext, ng_m, g_m)
        z_p, r_p, g_p = _where(ext, nz_p, z_p), _where(ext, nr_p, r_p), \
            _where(ext, ng_p, g_p)
        stopped = torch.where(active, ~sub_ok | traj_turn, stopped)
        diverged = torch.where(active, diverged | div, diverged)
        sum_acc = sum_acc + torch.where(active, t_acc, zeros)
        n_leaves = n_leaves + torch.where(active, t_leaves, zeros)
    accept_stat = sum_acc / torch.clamp(n_leaves, min=1.0)
    return z_prop, accept_stat, diverged


def make_nuts_step(logdensity, max_depth: int = 8,
                   divergence_threshold: float = 1000.0):
    """Batched NUTS transition kernel: (z, generator, eps, inv_mass) -> ...

    Returns a function with the adaptive_mcmc step contract; accept_stat is
    the Stan-style mean Metropolis statistic over all visited leaves. The
    function's `counts` dict (`new_counts`) accumulates over its calls.
    """
    counts = new_counts()

    def ld_grad(z):
        return value_and_grad(logdensity, z)

    def step(z, generator, eps, inv_mass):
        draws = _nuts_draws(generator, z, max_depth)
        return _nuts_transition(ld_grad, z, draws, eps, inv_mass, max_depth,
                                divergence_threshold, counts)

    step.counts = counts
    return step


def nuts_sample(generator: torch.Generator, logdensity, z0,
                cfg: HMCConfig = HMCConfig(), *, max_depth: int = 8,
                group=None):
    """NUTS with the shared cross-chain adaptive warmup (see hmc.py).

    cfg.n_leapfrog is ignored (trajectory length is dynamic, capped at
    2^max_depth - 1 leapfrog steps). The stats carry the step function's
    `counts` (this rank's). `group`: chains over ranks (hmc.py).
    """
    step = make_nuts_step(logdensity, max_depth=max_depth,
                          divergence_threshold=cfg.divergence_threshold)
    samples, stats = adaptive_mcmc(generator, step, torch.as_tensor(z0), cfg,
                                   group=group)
    stats["counts"] = step.counts
    return samples, stats


def nuts_continue(generator: torch.Generator, logdensity, z, eps, inv_mass,
                  n_samples: int, *, max_depth: int = 8,
                  divergence_threshold: float = 1000.0, group=None):
    """NUTS sampling-only continuation with a frozen adapted metric.

    Exact-resume counterpart to nuts_sample (see hmc.mcmc_continue):
    chaining k calls of this makes one long chain.
    Returns (samples, stats, generator); the stats carry the `counts`.
    """
    step = make_nuts_step(logdensity, max_depth=max_depth,
                          divergence_threshold=divergence_threshold)
    samples, stats, generator = mcmc_continue(
        generator, step, torch.as_tensor(z), eps, inv_mass, n_samples,
        group=group)
    stats["counts"] = step.counts
    return samples, stats, generator
