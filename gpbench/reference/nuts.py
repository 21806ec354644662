"""One multinomial NUTS transition, written plainly, for the replay check.

The transition of Hoffman and Gelman's No-U-Turn Sampler in its iterative
form with multinomial sampling (Betancourt 2017; NumPyro's scheme), over a
batch of chains that advance in lockstep. Its randomness comes in whole:

  r0       (chains, dim) standard normals, the momenta before the metric
  go_right (chains, depth) the direction of each doubling
  u_sub    (chains, depth) the uniforms that merge a subtree
  u_leaf   (chains, depth, 2^(depth-1)) one uniform a leaf

so that, fed the draws a run of the program used, it gives the proposal
that the program's transition should have given. The log density and its
gradient come from `logdensity_grad(z) -> (values, gradients)`.
"""
from __future__ import annotations

import math

import torch

DIVERGENCE = 1000.0


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _trailing_ones(n: int) -> int:
    count = 0
    while n & 1:
        count += 1
        n >>= 1
    return count


def _sel(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)),
                       new, old)


def _dot(a, b):
    return (a * b).sum(-1)


def transition(logdensity_grad, z0, r0, go_right, u_sub, u_leaf, eps,
               inv_mass, max_depth: int):
    """The proposal (chains, dim) of one transition from z0."""
    chains = z0.shape[0]
    dt, dev = z0.dtype, z0.device
    r0 = r0 / torch.sqrt(inv_mass)
    ld0, g0 = logdensity_grad(z0)
    h0 = 0.5 * _dot(inv_mass * r0, r0) - ld0
    zero = torch.zeros(chains, dtype=dt, device=dev)
    no = torch.zeros(chains, dtype=torch.bool, device=dev)
    left = [z0, r0, g0]
    right = [z0, r0, g0]
    proposal, logw = z0, zero
    stopped = no
    for depth in range(max_depth):
        active = ~stopped
        fwd = go_right[:, depth]
        sign = torch.where(fwd, 1.0, -1.0).to(dt)[:, None]
        step = sign * eps
        z, r, g = (_sel(fwd, a, b) for a, b in zip(right, left))
        sub_prop = z
        sub_logw = torch.full((chains,), -math.inf, dtype=dt, device=dev)
        turned, div = no, no
        z_ck = [torch.zeros_like(z0) for _ in range(max_depth)]
        r_ck = [torch.zeros_like(z0) for _ in range(max_depth)]
        ran = False
        for leaf in range(1 << depth):
            live = active & ~turned & ~div
            if not bool(live.any()):
                break
            ran = True
            r1 = r + 0.5 * step * g
            z1 = z + step * (inv_mass * r1)
            ld1, g1 = logdensity_grad(z1)
            r1 = r1 + 0.5 * step * g1
            dh = 0.5 * _dot(inv_mass * r1, r1) - ld1 - h0
            dh = torch.where(torch.isfinite(dh), dh, torch.full_like(dh, math.inf))
            w_new = torch.logaddexp(sub_logw, -dh)
            take = u_leaf[:, depth, leaf] < torch.exp(-dh - w_new)
            slot = _popcount(leaf >> 1)
            if leaf % 2 == 0:
                z_ck[slot] = _sel(live, z1, z_ck[slot])
                r_ck[slot] = _sel(live, r1, r_ck[slot])
                turn = no
            else:
                first = slot - _trailing_ones(leaf) + 1
                za = torch.stack(z_ck[first:slot + 1])
                ra = torch.stack(r_ck[first:slot + 1])
                dz = (z1 - za) * sign
                turn = ((_dot(dz, inv_mass * ra) < 0)
                        | (_dot(dz, inv_mass * r1) < 0)).any(0)
            sub_prop = _sel(live & take, z1, sub_prop)
            z, r, g = _sel(live, z1, z), _sel(live, r1, r), _sel(live, g1, g)
            sub_logw = torch.where(live, w_new, sub_logw)
            turned = torch.where(live, turn, turned)
            div = torch.where(live, dh > DIVERGENCE, div)
        if not ran:
            break
        ok = ~(turned | div)
        take_sub = u_sub[:, depth] < torch.exp(torch.minimum(sub_logw - logw,
                                                             zero))
        grow = active & ok
        proposal = _sel(grow & take_sub, sub_prop, proposal)
        logw = torch.where(grow, torch.logaddexp(logw, sub_logw), logw)
        new_left = [_sel(fwd, a, b) for a, b in zip(left, (z, r, g))]
        new_right = [_sel(fwd, b, a) for a, b in zip(right, (z, r, g))]
        dz = new_right[0] - new_left[0]
        u_turn = ((_dot(dz, inv_mass * new_left[1]) < 0)
                  | (_dot(dz, inv_mass * new_right[1]) < 0))
        left = [_sel(grow, a, b) for a, b in zip(new_left, left)]
        right = [_sel(grow, a, b) for a, b in zip(new_right, right)]
        stopped = torch.where(active, ~ok | u_turn, stopped)
    return proposal
