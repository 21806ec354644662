"""BASELINE config 5: a distributed kernel build and blocked Cholesky at
n = 16384, then batched prediction at 1M query points.

Port of examples/large-scale/run_large.py, at its published size:

    python -m gp_emu_uqsa_torch.examples.large_scale [--n 16384] \
        [--m 1000000] [--block 256] [--chunk 65536] [--device cpu]
    torchrun --nproc_per_node=4 -m gp_emu_uqsa_torch.examples.large_scale

In a plain process it runs on one card, on a process group of one rank
(`parallel.process_group`); under torchrun on one card a rank, over NCCL.
On the script's data (seed 0, d = 8, delta 0.8, nugget 1e-4, linear basis):

  1. `fit_large` (recursive) and `predictor_large` on a {"mr": p} mesh:
     A's rows by K2, the distributed Cholesky, W = L^-1 by rows;
  2. `ring_predict` over the m queries in chunks of `chunk` queries a rank,
     one `ring_predict` call a chunk (its t is (chunk, n) on each rank);
  3. the fused tier, the script's TPU branch, on the same queries:
     `serve_mean_batched` (K3) and `serve_meanvar_batched` with
     quad_precision "high" (K3, K4 "high"); with p ranks each serves its
     m / p queries from the whole W, gathered once. It runs on the card
     (on the CPU only when asked: `fused=True`);
  4. the seconds, points/s and bytes sent of each step, and the NLL.

The dtype is the script's: fp32 on the card (its TPU choice), fp64 on the
CPU. `run` returns every result; `main` returns what the script's does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.examples._common import (
    common_kwargs, parser, seconds_since,
)
from gp_emu_uqsa_torch.kernels import make_params
from gp_emu_uqsa_torch.ops.serve import (
    serve_mean_batched, serve_meanvar_batched,
)
from gp_emu_uqsa_torch.parallel import (
    fit_large, make_mesh, predictor_large, process_group, ring_predict,
)
from gp_emu_uqsa_torch.parallel.large_fit import row_block
from gp_emu_uqsa_torch.parallel.mesh import (
    axis_group, gather_group_rows, group_size, mesh_device, padded_rows,
    traffic,
)
from gp_emu_uqsa_torch.parallel.predict import query_shard

DELTA, NUGGET = 0.8, 1e-4
FUSED_BATCH = 131072          # the script's batch=min(m, 131072)


def problem(n: int, m: int, d: int, dtype, device):
    """run_large.py's data: x, y, h and the queries xs, hs (drawn after x
    from the same numpy generator, seed 0)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(size=(n, d)), dtype=dtype, device=device)
    y = torch.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2]
    xs = torch.as_tensor(rng.uniform(size=(m, d)), dtype=dtype, device=device)
    spec = linear_basis(d)
    return x, y, basis_matrix(x, spec), xs, basis_matrix(xs, spec)


@dataclasses.dataclass
class Run:
    """What `run` computed: the fit state, the queries, the ring's and the
    fused tier's (mean, var) on all m queries (fused: None where it did
    not run), seconds and bytes sent by step on this rank, the ranks."""
    state: gp.FitState
    xs: torch.Tensor
    ring: tuple
    fused_mean: Optional[torch.Tensor]
    fused: Optional[tuple]
    seconds: dict
    bytes_sent: dict
    world: int


def _whole_predictor(pred: gp.Predictor, n: int, mesh, block: int):
    """pred with the whole (n, n) W: predictor_large's rows gathered."""
    group = axis_group(mesh, "mr")
    p = group_size(group)
    if p == 1:
        return pred
    b = row_block(n, p, block)
    w = gather_group_rows(pred.linv, group, b, padded_rows(n, p, b))
    return pred._replace(linv=w[:n, :n])


def run(n: int = 16384, m: int = 1_000_000, d: int = 8, block: int = 256,
        *, chunk: int = 65536, fused: Optional[bool] = None, dtype=None,
        device=None, verbose: bool = True) -> Run:
    """The workflow (module docstring); every rank returns the same
    results. chunk: queries a rank in one `ring_predict` call."""
    dev = resolve_device(device)
    with process_group(dev.type):
        mesh = make_mesh({"mr": dist.get_world_size()}, device_type=dev.type)
        data = make_mesh({"data": dist.get_world_size()},
                         device_type=dev.type)
        dev = mesh_device(mesh)
        world = dist.get_world_size()
        say = print if verbose and dist.get_rank() == 0 else (lambda *_: None)
        if dtype is None:
            dtype = torch.float32 if dev.type == "cuda" else torch.float64
        if fused is None:
            fused = dev.type == "cuda"
        x, y, h, xs, hs = problem(n, m, d, dtype, dev)
        params = make_params(np.full(d, DELTA), nugget=NUGGET, dtype=dtype,
                             device=dev)
        seconds, sent = {}, {}

        def step(name, fn):
            traffic.reset()
            t0 = time.perf_counter()
            out = fn()
            seconds[name] = seconds_since(t0, dev)
            sent[name] = traffic.bytes
            return out

        state = step("fit_large", lambda: fit_large(params, x, y, h, mesh,
                                                    block=block))
        pred = step("predictor_large",
                    lambda: predictor_large(state, mesh, block=block))
        per_call = chunk * world

        def ring():
            parts = [ring_predict(pred, x, xs[s:s + per_call],
                                  hs[s:s + per_call], data)
                     for s in range(0, m, per_call)]
            return (torch.cat([p[0] for p in parts]),
                    torch.cat([p[1] for p in parts]))

        ring_out = step("ring_predict", ring)
        fused_mean = fused_out = None
        if fused:
            group = axis_group(data, "data")
            spred = step("gather W", lambda: _whole_predictor(pred, n, mesh,
                                                              block))
            xq, _ = query_shard(xs, group)
            hq, _ = query_shard(hs, group)
            batch = min(m, FUSED_BATCH)
            # each rank serves its queries; the results gathered in order
            fused_mean = step("fused mean", lambda: gather_group_rows(
                serve_mean_batched(spred, x, xq, hq, batch=batch)[:, None],
                group)[:m, 0])
            mv = step("fused mean+var", lambda: gather_group_rows(torch.stack(
                serve_meanvar_batched(spred, x, xq, hq, batch=batch,
                                      quad_precision="high"), 1), group)[:m])
            fused_out = (mv[:, 0], mv[:, 1])
        where = (f"{world} x {torch.cuda.get_device_name(dev)}"
                 if dev.type == "cuda" else f"{world} CPU rank(s)")
        say(f"distributed fit n={n} on {where}: {seconds['fit_large']:.2f}s "
            f"(NLL={float(state.nll):.4g}, "
            f"{str(dtype).removeprefix('torch.')})")
        say(f"predictor_large (W = L^-1 by rows): "
            f"{seconds['predictor_large']:.2f}s")
        say(f"ring predict m={m}: {seconds['ring_predict']:.2f}s "
            f"({m / seconds['ring_predict']:,.0f} points/s mean+var; "
            f"{-(-m // per_call)} calls of {per_call} queries)")
        if fused:
            for name, what in (("fused mean", "mean-only"),
                               ("fused mean+var", "mean+var, 3xTF32 quad")):
                say(f"{name} serve m={m}: {seconds[name]:.2f}s "
                    f"({m / seconds[name]:,.0f} points/s {what})")
            dm, dv = ((f - r).abs().max() for f, r in zip(fused_out,
                                                          ring_out))
            say(f"fused tier vs ring: max |mean diff| {float(dm):.3e}, max "
                f"|var diff| / sigma2 {float(dv / state.sigma2):.3e}")
        say(f"bytes sent by rank 0: {sent}")
        return Run(state, xs, ring_out, fused_mean, fused_out, seconds, sent,
                   world)


def main(n: int = 16384, m: int = 1_000_000, d: int = 8, block: int = 256,
         verbose: bool = True, *, chunk: int = 65536,
         fused: Optional[bool] = None, dtype=None, device=None,
         workdir=None):
    """run_large.main at the published size: (state, mean[0], var[0]) of
    the ring. It writes nothing (workdir is taken for a uniform call)."""
    out = run(n, m, d, block, chunk=chunk, fused=fused, dtype=dtype,
              device=device, verbose=verbose)
    return out.state, float(out.ring[0][0]), float(out.ring[1][0])


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--m", type=int, default=1_000_000)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=65536)
    args = ap.parse_args()
    main(n=args.n, m=args.m, block=args.block, chunk=args.chunk,
         **common_kwargs(args))
