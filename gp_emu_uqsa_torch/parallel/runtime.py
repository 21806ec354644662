"""Process-group initialization and rank spawning for the multi-device path.

Port of `gp_emu_uqsa_tpu.parallel.runtime`. The JAX package calls
`jax.distributed.initialize()` and lets XLA place collectives; the port is
SPMD on `torch.distributed`: one process per rank, each holding its own
block, with explicit collectives (`parallel.mesh`).

Backends: NCCL for CUDA ranks, one card a rank, launched by `torchrun
--nproc_per_node=N`; gloo for CPU ranks (the tests). The device type
follows the port's policy, "cuda" unless the caller asks for "cpu", and a
CUDA rank without a card raises (`_device.resolve_device`). An NCCL error
is not caught: no rank falls back to gloo or to the CPU.

`spawn_ranks` starts N local processes joined by a process group (gloo on
the CPU in the tests; gloo ranks sharing one card in `chip_smoke.py`) and
returns what each rank's function returned. `process_group` is the group
of a command-line entry point: torchrun's, or one rank of its own.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import os
import queue
import socket
import sys
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from gp_emu_uqsa_torch._device import resolve_device

_DEFAULT_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def default_backend(device_type: Optional[str] = None) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return _DEFAULT_BACKEND[resolve_device(device_type).type]


def summary() -> dict:
    """The JAX package's summary keys for this process."""
    on = dist.is_available() and dist.is_initialized()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "local_devices": local,
        "global_devices": dist.get_world_size() if on else 1,
        "initialized_distributed": on,
    }


def init_multihost(backend: Optional[str] = None,
                   device_type: Optional[str] = None) -> dict:
    """Join the process group that `torchrun` describes, if any.

    Reads RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR/MASTER_PORT. A plain
    process (no WORLD_SIZE) is a no-op; a second call returns the summary
    of the group already joined. For CUDA ranks the rank's card is
    `cuda:LOCAL_RANK`, set before the group exists. Returns the summary
    (`process_index`, `process_count`, `local_devices`, `global_devices`,
    `initialized_distributed`).
    """
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return summary()
    dev = resolve_device(device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or _DEFAULT_BACKEND[dev.type],
                            init_method="env://",
                            device_id=dev if dev.type == "cuda" else None)
    return summary()


@contextlib.contextmanager
def process_group(device_type: Optional[str] = None,
                  backend: Optional[str] = None):
    """A process group for the body of the `with`, yielding `summary()`.

    Under `torchrun` (WORLD_SIZE set) it joins torchrun's group
    (`init_multihost`); in a plain process it makes a group of one rank on
    a free localhost port (NCCL on the card, gloo on the CPU), so that the
    SPMD functions run unchanged on one device. A group that exists
    already is used as it is and left open; a group made here is
    destroyed on exit.
    """
    if dist.is_initialized():
        yield summary()
        return
    dev = resolve_device(device_type)
    if "WORLD_SIZE" in os.environ:
        init_multihost(backend, dev.type)
    else:
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(
            backend or _DEFAULT_BACKEND[dev.type],
            init_method=f"tcp://localhost:{free_port()}", rank=0,
            world_size=1, device_id=dev if dev.type == "cuda" else None)
    try:
        yield summary()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost for a process group's store."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device_type, fn, args, results):
    try:
        torch.set_num_threads(1)
        if device_type == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except Exception:      # the parent raises it with this traceback
        results.put((rank, "error", traceback.format_exc()))
        sys.exit(1)


def spawn_ranks(fn: Callable, world: int, args: tuple = (), *,
                backend: str = "gloo", device_type: Optional[str] = None,
                timeout: float = 600.0) -> list:
    """Run fn(rank, *args) in `world` spawned processes joined by one
    process group on a localhost store; returns the ranks' results in rank
    order. `fn` must be importable by name (the processes are spawned);
    each rank runs torch on one CPU thread.

    device_type follows the port's policy: "cuda" unless the caller asks
    for "cpu", and "cuda" raises without a card. With "cuda" every rank
    uses cuda:0: several ranks share one card, which gloo allows and NCCL
    refuses. Raises with the failing rank's traceback if a rank fails, as
    soon as a rank exits without a result, and if the ranks do not finish
    within `timeout` seconds (then they are killed).
    """
    device_type = resolve_device(device_type).type
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend, device_type, fn,
                               args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    lost_before = False
    try:
        while len(out) + len(errors) < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"spawn_ranks: {world - len(out)} rank(s) did not "
                        f"finish within {timeout:g} s") from None
                # a rank that died before it could report (at start-up,
                # say): a report it did send is read on the next turn
                lost = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)}
                if lost and lost_before:
                    raise RuntimeError(
                        f"spawn_ranks: rank(s) exited without a result, "
                        f"exit codes {lost}") from None
                lost_before = bool(lost)
                continue
            if status == "ok":
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawn_ranks: a rank failed\n" + "\n".join(errors))
    return [out[r] for r in range(world)]
