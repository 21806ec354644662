"""Device meshes, row layouts and the collectives of the multi-device path.

Port of `gp_emu_uqsa_tpu.parallel.mesh`. The engine's parallel axes:
  chains   - HMC chains / MLE restarts
  data     - prediction points
  mr, mc   - the 2-D axes of the sharded dense linear algebra

`make_mesh` returns a `torch.distributed.device_mesh.DeviceMesh` with these
axis names over the ranks of the process group (`parallel.runtime`). The
code is SPMD: every rank runs the same function on its own block and
exchanges blocks through the helpers below. `mesh=None` means one device
and no collectives.

What JAX's `NamedSharding` becomes:
  NamedSharding(mesh, P())           replicated: every rank holds the whole
                                     tensor (x, y, h, the fit's small parts)
  NamedSharding(mesh, P(axis))       `shard_rows(t, mesh, axis)`: this rank's
  NamedSharding(mesh, P(axis, None)) row block; `gather_rows` is the way
                                     back (for checks, and for the (n, k)
                                     results of a distributed solve)
GSPMD inserted the reshards between layouts itself; here they are the
explicit all-gathers, broadcasts and ring shifts of each algorithm.

Row layouts (`RowBlocks`): the rows of an (n_pad, ...) matrix are dealt in
blocks of `block` rows round-robin over the p ranks of an axis (block i
on rank i % p, local rows in global order). block = n_pad / p is the
contiguous layout of P(axis, None); smaller blocks give the block-cyclic
rows that keep a triangular factorization's ranks equally busy.

Collectives: the tensors go to the backend as they are, except that for
the gloo backend a CUDA tensor is copied to the host and back, because
gloo does not take CUDA tensors for every collective (point-to-point in
particular). The rule is keyed on the backend. `traffic.bytes` counts the
bytes this rank sends, by the algorithm's count: an all-gather sends the
local part to each of the p - 1 others, an all-reduce 2 (p - 1) / p of the
tensor (ring), a broadcast (p - 1) copies from the source and nothing from
the others, a ring shift one tensor.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gp_emu_uqsa_torch._device import resolve_device

def make_mesh(shape: Optional[dict] = None, *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh over the process group's ranks; shape maps axis name ->
    size, default all ranks on "chains".

    device_type is "cuda" unless the caller asks for "cpu"; "cuda" raises
    without a card. The process group must exist (`init_multihost`, or
    `runtime.spawn_ranks`).
    """
    dev = resolve_device(device_type)
    world = dist.get_world_size()
    if shape is None:
        shape = {"chains": world}
    sizes = tuple(int(s) for s in shape.values())
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh shape {shape} needs {int(np.prod(sizes))} "
                         f"ranks, have {world}")
    return DeviceMesh(dev.type, torch.arange(world).reshape(sizes),
                      mesh_dim_names=tuple(shape))


def mesh_device(mesh: Optional[DeviceMesh]) -> Optional[torch.device]:
    """The device of this rank's tensors on `mesh` (None without a mesh)."""
    if mesh is None:
        return None
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group of `axis` (None without a mesh)."""
    return None if mesh is None else mesh.get_group(axis)


def group_of(group):
    """A process group from `group`: None, a ProcessGroup, or a
    (DeviceMesh, axis name) pair."""
    if isinstance(group, tuple):
        return group[0].get_group(group[1])
    return group


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class Traffic:
    """Bytes this rank sends through the helpers below (see the module
    docstring for how each collective counts)."""

    def __init__(self):
        self.bytes = 0

    def reset(self):
        self.bytes = 0


traffic = Traffic()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host_staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (or "max") of t over the group's ranks; t itself without one."""
    if group is None:
        return t
    p = dist.get_world_size(group)
    traffic.bytes += int(2 * (p - 1) / p * _nbytes(t))
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    buf = t.cpu() if _host_staged(t, group) else t.clone()
    dist.all_reduce(buf, op=red, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' tensors stacked in rank order, (p, *t.shape)."""
    if group is None:
        return t[None]
    p = dist.get_world_size(group)
    traffic.bytes += (p - 1) * _nbytes(t)
    src = t.contiguous()
    if _host_staged(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(p)]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(t.device)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Rank `src`'s t (src a rank of the group) on every rank; t must have
    the same shape and dtype everywhere."""
    if group is None:
        return t
    if dist.get_rank(group) == src:
        traffic.bytes += (dist.get_world_size(group) - 1) * _nbytes(t)
    buf = t.contiguous()
    buf = buf.cpu() if _host_staged(t, group) else buf.clone()
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(t.device)


def shift(t: torch.Tensor, group) -> torch.Tensor:
    """Ring step: send t to rank + 1, return what rank - 1 sent."""
    p, me = dist.get_world_size(group), dist.get_rank(group)
    traffic.bytes += _nbytes(t)
    send = t.contiguous()
    if _host_staged(t, group):
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me + 1) % p), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - 1) % p), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device)


class RowBlocks:
    """Rows of an (n_pad, ...) matrix over the p ranks of an axis: blocks
    of `block` rows, block i on rank i % p; block=None is the contiguous
    layout (block = n_pad / p). `index` holds the global indices of this
    rank's rows in local order (ascending)."""

    def __init__(self, n_pad: int, p: int, rank: int,
                 block: Optional[int] = None):
        block = n_pad // p if block is None else int(block)
        if block < 1 or n_pad % (p * block):
            raise ValueError(f"{n_pad} rows do not split into blocks of "
                             f"{block} over {p} ranks")
        self.n_pad, self.p, self.rank, self.block = n_pad, p, rank, block
        mine = np.arange(rank, n_pad // block, p)
        self.index = (mine[:, None] * block + np.arange(block)).reshape(-1)
        self.rows = self.index.size

    @classmethod
    def of(cls, n_pad: int, group, block: Optional[int] = None):
        return cls(n_pad, group_size(group), group_rank(group), block)

    def owner(self, row: int) -> tuple[int, int]:
        """(rank, local row) of global row `row`."""
        blk = row // self.block
        return blk % self.p, (blk // self.p) * self.block + row % self.block

    def local_from(self, row: int) -> int:
        """How many local rows have a global index below `row`."""
        return int(np.searchsorted(self.index, row))

    def index_tensor(self, device) -> torch.Tensor:
        return torch.as_tensor(self.index, device=device)


def padded_rows(n: int, p: int, block: int) -> int:
    """n rounded up to a multiple of p * block."""
    step = p * block
    return -(-n // step) * step


def shard_rows(t: torch.Tensor, mesh: Optional[DeviceMesh], axis: str,
               block: Optional[int] = None) -> torch.Tensor:
    """This rank's rows of t (n_pad rows) in the `RowBlocks` layout of
    `axis`; t itself without a mesh."""
    group = axis_group(mesh, axis)
    if group is None:
        return t
    rows = RowBlocks.of(t.shape[0], group, block)
    return t[rows.index_tensor(t.device)]


def gather_group_rows(t_local: torch.Tensor, group,
                      block: Optional[int] = None,
                      n_pad: Optional[int] = None) -> torch.Tensor:
    """The whole tensor from each rank's rows in the `RowBlocks` layout
    (one all-gather); t_local itself without a group. `n_pad` defaults to
    p times the local rows."""
    if group is None:
        return t_local
    parts = all_gather(t_local, group)
    p = parts.shape[0]
    n_pad = p * t_local.shape[0] if n_pad is None else n_pad
    out = torch.empty((n_pad, *t_local.shape[1:]), dtype=t_local.dtype,
                      device=t_local.device)
    for r in range(p):
        out[RowBlocks(n_pad, p, r, block).index_tensor(out.device)] = parts[r]
    return out


def gather_rows(t_local: torch.Tensor, mesh: Optional[DeviceMesh], axis: str,
                block: Optional[int] = None) -> torch.Tensor:
    """The whole tensor from each rank's rows of `axis` (the inverse of
    `shard_rows`); t_local itself without a mesh."""
    return gather_group_rows(t_local, axis_group(mesh, axis), block)
