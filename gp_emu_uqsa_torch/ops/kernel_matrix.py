"""K1/K2: fused Gaussian correlation builds, CUDA for Hopper.

Port of `gp_emu_uqsa_tpu.ops.kernel_matrix`:

* K1 `gaussian_corr_self_fused` replaces `gaussian_corr_self_pallas`
  (`gp_emu_uqsa_tpu/ops/kernel_matrix.py:181`): A = exp(-D2(X/delta)) + nu I,
  the training matrix of every fit;
* K2 `gaussian_corr_fused` replaces `gaussian_corr_pallas` (`:122`): the
  cross block c(X1, X2) = exp(-D2) of validation and exact prediction.

The restarts of a multi-restart fit take `gaussian_corr_self_batched`: one
K1 launch a restart into a slice of one (B, n, n) output (a batch axis
inside the kernel is later work).

Both launch `csrc/corr_build.cu`, which scales the inputs by delta and adds
the nugget itself: a wrapper call allocates the output and makes one launch,
and never waits for the card (a nugget that is a tensor on the card goes to
the kernel as a pointer). What bounds the kernels on the card is the m n 4
bytes of the output; K1 builds each lower tile pair once and stores it
twice (`corr_self_tile_pairs` is its schedule), and a persistent grid
stores each tile while it computes the next (design notes in the source).
The TPU kernel's lane-packed bf16x6 distance is not ported: with d <= 20
the distance is computed as fp32 differences with FMAs, exact to fp32 and
exactly symmetric.

Each kernel has a plain PyTorch version here (`*_plain`) that computes the
same function with the same scaling and difference form, bit for bit. The
wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises. `launches` on each wrapper counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from gp_emu_uqsa_torch.ops import _build

# widest d the kernels take (csrc/common.cuh kMaxD); the JAX gates'
# packed_width(d) <= 128 is the same d <= 20
MAX_D = 20
# K1/K2's output tile (csrc/corr_build.cu kTile)
BUILD_TILE = 64
_SOURCE = "corr_build.cu"
_SELF_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p)
_CROSS_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)


def sq_dists_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_l (a_il - b_jl)^2 for already-scaled rows, shape (m, n).

    The kernels' distance in plain PyTorch: differences accumulated in
    feature order, exact to the working precision and symmetric when a is b.
    """
    d2 = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    for l in range(a.shape[1]):
        t = a[:, l, None] - b[None, :, l]
        d2.addcmul_(t, t)
    return d2


def sq_exp_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp(-sum_l (a_il - b_jl)^2) for already-scaled rows, shape (m, n):
    the Gaussian kernels' arithmetic in plain PyTorch (`sq_dists_plain`)."""
    return torch.exp(-sq_dists_plain(a, b))


def _check_cuda(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """What the kernels take: contiguous fp32 CUDA tensors, x with d <= 20."""
    for t in (x, *others):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must all be on the CUDA device "
                             f"or all on the CPU, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous fp32 tensors")
    if x.shape[1] > MAX_D:
        raise ValueError(f"{name}: d={x.shape[1]} > {MAX_D}; the callers' "
                         "gates send wider inputs to the plain path")


def _fp32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _delta_arg(delta, x: torch.Tensor) -> torch.Tensor:
    """delta as x.shape[1] contiguous fp32 values on x's device: the tensor
    itself when it is one already (no copy, no launch)."""
    if (isinstance(delta, torch.Tensor) and delta.dtype == torch.float32
            and delta.shape == (x.shape[1],) and delta.device == x.device
            and delta.is_contiguous()):
        return delta
    dl = torch.as_tensor(delta, dtype=torch.float32, device=x.device)
    if dl.ndim == 0:
        dl = dl.expand(x.shape[1])
    if dl.shape != (x.shape[1],):
        raise ValueError(f"delta has shape {tuple(dl.shape)}, expected "
                         f"({x.shape[1]},)")
    return dl.contiguous()


def _nugget_arg(nugget, x: torch.Tensor):
    """(tensor or None, value): a nugget that is a tensor on the card goes
    to the kernel by pointer, read there; anything else by value."""
    if isinstance(nugget, torch.Tensor) and nugget.device.type != "cpu":
        nu = nugget.to(device=x.device, dtype=torch.float32)
        if nu.numel() != 1:
            raise ValueError(f"nugget has {nu.numel()} values, expected 1")
        return nu, 0.0
    return None, float(nugget)


def _launch(symbol: str, argtypes, x: torch.Tensor, *args) -> None:
    """Call `symbol` of csrc/corr_build.cu on PyTorch's current stream."""
    fn = _build.kernel(_SOURCE, symbol, argtypes)
    stream = _build.stream_ptr(x)
    if x.device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(x.device):
            err = fn(*args, stream)
    _build.check(err, _SOURCE, symbol)


def gaussian_corr_self_plain(x, delta, nugget) -> torch.Tensor:
    """Plain version of K1: exp(-D2(x/delta)) + nugget I in fp32."""
    x = x.to(torch.float32)
    xs = x / torch.as_tensor(delta, dtype=torch.float32, device=x.device)
    a = sq_exp_plain(xs, xs)
    a.diagonal().add_(torch.as_tensor(nugget, dtype=a.dtype, device=a.device))
    return a


def tile_pair(p: int) -> tuple[int, int]:
    """Pair p of the lower triangle of tiles, row-major: (I, J), I >= J.

    The kernel's formula (csrc/corr_build.cu::tri_pair): an fp32 square
    root, then exact integer corrections.
    """
    f32 = np.float32
    i = int((np.sqrt(f32(8.0) * f32(p) + f32(1.0)) - f32(1.0)) * f32(0.5))
    while i * (i + 1) // 2 > p:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= p:
        i += 1
    return i, p - i * (i + 1) // 2


def corr_self_tile_pairs(n: int, tile: int = BUILD_TILE) -> list[tuple[int, int]]:
    """The tile pairs (I, J), I >= J, that K1 builds at size n, in the order
    of the kernel's pair index; each is stored at (I, J) and, for I > J,
    transposed at (J, I)."""
    tiles = -(-n // tile)
    return [tile_pair(p) for p in range(tiles * (tiles + 1) // 2)]


def gaussian_corr_self_mirrored_plain(x, delta, nugget,
                                      tile: int = BUILD_TILE) -> torch.Tensor:
    """K1's schedule in plain PyTorch, for the tests: only the lower tile
    pairs are computed, each is written at (I, J) and mirrored to (J, I),
    and the diagonal tiles get the nugget. Bitwise `gaussian_corr_self_plain`."""
    x = x.to(torch.float32)
    xs = x / torch.as_tensor(delta, dtype=torch.float32, device=x.device)
    nu = torch.as_tensor(nugget, dtype=torch.float32, device=x.device)
    n = xs.shape[0]
    a = torch.empty((n, n), dtype=torch.float32, device=x.device)
    for i, j in corr_self_tile_pairs(n, tile):
        rows = slice(i * tile, (i + 1) * tile)
        cols = slice(j * tile, (j + 1) * tile)
        block = sq_exp_plain(xs[rows], xs[cols])
        if i == j:
            block.diagonal().add_(nu)
        a[rows, cols] = block
        if i != j:
            a[cols, rows] = block.T
    return a


def _out_arg(out, n: int, x: torch.Tensor) -> torch.Tensor:
    """K1's output: a new (n, n) fp32 tensor, or `out` checked to be one
    contiguous (n, n) fp32 block on x's device (a slice out[b] of a batch)."""
    if out is None:
        return torch.empty((n, n), dtype=torch.float32, device=x.device)
    if (out.shape != (n, n) or out.dtype != torch.float32
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({n}, {n}) fp32 tensor on "
                         f"{x.device}, got {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}")
    return out


def gaussian_corr_self_fused(x, delta, nugget, *, out=None) -> torch.Tensor:
    """K1: A = exp(-sum_l ((x_i - x_j)/delta_l)^2) + nugget I, (n, n) fp32.

    Counterpart of `gaussian_corr_self_pallas`. x: (n, d) with d <= 20;
    delta: (d,); nugget: a number or a one-value tensor. `out`, when given,
    is the contiguous (n, n) fp32 block written and returned. CPU tensors
    take the plain version. On the card: one launch, no wait for the card.
    """
    x = _fp32(x)
    n = x.shape[0]
    if x.device.type == "cpu":
        a = gaussian_corr_self_plain(x, delta, nugget)
        return a if out is None else _out_arg(out, n, x).copy_(a)
    x = x.contiguous()
    dl = _delta_arg(delta, x)
    _check_cuda("gaussian_corr_self_fused", x, dl)
    nu, nu_value = _nugget_arg(nugget, x)
    d = x.shape[1]
    out = _out_arg(out, n, x)
    if n:
        _launch("gp_corr_self", _SELF_ARGTYPES, x, x.data_ptr(), dl.data_ptr(),
                None if nu is None else nu.data_ptr(), nu_value,
                out.data_ptr(), n, d)
        gaussian_corr_self_fused.launches += 1
    return out


gaussian_corr_self_fused.launches = 0


def gaussian_corr_self_batched_plain(x, deltas, nuggets) -> torch.Tensor:
    """Plain version of the batched K1: one `gaussian_corr_self_plain` per
    row of deltas (B, d) and nuggets (B,), stacked to (B, n, n)."""
    return torch.stack([gaussian_corr_self_plain(x, dl, nu)
                        for dl, nu in zip(deltas, nuggets)])


def gaussian_corr_self_batched(x, deltas, nuggets) -> torch.Tensor:
    """K1 for B hyperparameter sets against one x: (B, n, n) fp32.

    deltas: (B, d); nuggets: (B,). The restarts of a multi-restart fit
    share x. On the card each restart is one K1 launch into the contiguous
    slice out[b] (delta and nugget by pointer: no wait for the card); CPU
    tensors take the plain version.
    """
    x = _fp32(x)
    if x.device.type == "cpu":
        return gaussian_corr_self_batched_plain(x, deltas, nuggets)
    deltas = torch.as_tensor(deltas, dtype=torch.float32, device=x.device)
    nuggets = torch.as_tensor(nuggets, dtype=torch.float32, device=x.device)
    if deltas.ndim != 2 or nuggets.shape != deltas.shape[:1]:
        raise ValueError(f"deltas (B, d) and nuggets (B,) expected, got "
                         f"{tuple(deltas.shape)} and {tuple(nuggets.shape)}")
    deltas = deltas.contiguous()
    n = x.shape[0]
    out = torch.empty((deltas.shape[0], n, n), dtype=torch.float32,
                      device=x.device)
    for b in range(deltas.shape[0]):
        gaussian_corr_self_fused(x, deltas[b], nuggets[b], out=out[b])
    return out


def _check_dims(x1, x2):
    if x1.shape[1] != x2.shape[1]:
        raise ValueError(
            f"feature dims differ: x1 has {x1.shape[1]}, x2 has {x2.shape[1]}")


def gaussian_corr_plain(x1, x2, delta) -> torch.Tensor:
    """Plain version of K2: exp(-D2(x1 * (1/delta), x2 * (1/delta))) in fp32."""
    x1 = x1.to(torch.float32)
    x2 = x2.to(torch.float32)
    _check_dims(x1, x2)
    inv = 1.0 / torch.as_tensor(delta, dtype=torch.float32, device=x1.device)
    return sq_exp_plain(x1 * inv, x2 * inv)


def gaussian_corr_fused(x1, x2, delta) -> torch.Tensor:
    """K2: c(x1, x2) = exp(-D2), no nugget, (m, n) fp32.

    Counterpart of `gaussian_corr_pallas`; raises when the feature dims
    differ. CPU tensors take the plain version. On the card: one launch, no
    wait for the card.
    """
    x1 = _fp32(x1)
    x2 = _fp32(x2)
    _check_dims(x1, x2)
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return gaussian_corr_plain(x1, x2, delta)
    x1 = x1.contiguous()
    x2 = x2.contiguous()
    dl = _delta_arg(delta, x1)
    _check_cuda("gaussian_corr_fused", x1, x2, dl)
    (m, d), n = x1.shape, x2.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x1.device)
    if m and n:
        _launch("gp_corr_cross", _CROSS_ARGTYPES, x1, x1.data_ptr(),
                x2.data_ptr(), dl.data_ptr(), out.data_ptr(), m, n, d)
        gaussian_corr_fused.launches += 1
    return out


gaussian_corr_fused.launches = 0
