"""K1/K2: fused Gaussian correlation builds, CUDA for Hopper.

Port of `gp_emu_uqsa_tpu.ops.kernel_matrix`:

* K1 `gaussian_corr_self_fused` replaces `gaussian_corr_self_pallas`
  (`gp_emu_uqsa_tpu/ops/kernel_matrix.py:181`): A = exp(-D2(X/delta)) + nu I,
  the training matrix of every fit;
* K2 `gaussian_corr_fused` replaces `gaussian_corr_pallas` (`:122`): the
  cross block c(X1, X2) = exp(-D2) of validation and exact prediction.

Both launch `csrc/corr_build.cu` (one kernel, a nugget flag). What bounds
it on the card is the m n 4 bytes of the output; the kernel builds each
output tile once from delta-scaled rows staged in shared memory and stores
it with coalesced writes (design notes in the source). The TPU kernel's
lane-packed bf16x6 distance is not ported: with d <= 20 the distance is
computed as fp32 differences with FMAs, exact to fp32 and exactly symmetric.

Each kernel has a plain PyTorch version here (`*_plain`) that computes the
same function with the same difference form. The wrapper runs the plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises. `launches` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from gp_emu_uqsa_torch.ops import _build

# widest d the kernels take (csrc/common.cuh kMaxD); the JAX gates'
# packed_width(d) <= 128 is the same d <= 20
MAX_D = 20
_SOURCE = "corr_build.cu"
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_void_p)


def sq_exp_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """exp(-sum_l (a_il - b_jl)^2) for already-scaled rows, shape (m, n).

    The kernels' arithmetic in plain PyTorch: differences accumulated in
    feature order, exact to the working precision and symmetric when a is b.
    """
    d2 = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
    for l in range(a.shape[1]):
        t = a[:, l, None] - b[None, :, l]
        d2.addcmul_(t, t)
    return torch.exp(-d2)


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


def _launch_build(a, b, out, nugget: float, add_nugget: bool, what: str):
    """Launch csrc/corr_build.cu; returns False (no launch) for an empty out."""
    m, d = a.shape
    n = b.shape[0]
    if m == 0 or n == 0:
        return False
    fn = _build.kernel(_SOURCE, "gp_corr_build", _ARGTYPES)
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, d,
                 float(nugget), int(add_nugget), _build.stream_ptr(a))
    _build.check(err, _SOURCE, what)
    return True


def gaussian_corr_self_plain(x, delta, nugget) -> torch.Tensor:
    """Plain version of K1: exp(-D2(x/delta)) + nugget I in fp32."""
    x = x.to(torch.float32)
    xs = x / torch.as_tensor(delta, dtype=torch.float32, device=x.device)
    a = sq_exp_plain(xs, xs)
    a.diagonal().add_(torch.as_tensor(nugget, dtype=a.dtype, device=a.device))
    return a


def gaussian_corr_self_fused(x, delta, nugget) -> torch.Tensor:
    """K1: A = exp(-sum_l ((x_i - x_j)/delta_l)^2) + nugget I, (n, n) fp32.

    Counterpart of `gaussian_corr_self_pallas`. x: (n, d) with d <= 20;
    delta: (d,); nugget: scalar. CPU tensors take the plain version.
    """
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return gaussian_corr_self_plain(x, delta, nugget)
    # scaled as the JAX kernel scales (x / delta)
    xs = (x / torch.as_tensor(delta, dtype=torch.float32,
                              device=x.device)).contiguous()
    _check_cuda("gaussian_corr_self_fused", xs)
    n = xs.shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=xs.device)
    if _launch_build(xs, xs, out, float(nugget), True,
                     "gaussian_corr_self_fused"):
        gaussian_corr_self_fused.launches += 1
    return out


gaussian_corr_self_fused.launches = 0


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
    differ. CPU tensors take the plain version.
    """
    x1 = x1.to(torch.float32)
    x2 = x2.to(torch.float32)
    _check_dims(x1, x2)
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return gaussian_corr_plain(x1, x2, delta)
    # scaled as the JAX kernel scales (x * (1/delta))
    inv = 1.0 / torch.as_tensor(delta, dtype=torch.float32, device=x1.device)
    a = (x1 * inv).contiguous()
    b = (x2 * inv).contiguous()
    _check_cuda("gaussian_corr_fused", a, b)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32,
                      device=a.device)
    if _launch_build(a, b, out, 0.0, False, "gaussian_corr_fused"):
        gaussian_corr_fused.launches += 1
    return out


gaussian_corr_fused.launches = 0
