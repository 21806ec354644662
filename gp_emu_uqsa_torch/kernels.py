"""Correlation kernels for GP emulation (port of `gp_emu_uqsa_tpu.kernels`).

Reference parity: GP_emu_UQSA's Gaussian (squared-exponential) correlation
(reference `_emulatorkernels.py`, SURVEY.md S3) is

    A_ij = exp( - sum_l ((x_il - x_jl) / delta_l)^2 ) + nu * 1[i==j]

i.e. NO factor 1/2 in the exponent (MUCM convention). sigma^2 scales the
correlation matrix into a covariance. Hyperparameters travel in log space.

The general path sums exact differences of the delta-scaled inputs
(`scaled_sq_dists`), where the JAX package takes the expansion
||x||^2 + ||x'||^2 - 2 x.x', which cancels in fp32. On a CUDA
device the gaussian family takes the hand-written kernels of
`ops.kernel_matrix` inside the same gates as the JAX package's Pallas
builds (`_fast_self_ok`, `_fast_cross_ok`), with "the tensor is on a CUDA
device" in place of "the backend is a TPU". The kernels sit inside
`torch.autograd.Function`s (`_GaussianSelfFast`, `_GaussianCrossFast`)
whose backward is the analytic adjoint (`_gaussian_self_grads`,
`_gaussian_cross_grads`) in full fp32 or fp64, so likelihoods built on
them are differentiable on the card.

Hyperparameters may carry a leading batch axis (the restarts of a
multi-restart fit): `corr_self` with delta (B, d) and nugget (B,) against
one x returns A of shape (B, n, n).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.ops.kernel_matrix import (
    MAX_D, gaussian_corr_fused, gaussian_corr_self_batched,
    gaussian_corr_self_fused,
)
from gp_emu_uqsa_torch.ops.precision import fp32_exact


class GPParams(NamedTuple):
    """Log-space hyperparameters of the Gaussian-kernel GP.

    Attributes:
      log_delta: (d_active,) per-dimension correlation lengths, log delta_l.
      log_sigma2: () log of the scale variance sigma^2 (profiled out by the
        concentrated/MUCM likelihood, load-bearing in `gp4ml` mode).
      log_nugget: () log of the nugget nu added to the diagonal.
    """

    log_delta: torch.Tensor
    log_sigma2: torch.Tensor
    log_nugget: torch.Tensor

    @property
    def delta(self) -> torch.Tensor:
        return torch.exp(self.log_delta)

    @property
    def sigma2(self) -> torch.Tensor:
        return torch.exp(self.log_sigma2)

    @property
    def nugget(self) -> torch.Tensor:
        return torch.exp(self.log_nugget)


def make_params(delta, sigma2=1.0, nugget=0.0, *, device=None,
                dtype=torch.float32, min_nugget=1e-12) -> GPParams:
    """GPParams from natural-space values (a zero nugget is clamped to
    `min_nugget` so log space stays finite). `device=None` means CUDA."""
    dev = resolve_device(device)
    delta = torch.as_tensor(np.asarray(delta), dtype=dtype, device=dev)
    sigma2 = torch.as_tensor(sigma2, dtype=dtype, device=dev)
    nugget = torch.clamp(torch.as_tensor(nugget, dtype=dtype, device=dev),
                         min=min_nugget)
    return GPParams(torch.log(delta), torch.log(sigma2), torch.log(nugget))


def params_from_numpy(log_delta, log_sigma2, log_nugget, *, device=None,
                      dtype=torch.float64) -> GPParams:
    """The JAX package's log-space parameters, as numpy arrays, as GPParams.

    This is how trained weights cross from the JAX package (or its
    checkpoints) to the port. `device=None` means CUDA.
    """
    dev = resolve_device(device)

    def conv(v):
        return torch.as_tensor(np.array(v, dtype=np.float64), dtype=dtype,
                               device=dev)

    return GPParams(conv(log_delta), conv(log_sigma2), conv(log_nugget))


class _ScaledSqDists(torch.autograd.Function):
    """`scaled_sq_dists` with a backward that saves no (n1, n2) tensor.

    Autograd through the feature loop would keep every feature's difference,
    d tensors of shape (..., n1, n2). The backward instead recomputes the
    exact differences a feature at a time: the delta cotangent is
    `sq_diff_contraction` of the incoming one, the x cotangents are row and
    column sums of it times the differences.
    """

    @staticmethod
    def forward(ctx, x1, x2, delta):
        ctx.save_for_backward(x1, x2, delta)
        delta = delta[..., None, :]
        xs1 = x1 / delta
        xs2 = x2 / delta
        d2 = None
        for l in range(x1.shape[-1]):
            t = xs1[..., :, l, None] - xs2[..., None, :, l]
            d2 = t * t if d2 is None else torch.addcmul(d2, t, t)
        return d2

    @staticmethod
    def backward(ctx, g):
        x1, x2, delta = ctx.saved_tensors
        gx1 = gx2 = gdelta = None
        if ctx.needs_input_grad[2]:
            gdelta = (-2.0 / delta**3) * sq_diff_contraction(g, x1, x2)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            # d d2_ij/d x1_il = -d d2_ij/d x2_jl = 2 (x1_il - x2_jl)/delta_l^2
            rows, cols = [], []
            for l in range(x1.shape[1]):
                t = g * (x1[:, l, None] - x2[None, :, l])
                rows.append(t.sum(-1))
                cols.append(t.sum(-2))
            scale = (2.0 / (delta * delta))[..., None, :]
            gx1 = scale * torch.stack(rows, -1)
            gx2 = -scale * torch.stack(cols, -1)
            gx1 = gx1.reshape(-1, *x1.shape).sum(0)
            gx2 = gx2.reshape(-1, *x2.shape).sum(0)
        return gx1, gx2, gdelta


def scaled_sq_dists(x1: torch.Tensor, x2: torch.Tensor,
                    delta: torch.Tensor) -> torch.Tensor:
    """sum_l ((x1_il - x2_jl)/delta_l)^2 for all pairs, shape (..., n1, n2).

    Exact differences of the delta-scaled inputs, summed one feature at a
    time into one (..., n1, n2) accumulator: K1's arithmetic
    (`ops.kernel_matrix.sq_exp_plain`), so a self build has an exactly zero
    diagonal and is exactly symmetric. The JAX package's matmul expansion
    |a|^2 + |b|^2 - 2 a.b cancels in fp32 (tests/test_torch_uqsa.py::
    test_plain_self_build_fp32_exact_diagonal holds the two against fp64).
    x1 (n1, d) and x2 (n2, d); delta is (d,) or (..., d) (one set of length
    scales per batch entry). Differentiable, and its backward keeps no
    (n1, n2) tensor (`_ScaledSqDists`).
    """
    return _ScaledSqDists.apply(x1, x2, delta)


def _safe_dist(d2: torch.Tensor) -> torch.Tensor:
    """sqrt(d2) with a zero (not NaN) gradient at d2 == 0 (double where)."""
    pos = d2 > 0.0
    safe = torch.where(pos, d2, torch.ones_like(d2))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(d2))


def _corr_gaussian(d2: torch.Tensor) -> torch.Tensor:
    return torch.exp(-d2)


def _corr_matern52(d2: torch.Tensor) -> torch.Tensor:
    s = math.sqrt(5.0) * _safe_dist(d2)
    return (1.0 + s + (s * s) / 3.0) * torch.exp(-s)


def _corr_matern32(d2: torch.Tensor) -> torch.Tensor:
    s = math.sqrt(3.0) * _safe_dist(d2)
    return (1.0 + s) * torch.exp(-s)


def _corr_exponential(d2: torch.Tensor) -> torch.Tensor:
    return torch.exp(-_safe_dist(d2))


# Correlation families on the delta-scaled squared distance d2. The UQSA
# analytics have closed forms ONLY for "gaussian". The build kernels K1/K2
# take only "gaussian"; the serving kernels K3/K4 have a "gaussian" and a
# "matern52" instance (`ops.serve.FAMILIES`), whose plain versions apply
# these functions.
CORR_FAMILIES = {
    "gaussian": _corr_gaussian,
    "matern52": _corr_matern52,
    "matern32": _corr_matern32,
    "exponential": _corr_exponential,
}

_FAST_SELF_MIN_N = 512       # below this a launch costs about the build
_FAST_CROSS_MIN_ROWS = 256   # both sides, as the JAX gate requires


@fp32_exact
def sq_diff_contraction(m: torch.Tensor, x1: torch.Tensor,
                        x2: torch.Tensor) -> torch.Tensor:
    """sum_ij M_ij (x1_il - x2_jl)^2 for every feature l: (..., d).

    The delta-gradients of a Gaussian build. The JAX package collapses this
    sum to (r + c)^T x_l^2 - 2 x_l^T M x_l, whose two terms cancel: in fp32
    on an H100 at n = 4096 (chip_smoke.py phase 4) the collapse carried up
    to 3e-2 relative error on the NLL gradient at starts where A is well
    conditioned (kappa under 10), and noise larger than the gradient itself
    at short length scales; this form 1.4e-6. The differences are exact, so
    only the sum rounds. One (n1, n2) temporary a feature, shared by the
    batch of M.
    """
    return torch.stack(
        [torch.einsum("...ij,ij->...", m, (x1[:, k, None] - x2[None, :, k]) ** 2)
         for k in range(x1.shape[1])], dim=-1)


@fp32_exact
def _gaussian_cross_grads(x1, x2, delta, c, ct):
    """Analytic cotangents of sum(ct * c(x1, x2, delta)).

    With M = ct * c (ct need not be symmetric):
      d c_ij / d delta_l  = c_ij * 2 (x1_il - x2_jl)^2 / delta_l^3
      d c_ij / d x1_il    = c_ij * (-2)(x1_il - x2_jl) / delta_l^2
      d c_ij / d x2_jl    = c_ij * (+2)(x1_il - x2_jl) / delta_l^2
    The x gradients collapse to row/column sums plus products; the delta
    gradient is `sq_diff_contraction`. O(n^2 d). Every product runs in full
    fp32 (TF32 off): autograd runs a backward after the forward's precision
    context has closed.

    c and ct may carry a leading batch axis, delta then (B, d); x1 and x2
    are shared. Returns (grad_x1, grad_x2, grad_delta), the x gradients
    per batch entry.
    """
    m = ct * c
    r = torch.sum(m, dim=-1)                              # (..., n1)
    col = torch.sum(m, dim=-2)                            # (..., n2)
    mx2 = m @ x2                                          # (..., n1, d)
    grad_delta = (2.0 / delta**3) * sq_diff_contraction(m, x1, x2)
    inv_d2 = (1.0 / (delta * delta))[..., None, :]
    grad_x1 = (-2.0 * inv_d2) * (x1 * r[..., None] - mx2)
    grad_x2 = (-2.0 * inv_d2) * (x2 * col[..., None] - m.mT @ x1)
    return grad_x1, grad_x2, grad_delta


@fp32_exact
def _gaussian_self_grads(x, delta, nugget, a, ct):
    """Analytic (grad_x, grad_delta, grad_nugget) for the SELF build.

    The cross formula applied at x1 = x2 = x with both input-slot
    cotangents summed, plus the nugget diagonal: A = c(x, x) + nugget*I.
    Batched as `_gaussian_cross_grads` (nugget then (B,)).
    """
    n = x.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    a_corr = a - nugget[..., None, None] * eye
    gx1, gx2, grad_delta = _gaussian_cross_grads(x, x, delta, a_corr, ct)
    grad_nugget = torch.diagonal(ct, dim1=-2, dim2=-1).sum(-1)
    return gx1 + gx2, grad_delta, grad_nugget


def _sum_to(grad: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-batch-entry gradient summed over the batch axes `like` lacks."""
    return grad.reshape((-1,) + like.shape).sum(0)


class _GaussianSelfFast(torch.autograd.Function):
    """K1 with its analytic adjoint (the JAX package's `_gaussian_self_fast`).

    delta (d,) and nugget () give one (n, n) build; delta (B, d) and nugget
    (B,) give (B, n, n), one K1 launch a restart.
    """

    @staticmethod
    def forward(ctx, x, delta, nugget):
        if delta.ndim == 1:
            a = gaussian_corr_self_fused(x, delta, nugget)
        else:
            a = gaussian_corr_self_batched(x, delta, nugget)
        ctx.save_for_backward(x, delta, nugget, a)
        return a

    @staticmethod
    def backward(ctx, ct):
        x, delta, nugget, a = ctx.saved_tensors
        grad_x, grad_delta, grad_nugget = _gaussian_self_grads(
            x, delta, nugget, a, ct)
        if ctx.needs_input_grad[0]:
            grad_x = _sum_to(grad_x, x)
        else:
            grad_x = None
        return grad_x, grad_delta, grad_nugget


class _GaussianCrossFast(torch.autograd.Function):
    """K2 with its analytic adjoint (the JAX package's `_gaussian_cross_fast`).

    delta (B, d) stacks one K2 launch per batch entry.
    """

    @staticmethod
    def forward(ctx, x1, x2, delta):
        if delta.ndim == 1:
            c = gaussian_corr_fused(x1, x2, delta)
        else:
            c = torch.stack([gaussian_corr_fused(x1, x2, dl) for dl in delta])
        ctx.save_for_backward(x1, x2, delta, c)
        return c

    @staticmethod
    def backward(ctx, ct):
        x1, x2, delta, c = ctx.saved_tensors
        gx1, gx2, grad_delta = _gaussian_cross_grads(x1, x2, delta, c, ct)
        return (_sum_to(gx1, x1) if ctx.needs_input_grad[0] else None,
                _sum_to(gx2, x2) if ctx.needs_input_grad[1] else None,
                grad_delta)


def _fast_self_ok(x: torch.Tensor) -> bool:
    return (x.is_cuda and x.ndim == 2 and x.dtype == torch.float32
            and x.shape[0] >= _FAST_SELF_MIN_N
            and x.shape[1] <= MAX_D)


def _fast_cross_ok(x1: torch.Tensor, x2: torch.Tensor) -> bool:
    return (x1.is_cuda and x2.is_cuda and x1.ndim == 2 and x2.ndim == 2
            and x1.dtype == torch.float32 and x2.dtype == torch.float32
            and x1.shape[0] >= _FAST_CROSS_MIN_ROWS
            and x2.shape[0] >= _FAST_CROSS_MIN_ROWS
            and x1.shape[1] == x2.shape[1]
            and x1.shape[1] <= MAX_D)


def corr(x1: torch.Tensor, x2: torch.Tensor, params: GPParams,
         family: str = "gaussian") -> torch.Tensor:
    """Cross-correlation matrix c(x1_i, x2_j), no nugget, shape (n1, n2).

    On a CUDA device the gaussian family takes kernel K2
    (`ops.kernel_matrix.gaussian_corr_fused`) when both sides span at least
    256 rows, in fp32, with d <= 20. K2 builds the gaussian only: every
    other family, and the gemm serving tier of a matern52 emulator, takes
    the plain build (`scaled_sq_dists` through the family's function);
    serving that never writes c runs K3/K4 (`ops.serve`), which take
    gaussian and matern52.
    """
    if family == "gaussian" and _fast_cross_ok(x1, x2):
        return _GaussianCrossFast.apply(x1, x2, params.delta)
    try:
        fn = CORR_FAMILIES[family]
    except KeyError:
        raise ValueError(
            f"unknown kernel family {family!r}; one of {sorted(CORR_FAMILIES)}"
        ) from None
    return fn(scaled_sq_dists(x1, x2, params.delta))


def corr_self(x: torch.Tensor, params: GPParams,
              family: str = "gaussian") -> torch.Tensor:
    """Training correlation matrix A = c(X, X) + nugget*I, symmetrized.

    The general path symmetrizes (A + A^T)/2 so the Cholesky sees an exactly
    symmetric operand. On a CUDA device the gaussian family in fp32 with
    n >= 512 and d <= 20 takes kernel K1
    (`ops.kernel_matrix.gaussian_corr_self_fused`), whose difference-form
    distance is exactly symmetric already. params with delta (B, d) and
    nugget (B,) give A of shape (B, n, n). Differentiable in the
    hyperparameters on both paths.
    """
    if family == "gaussian" and _fast_self_ok(x):
        return _GaussianSelfFast.apply(x, params.delta, params.nugget)
    a = corr(x, x, params, family)
    a = 0.5 * (a + a.mT)
    n = x.shape[0]
    return a + params.nugget[..., None, None] * torch.eye(
        n, dtype=a.dtype, device=a.device)


def gaussian_corr(x1: torch.Tensor, x2: torch.Tensor,
                  params: GPParams) -> torch.Tensor:
    """Gaussian-family cross-correlation (the reference's only kernel)."""
    return torch.exp(-scaled_sq_dists(x1, x2, params.delta))


def gaussian_corr_self(x: torch.Tensor, params: GPParams) -> torch.Tensor:
    """Gaussian-family training matrix A = c(X, X) + nugget*I, symmetrized."""
    return corr_self(x, params, "gaussian")
