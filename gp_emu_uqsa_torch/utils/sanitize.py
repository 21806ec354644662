"""Numerics sanitizers: staged checks of a fit, and NaN debugging.

Port of `gp_emu_uqsa_tpu.utils.sanitize`. The production convention is
inf-not-NaN (a failed factorization yields NLL = +inf so optimizers and
samplers reject the point silently, gp.py::_guard). That is correct
behavior but a poor debugging experience: WHERE the non-finite value arose
is erased. This module is the opt-in diagnosis layer:

  * `checked_fit`: gp.fit with staged checks (inputs -> kernel matrix ->
    factorization -> posterior stats), each with an actionable message,
    run eagerly in the JAX package's order (the JAX messages without
    checkify's " (`check` failed)" suffix). It returns (error, state);
    `error.get()` is None or the FIRST failing stage's message and
    `error.throw()` raises it: the surface of checkify's `Error` that
    callers use. The factorization stage reads `cholesky_ex`'s `info`, not
    NaN (a failed factor has no NaN on this side).
  * `debug_nans`: raises FloatingPointError where an op under the context
    returns a NaN, as `jax_debug_nans` does (a torch function mode that
    checks every output: one host sync an op). NOTE: the jitter ladder
    probes with factorizations that may fail (ops/cholesky.py), and a NaN
    factor is its failure signal, so `debug_nans` can fire inside
    `cholesky_with_jitter`; use it around *prediction/serving* code, and
    `checked_fit` for fit-path diagnosis.

Kept OUT of the hot path on purpose: production code never pays for it.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
from torch.overrides import TorchFunctionMode

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.kernels import corr_self
from gp_emu_uqsa_torch.ops.cholesky import _attempt, cholesky_with_jitter


class CheckError:
    """The first failed check of a staged run, or none."""

    def __init__(self, message: Optional[str] = None):
        self._message = message

    def get(self) -> Optional[str]:
        """The first failing stage's message, or None on a clean run."""
        return self._message

    def throw(self) -> None:
        """Raise the first failing stage's message as a RuntimeError."""
        if self._message is not None:
            raise RuntimeError(self._message)


def checked_fit(params, x, y, h, *, mode: str = "mucm", noise_diag=None,
                family: str = "gaussian", refine: int = 0):
    """gp.fit with staged numerics checks (debug path; about 2x fit cost).

    Returns (error, state): `error.get()` is None on a clean fit, else a
    message naming the first failing stage. The returned state is the
    regular gp.fit result (garbage if an error fired: check first).
    """
    failed = []

    def check(ok, message):
        if not failed and not bool(ok):
            failed.append(message)

    check(torch.all(torch.isfinite(x)), "non-finite training inputs x")
    check(torch.all(torch.isfinite(y)), "non-finite training outputs y")
    check(torch.all(torch.isfinite(h)), "non-finite basis matrix H")
    a = corr_self(x, params, family)
    if noise_diag is not None:
        a = a + torch.diag(torch.as_tensor(noise_diag, dtype=a.dtype,
                                           device=a.device))
    check(
        torch.all(torch.isfinite(a)),
        "kernel matrix has non-finite entries: log_delta or nugget "
        "overflow/underflow (exp of a huge hyperparameter?)",
    )
    _, jitter = cholesky_with_jitter(a)
    _, factored = _attempt(a.reshape(1, *a.shape), jitter.reshape(1))
    check(
        factored.all(),
        "Cholesky failed at MAX jitter: kernel matrix is not "
        "numerically SPD in this dtype — duplicated inputs with a "
        "tiny nugget, or length-scales so large the matrix is "
        "numerically rank-1. Raise the nugget or use fp64.",
    )
    state = gp.fit(params, x, y, h, mode=mode, noise_diag=noise_diag,
                   family=family, refine=refine)
    degenerate = False
    if mode == "mucm":
        # the port's resid |L^-1 (y - H beta)|^2 stays positive where y lies
        # in the span of H, so its NLL stays finite (the JAX package's
        # difference y^T A^-1 y - ... falls to <= 0 and its NLL to inf):
        # a resid within the rounding of y^T A^-1 y is zero
        resid = y @ state.e
        y_ainv_y = y @ (state.e + state.ainv_h @ state.beta)
        eps = torch.finfo(state.e.dtype).eps
        degenerate = bool(resid <= y.shape[0] * eps * torch.abs(y_ainv_y))
    check(
        torch.isfinite(state.nll) & (not degenerate),
        "NLL non-finite despite a successful factorization: "
        "concentrated sigma2 or logdet degenerate (n - q - 2 <= 0, "
        "or zero residual variance — is y constant?)",
    )
    check(state.sigma2 > 0, "non-positive sigma2 estimate (zero residuals?)")
    return CheckError(failed[0] if failed else None), state


def checked_nll(params, x, y, h, *, mode: str = "mucm",
                family: str = "gaussian"):
    """Checked likelihood evaluation: (error, nll). See checked_fit."""
    err, state = checked_fit(params, x, y, h, mode=mode, family=family)
    return err, state.nll


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class _RaiseOnNan(TorchFunctionMode):
    """Raises FloatingPointError where a torch function returns a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if (t.is_floating_point() or t.is_complex()) and bool(
                    torch.isnan(t).any()):
                name = getattr(func, "__name__", repr(func))
                raise FloatingPointError(f"invalid value (nan) encountered "
                                         f"in {name}")
        return out


@contextmanager
def debug_nans(enable: bool = True):
    """Within the block, an op that returns a NaN raises FloatingPointError
    (see the module docstring's caveat); enable=False leaves ops as they
    are."""
    if not enable:
        yield
        return
    with _RaiseOnNan():
        yield
