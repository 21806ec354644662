"""fp32-exact matmul policy for the numerically sensitive compute paths.

Port of `gp_emu_uqsa_tpu.ops.precision`. On the TPU an fp32 matmul at
default precision is a single bf16 pass; on Hopper the same trap is
single-pass TF32 (about three decimal digits). The variance quadratic, the
GLS products and the distance expansion all cancel, so every product that
the JAX package pins to `Precision.HIGHEST` must run in full fp32 here.

`fp32_exact` turns `torch.backends.cuda.matmul.allow_tf32` off for the
duration of the call and restores the caller's setting afterwards, so user
code outside these paths is unaffected.
"""
from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def fp32_exact_matmul():
    """Context: full-fp32 CUDA matmuls (TF32 off), previous flag restored."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def fp32_exact(fn):
    """Decorator: run `fn` with TF32 off (the analog of HIGHEST precision)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with fp32_exact_matmul():
            return fn(*args, **kwargs)

    return wrapped
