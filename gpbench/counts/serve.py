"""Operations and bytes of the serving kernels and of a served request.

Counted from shapes: m queries, n training rows, d inputs, r right-hand
sides. Each input byte is read once and each output byte written once,
whatever a kernel reads again. Float32 throughout (4 bytes).

K3 `corr_matvec` (csrc/corr_matvec.cu): c(x*, X) @ [e | A^-1 H], r = 1 + q.
  Per (query, training row) pair: the scaled squared distance (3 d: a
  difference, a product, a sum a dimension), one exp, and r multiply-adds.
K4 "high" `gp_corr_quad_tf32x3` (csrc/corr_quad.cu): |W c(x*)|^2 with W =
  L^-1 lower-triangular. The correlation rebuild on the CUDA cores (3 d + 1
  a pair) and the triangular product on the tensor cores in three TF32
  passes (hi*hi, hi*lo, lo*hi): 2 * m * n (n + 1) / 2 operations each.
"""
from __future__ import annotations

BYTES = 4


def k3(m: int, n: int, d: int, r: int):
    """(float32 operations, bytes) of one K3 call."""
    ops = m * n * (3.0 * d + 1 + 2 * r)
    moved = BYTES * (m * d + n * d + n * r + m * r)
    return ops, moved


def k4_high(m: int, n: int, d: int):
    """(float32 operations, TF32 operations, bytes) of one K4 "high" call."""
    rebuild = m * n * (3.0 * d + 1)
    triangle = m * n * (n + 1.0)
    moved = BYTES * (m * d + n * d + n * (n + 1) / 2 + m)
    return rebuild, 3.0 * triangle, moved


def request_useful_flops(m: int, n: int, d: int, q: int) -> float:
    """Operations a mean-and-variance request needs, each counted once: K3's
    pairs (r = 1 + q), the correlation for the quadratic, the triangular
    product W c once (not its three TF32 passes), and the R-term."""
    k3_ops, _ = k3(m, n, d, 1 + q)
    rebuild, _, _ = k4_high(m, n, d)
    return k3_ops + rebuild + m * n * (n + 1.0) + m * (2.0 * q * q + 4 * q)


def least_seconds(fp32_ops: float, tf32_ops: float, moved: float, peaks: dict):
    """The least time the card could take: the larger of the operations over
    their peaks (CUDA cores and tensor cores overlap) and the bytes over the
    memory bandwidth."""
    return max(fp32_ops / peaks["fp32"], tf32_ops / peaks["tf32"],
               moved / peaks["bytes"])
