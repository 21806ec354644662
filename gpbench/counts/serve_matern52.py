"""Operations and bytes of the Matern 5/2 instances of the serving kernels
and of a Matern 5/2 request, and the device time of those instances.

As `counts/serve.py`, with the Matern rebuild in place of the Gaussian's.
Per (query, training point) pair, the rebuild (csrc/common.cuh::Matern52)
counts 3 d + 8 operations: the scaled squared distance (3 d: a difference,
a product, a sum a dimension), the root, its scale by sqrt(5), the exp
(one each, as counts/serve.py counts the Gaussian's exp), the polynomial
1 + s + (s / 3) s (three) and the product with the exp (one).

K3 `gp_corr_matvec_matern52`: the rebuild and r multiply-adds a pair.
K4 "high" `gp_corr_quad_tf32x3_matern52`: the rebuild on the CUDA cores and
the triangular product in three TF32 passes, 2 m n (n + 1) / 2 each; bytes
as the Gaussian's (each input read once, quad written once).
"""
from __future__ import annotations

from gpbench.counts import serve

FAMILY = "Matern52"   # the template argument in the kernels' names
least_seconds = serve.least_seconds


def rebuild_ops(d: int) -> float:
    """Operations of one Matern 5/2 correlation entry."""
    return 3.0 * d + 8


def k3(m: int, n: int, d: int, r: int):
    """(float32 operations, bytes) of one K3 call."""
    _, moved = serve.k3(m, n, d, r)
    return m * n * (rebuild_ops(d) + 2 * r), moved


def k4_high(m: int, n: int, d: int):
    """(float32 operations, TF32 operations, bytes) of one K4 "high" call."""
    _, tf32, moved = serve.k4_high(m, n, d)
    return m * n * rebuild_ops(d), tf32, moved


def request_useful_flops(m: int, n: int, d: int, q: int) -> float:
    """Operations a mean-and-variance request needs, each counted once: K3's
    pairs (r = 1 + q), the correlation for the quadratic, the triangular
    product W c once, and the R-term."""
    k3_ops, _ = k3(m, n, d, 1 + q)
    return (k3_ops + m * n * rebuild_ops(d) + m * n * (n + 1.0)
            + m * (2.0 * q * q + 4 * q))


def family_seconds(reduced, body: str, shared: tuple) -> float:
    """Device seconds of the Matern 5/2 instance of the kernel `body` (its
    name holds both), plus those of the family-free kernels `shared` that
    serve it; 0 where the trace holds no such instance."""
    if reduced is None:
        return 0.0
    kernel_s = reduced["kernel_s"]
    own = sum(s for k, s in kernel_s.items() if body in k and FAMILY in k)
    if own <= 0:
        return 0.0
    return own + sum(s for k, s in kernel_s.items()
                     if any(name in k for name in shared))
