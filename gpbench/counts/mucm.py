"""Operations of one value and gradient of the concentrated (MUCM) NLL.

For one hyperparameter vector (one chain of a batched log density, one
restart of a batched fit) at n training rows, d inputs and q basis
columns, counted from the algorithm's shapes with the usual dense counts:

  build A           n (n + 1) / 2 pairs x (3 d + 1)   (distance, exp; symmetric)
  Cholesky of A     n^3 / 3
  forward solves    n^2 (1 + q)                      (L^-1 [y | H])
  G, beta, resid    2 n q^2 + 4 n q
  backward solve    n^2                              (e = L^-T white)
  adjoint: L^-1     n^3 / 3
           A^-1     n^3 / 3                          (L^-T L^-1, symmetric)
           A^-1 H   n^2 q
           W        n^2 (2 q + 4)                    (the three terms, then W * A)
           dlogdelta  n^2 3 d                          (the exact-difference contraction)
"""
from __future__ import annotations


def value_and_grad_flops(n: int, d: int, q: int) -> float:
    n = float(n)
    return (n * (n + 1) / 2 * (3 * d + 1) + n ** 3 / 3 + n * n * (1 + q)
            + 2 * n * q * q + 4 * n * q + n * n + 2 * n ** 3 / 3
            + n * n * q + n * n * (2 * q + 4) + n * n * 3 * d)


def mfu_pct(record: dict, peaks, chips: int):
    """The operations of a window's evaluations (the sampler's batched
    evaluations, `counts["evaluations"]`, times the chains each holds) over
    the window's seconds times the cards' TF32 peak, in %."""
    evaluations = record["counts"].get("evaluations", 0)
    if peaks is None or not evaluations:
        return None
    ops = evaluations * record["chains"] * value_and_grad_flops(
        record["n"], record["d"], record["q"])
    return 100.0 * ops / (record["window_s"] * chips * peaks["tf32"])
