"""Data shuffling, scaling and T/V splits (port of `gp_emu_uqsa_tpu.dataio`).

Reference parity: `All_Data`/`Data`/`TV_config` (SURVEY.md S3 "Data
manager"): optional row shuffle, optional min-max scaling of inputs to
[0,1], split rows into a training set and `n_V_sets` validation sets of
n/n_sets rows each, starting at `first_V_set`.

Host-side NumPy, as in the JAX package: arrays become tensors at the
emulator boundary. `load_matrix` reads the reference's whitespace text
matrices with the port's C loader (`native/`), or `np.loadtxt` where no C
compiler exists.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def load_matrix(path) -> np.ndarray:
    """Load a whitespace-separated numeric matrix (reference data format).

    The C parser (`native.load_matrix_native`, one strtod pass) where it
    builds, else np.loadtxt; both with loadtxt's defaults ('#' comments,
    blank lines skipped). Always 2-D float64.
    """
    from gp_emu_uqsa_torch import native

    arr = native.load_matrix_native(path)
    if arr is None:
        arr = np.loadtxt(str(path), dtype=np.float64, ndmin=2)
    return arr


def save_matrix(path, arr) -> None:
    np.savetxt(str(path), np.asarray(arr), fmt="%.12g")


def minmax_scale(x: np.ndarray, minmax: Optional[list] = None):
    """Scale columns to [0,1]; returns (scaled, minmax list).

    When `minmax` is given (e.g. from a written-back beliefs file) it is
    applied rather than recomputed, so a resumed emulator reproduces the
    original scaling exactly (reference checkpoint semantics, SURVEY.md S7.4).
    """
    x = np.asarray(x, dtype=np.float64)
    if minmax is None:
        lo = x.min(axis=0)
        hi = x.max(axis=0)
    else:
        mm = np.asarray(minmax, dtype=np.float64)
        lo, hi = mm[:, 0], mm[:, 1]
    span = np.where(hi > lo, hi - lo, 1.0)
    return (x - lo) / span, [[float(a), float(b)] for a, b in zip(lo, hi)]


def minmax_unscale(xs: np.ndarray, minmax: list) -> np.ndarray:
    mm = np.asarray(minmax, dtype=np.float64)
    lo, hi = mm[:, 0], mm[:, 1]
    return xs * np.where(hi > lo, hi - lo, 1.0) + lo


@dataclasses.dataclass
class DataSplits:
    """Training/validation row partition in reference tv_config terms."""

    x_all: np.ndarray            # (n, d) possibly scaled inputs (active cols)
    y_all: np.ndarray            # (n,)
    order: np.ndarray            # row permutation applied to the raw files
    minmax: Optional[list]       # per-active-dim [lo, hi] or None (unscaled)
    tv_config: tuple[int, int, int]
    v_ranges: list[tuple[int, int]]   # [start, stop) row range per V block
                                      # (V blocks are contiguous at the end)

    @property
    def n(self) -> int:
        return self.x_all.shape[0]

    @property
    def n_v_sets(self) -> int:
        return len(self.v_ranges)

    def v_rows(self, k: int) -> np.ndarray:
        """Row indices of the k-th validation set."""
        start, stop = self.v_ranges[k]
        return np.arange(start, stop)

    def train_rows(self, n_folded: int) -> np.ndarray:
        """Training rows when the first `n_folded` V sets are folded in.

        Rows are laid out [T..., V0, V1, ...], so this is always a prefix.
        """
        if n_folded >= len(self.v_ranges):
            return np.arange(self.n)
        return np.arange(self.v_ranges[n_folded][0])


def make_splits(
    x: np.ndarray,
    y: np.ndarray,
    tv_config: tuple[int, int, int],
    *,
    shuffle: bool = True,
    scale_inputs: bool = True,
    minmax: Optional[list] = None,
    seed: int = 0,
) -> DataSplits:
    """Shuffle / scale / partition rows per the reference tv_config semantics.

    tv_config = (n_sets, first_V_set, n_V_sets): rows are cut into `n_sets`
    equal blocks; blocks first_V_set .. first_V_set+n_V_sets-1 are the
    validation sets, the rest train.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(len(x))
    n = len(x)
    n_sets, first_v, n_v = tv_config
    if n_v >= n_sets:
        raise ValueError("tv_config: n_V_sets must be < n_sets")
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(seed).permutation(n)
    x, y = x[order], y[order]
    if scale_inputs or minmax is not None:
        x, minmax = minmax_scale(x, minmax)
    else:
        minmax = None
    rows_per_set = n // n_sets
    # move the V blocks to the END so "fold V into T" is a prefix extension
    v_blocks = [(first_v + k) % n_sets for k in range(n_v)]
    t_blocks = [b for b in range(n_sets) if b not in v_blocks]
    block_rows = lambda b: list(
        range(b * rows_per_set, (b + 1) * rows_per_set if b < n_sets - 1 else n)
    )
    perm = sum((block_rows(b) for b in t_blocks), []) + sum(
        (block_rows(b) for b in v_blocks), []
    )
    perm = np.asarray(perm)
    x, y, order = x[perm], y[perm], order[perm]
    n_train0 = sum(len(block_rows(b)) for b in t_blocks)
    v_ranges, pos = [], n_train0
    for b in v_blocks:
        size = len(block_rows(b))
        v_ranges.append((pos, pos + size))
        pos += size
    return DataSplits(x, y, order, minmax, tuple(tv_config), v_ranges)
