"""Summation orders of the port's serving kernels, in plain PyTorch on the CPU.

K3 (`csrc/corr_matvec.cu`) cuts n into segments of whole 256-row chunks,
folds each 64-row partial into a Kahan-compensated total and sums the
segments in a second pass; K4 "highest" (`csrc/corr_quad.cu`) may spread a
query tile's factor tiles over several blocks and sum their partials of
quad. `corr_matvec_segmented_plain` and `corr_quad_split_plain` model those
orders. They are held here against fp64 and against the JAX package's
Pallas kernels in interpret mode:

* K3 at n = 4096 with a GP's e = A^-1 (y - ybar), whose entries are large
  and of both signs (the case that made PR 1 compensate the sum): within
  1e-4 absolute of fp64 on the mean column (the fused tier's mean budget,
  `chip_smoke.py` phase 3), and within rtol 2e-4, atol 2e-4 of
  `corr_matvec_pallas` (test_torch_kernels.py's tolerance for serving means
  against JAX): the JAX kernel is itself 1.7e-4 from fp64 here, so the
  budget alone cannot hold the two together;
* K4 "highest" at rtol 5e-4, atol 5e-5 against `corr_quad_pallas`
  (test_torch_kernels.py's tolerance for the tier).
"""
import numpy as np
import pytest
import torch

from gp_emu_uqsa_tpu.ops import serve as jserve

from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops import serve as tserve
from gp_emu_uqsa_torch.tools import cuda_core_variants

torch.set_num_threads(1)

T = torch.as_tensor
MEAN_BUDGET = 1e-4


@pytest.fixture(scope="module")
def gp_rhs():
    """Queries, training inputs, delta, rhs = [e | noise] and the fp64 product."""
    rng = np.random.default_rng(30)
    n, m, d = 4096, 256, 8
    x = rng.uniform(size=(n, d)).astype(np.float32)
    xs = rng.uniform(size=(m, d)).astype(np.float32)
    delta = np.full(d, 0.8, np.float32)
    xd = T(x.astype(np.float64) / delta)
    a = torch.zeros((n, n), dtype=torch.float64)
    for l in range(d):
        t = xd[:, l, None] - xd[None, :, l]
        a.addcmul_(t, t)
    a = torch.exp(-a) + 1e-4 * torch.eye(n, dtype=torch.float64)
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2]
    e = torch.cholesky_solve(T(y - y.mean(), dtype=torch.float64)[:, None],
                             torch.linalg.cholesky(a))[:, 0].numpy()
    del a
    rhs = np.concatenate([e[:, None], rng.standard_normal((n, 9)) / np.sqrt(n)],
                         axis=1).astype(np.float32)
    c64 = torch.exp(-torch.cdist(T(xs.astype(np.float64) / delta), xd) ** 2)
    want64 = (c64 @ T(rhs.astype(np.float64))).numpy()
    jax_out = np.asarray(jserve.corr_matvec_pallas(xs, x, delta, rhs,
                                                   interpret=True))
    return xs, x, delta, rhs, want64, jax_out


@pytest.mark.parametrize("segments", [1, 3, 16])
def test_k3_segmented_order_within_mean_budget(gp_rhs, segments):
    xs, x, delta, rhs, want64, jax_out = gp_rhs
    assert np.abs(rhs[:, 0]).max() > 10.0 and rhs[:, 0].min() < 0 < rhs[:, 0].max()
    got = tserve.corr_matvec_segmented_plain(T(xs), T(x), T(delta), T(rhs),
                                             segments).numpy()
    assert np.abs(got[:, 0] - want64[:, 0]).max() <= MEAN_BUDGET
    np.testing.assert_allclose(got, want64, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got, jax_out, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("tiles", [1, 2, 5, 128, 129])
def test_quad_split_tiles_cover_each_tile_once_in_equal_shares(tiles):
    pairs = (tiles + 1) // 2
    for splits in range(1, pairs + 1):
        walked = [tserve.quad_split_tiles(s, splits, tiles)
                  for s in range(splits)]
        assert sorted(t for w in walked for t in w) == list(range(tiles))
        # work of a tile t: t + 1 chunks of the triangle; a pair's is tiles + 1
        work = [sum(t + 1 for t in w) for w in walked]
        assert max(work) - min(work) <= tiles + 1


def test_quad_splits_fill_the_card_only_when_query_tiles_do_not():
    assert tserve.quad_splits(65536, 16384, 132) == 1
    assert tserve.quad_splits(4096, 16384, 132) == 4
    assert tserve.quad_splits(4097, 16383, 132) == 4
    assert tserve.quad_splits(100, 100, 132) == 1      # one factor tile
    assert tserve.quad_splits(100, 16384, 132) == 32   # at most the pairs


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_k4_split_combine_matches_pallas_highest(splits):
    # n = 1100: five factor tiles of 256, so the middle tile is a pair alone
    n = 1100
    rng = np.random.default_rng(31)
    xs = rng.uniform(size=(150, 4)).astype(np.float32)
    x = rng.uniform(size=(n, 4)).astype(np.float32)
    delta = rng.uniform(0.4, 1.5, size=4).astype(np.float32)
    mmat = rng.standard_normal((n, n))
    w = np.linalg.inv(np.linalg.cholesky(mmat @ mmat.T / n + np.eye(n)))
    w = w.astype(np.float32)
    want = np.asarray(jserve.corr_quad_pallas(xs, x, delta, w, interpret=True,
                                              quad_precision="highest"))
    got = tserve.corr_quad_split_plain(T(xs), T(x), T(delta), T(w),
                                       splits).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(
        got, tserve.corr_quad_plain(T(xs), T(x), T(delta), T(w)).numpy(),
        rtol=5e-4, atol=5e-5)


_VARIANTS = {"corr_quad.cu": cuda_core_variants.QUAD_VARIANTS,
             "corr_matvec.cu": cuda_core_variants.MATVEC_VARIANTS,
             "corr_build.cu": cuda_core_variants.BUILD_VARIANTS}


@pytest.mark.parametrize("source, name", [
    (source, v) for source, variants in _VARIANTS.items()
    for v in sorted(variants)])
def test_cuda_core_variant_edits_match_the_source_once(source, name):
    """Each variant of the card-side timing script edits text that is in
    its source exactly once, so a change to the source cannot leave a
    variant silently equal to the body as built."""
    variants = _VARIANTS[source]
    src = (_build.CSRC / source).read_text()
    for old, new in variants[name][1]:
        assert src.count(old) == 1 and old != new
