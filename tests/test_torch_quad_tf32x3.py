"""K4's "high" tier in the PyTorch port: the 3xTF32 arithmetic of the tensor-core body.

On the card `corr_quad(..., quad_precision="high")` runs a wgmma kernel that
splits c and W into TF32 hi and lo parts and sums c_hi W_hi + c_hi W_lo +
c_lo W_hi in fp32 (`csrc/corr_quad.cu`). `corr_quad_tf32x3_plain` is that
arithmetic in plain PyTorch. Here on the CPU it is held against the split's
rounding properties, an fp64 evaluation of the same W and c (the tier's
4.7e-5 absolute budget on quad, docs/numerics.md) and the JAX package's
"high" Pallas tier in interpret mode (rtol 1e-3, atol 1e-4, as
test_torch_kernels.py). The `cuda` case holds the kernel against it on the
card and skips elsewhere.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from gp_emu_uqsa_tpu.ops import serve as jserve

from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops import serve as tserve
from gp_emu_uqsa_torch.tools import k4_high_variants

torch.set_num_threads(1)

T = torch.as_tensor
QUAD_HIGH_BUDGET = 4.7e-5          # docs/numerics.md, "high" tier on quad
# Half a TF32 step among the subnormals (2^-149 * 2^13 / 2): below 2^-103 the
# remainder x - hi can be subnormal, where TF32 keeps no relative precision.
SUBNORMAL_SLACK = 2.0 ** -137


def _bits(v: torch.Tensor) -> np.ndarray:
    return v.contiguous().view(torch.int32).numpy().view(np.uint32)


def _check_split(x: np.ndarray) -> None:
    hi, lo = tserve.tf32_split(T(x))
    for part in (hi, lo):
        assert not (_bits(part) & 0x1FFF).any(), "low 13 mantissa bits not zero"
    x64 = x.astype(np.float64)
    hi64 = hi.numpy().astype(np.float64)
    lo64 = lo.numpy().astype(np.float64)
    ax = np.abs(x64)
    assert (np.abs(x64 - hi64 - lo64) <= 2.0 ** -22 * ax + SUBNORMAL_SLACK).all()
    assert (np.abs(lo64) <= 2.0 ** -11 * ax + SUBNORMAL_SLACK).all()
    normal = ax >= 2.0 ** -103
    assert (np.abs(x64 - hi64 - lo64)[normal] <= 2.0 ** -22 * ax[normal]).all()
    assert (np.abs(lo64)[normal] <= 2.0 ** -11 * ax[normal]).all()
    # hi is x rounded to the nearest TF32 value
    assert (np.abs(x64 - hi64) <= 2.0 ** -11 * ax + SUBNORMAL_SLACK).all()


def _split_grid(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    spread = (rng.uniform(-1, 1, 4000)
              * 2.0 ** rng.integers(-140, 120, 4000)).astype(np.float32)
    bits = rng.integers(0, 2 ** 32, 2000, dtype=np.uint64).astype(np.uint32)
    raw = bits.view(np.float32)
    raw = raw[np.isfinite(raw) & (np.abs(raw) < 3e38)]
    # exact ties and their neighbours: low 13 bits 0x1000, 0x0fff, 0x1001
    base = rng.integers(0x00800000, 0x7E000000, 500, dtype=np.int64)
    base = (base & ~0x1FFF).astype(np.uint32)
    near = np.concatenate([base | 0x1000, base | 0x0FFF, base | 0x1001])
    near = np.concatenate([near, near | 0x80000000]).view(np.float32)
    subnormal = (rng.integers(1, 0x007FFFFF, 500).astype(np.uint32)
                 | rng.choice(np.array([0, 0x80000000], np.uint32), 500))
    special = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** -126, 3.4e38, -3.4e38,
                        1.0 + 2.0 ** -11, 1.0 - 2.0 ** -12], np.float32)
    return np.concatenate([spread, raw, near, subnormal.view(np.float32),
                           special]).astype(np.float32)


def test_tf32_split_grid_rounds_and_reproduces():
    _check_split(_split_grid())


def test_tf32_split_rounds_ties_away_from_zero():
    # 1 + 2^-11 sits halfway between the TF32 neighbours 1 and 1 + 2^-10
    x = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                  np.nextafter(np.float32(1.0 + 2.0 ** -11), np.float32(0))],
                 np.float32)
    hi, lo = tserve.tf32_split(T(x))
    np.testing.assert_array_equal(
        hi.numpy(), np.array([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0],
                             np.float32))
    # the remainder of a tie is exact in TF32
    np.testing.assert_array_equal(hi.numpy()[:2] + lo.numpy()[:2], x[:2])


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False, allow_infinity=False,
                          max_value=2.0 ** 127, min_value=-2.0 ** 127),
                min_size=1, max_size=64))
def test_tf32_split_property(values):
    _check_split(np.array(values, np.float32))


def _inputs(seed, m, n, d):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(size=(m, d)).astype(np.float32)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    delta = rng.uniform(0.4, 1.5, size=d).astype(np.float32)
    return rng, xs, x, delta


def _gp_inverse_factor(x, delta, nugget):
    """W = L^-1 of the correlation matrix of x (fp64 factor, fp32 result)."""
    xd = x.astype(np.float64) / delta
    a = np.exp(-((xd[:, None, :] - xd[None, :, :]) ** 2).sum(-1))
    a += nugget * np.eye(len(x))
    return np.linalg.inv(np.linalg.cholesky(a)).astype(np.float32)


def test_tf32x3_plain_within_budget_of_fp64():
    # a GP's own W (nugget 1e-2, as tests/test_torch_kernels.py's serving
    # fits): quad = t^T A^-1 t in [0, 1], where the budget is defined
    _, xs, x, delta = _inputs(20, 300, 600, 4)
    w = _gp_inverse_factor(x, delta, 1e-2)
    got = tserve.corr_quad_tf32x3_plain(T(xs), T(x), T(delta), T(w)).numpy()
    # fp64 evaluation of the same fp32 W and c
    c = km.sq_exp_plain(*tserve._scaled(T(xs), T(x), T(delta))).double()
    u = c @ torch.tril(T(w).double()).T
    want = torch.sum(u * u, dim=1).numpy()
    assert 0.0 < want.max() <= 1.0 + 1e-4
    err = np.abs(got - want).max()
    assert err <= QUAD_HIGH_BUDGET, err


def test_tf32x3_plain_matches_pallas_high_and_skips_upper_triangle():
    # the shapes of test_k4_corr_quad_matches_pallas: n spans two TPU factor
    # tiles, so its triangular skip runs
    rng, xs, x, delta = _inputs(4, 150, 600, 4)
    mmat = rng.standard_normal((600, 600))
    w = np.linalg.inv(np.linalg.cholesky(mmat @ mmat.T / 600 + np.eye(600)))
    w = w.astype(np.float32)
    want = np.asarray(jserve.corr_quad_pallas(xs, x, delta, w, interpret=True,
                                              quad_precision="high"))
    got = tserve.corr_quad_tf32x3_plain(T(xs), T(x), T(delta), T(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    # the strict upper triangle is never read
    w_dirty = w + np.triu(rng.standard_normal(w.shape), 1).astype(np.float32)
    got_dirty = tserve.corr_quad_tf32x3_plain(T(xs), T(x), T(delta),
                                              T(w_dirty)).numpy()
    np.testing.assert_array_equal(got_dirty, got)


@pytest.mark.parametrize("name", sorted(k4_high_variants.VARIANTS))
def test_k4_variant_edits_match_the_source_once(name):
    """Each variant of the card-side timing script edits corr_quad.cu text
    that is there exactly once, so a change to the source cannot leave a
    variant silently equal to the body as built."""
    src = (_build.CSRC / "corr_quad.cu").read_text()
    for old, new in k4_high_variants.VARIANTS[name][1]:
        assert src.count(old) == 1 and old != new


@pytest.mark.cuda
def test_cuda_corr_quad_high_matches_tf32x3_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    _, xs, x, delta = _inputs(21, 300, 700, 8)
    w = _gp_inverse_factor(x, delta, 1e-2)
    args = [T(v, device=dev) for v in (xs, x, delta, w)]
    before = tserve.corr_quad.launches
    got = tserve.corr_quad(*args, quad_precision="high")
    assert tserve.corr_quad.launches == before + 1
    # same TF32 operands on both sides; only the fp32 summation order differs
    torch.testing.assert_close(got, tserve.corr_quad_tf32x3_plain(*args),
                               rtol=5e-4, atol=5e-5)
