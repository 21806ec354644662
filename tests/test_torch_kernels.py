"""K1-K4 of the PyTorch port against the JAX package's Pallas kernels.

The JAX kernels run in interpret mode on the CPU, as tests/test_pallas_kernels.py
runs them; the port's wrappers run their plain PyTorch versions on CPU
tensors. Same numpy inputs, fp32 on both sides, and that file's tolerances:
K1/K2 rtol 2e-5 / atol 2e-6, K3 3e-5, K4 5e-5 ("highest") and 1e-4 ("high")
absolute with rtol 5e-4 / 1e-3 — both are fp32 algorithms summing in
different orders. The `cuda` cases hold each CUDA kernel against its plain
version on the card and skip elsewhere.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu import gp as jgp
from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis, linear_basis
from gp_emu_uqsa_tpu.kernels import make_params as jparams
from gp_emu_uqsa_tpu.ops import serve as jserve
from gp_emu_uqsa_tpu.ops.kernel_matrix import (
    gaussian_corr_pallas, gaussian_corr_self_pallas,
)

from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch.basis import basis_matrix as tbasis
from gp_emu_uqsa_torch.kernels import params_from_numpy
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops import serve as tserve

torch.set_num_threads(1)

T = torch.as_tensor


def _inputs(seed, m, n, d):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(size=(m, d)).astype(np.float32)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    delta = rng.uniform(0.4, 1.5, size=d).astype(np.float32)
    return rng, xs, x, delta


def test_k1_self_build_matches_pallas():
    rng, _, x, delta = _inputs(0, 1, 300, 5)        # n not tile-aligned
    nugget = 1e-4
    want = np.asarray(gaussian_corr_self_pallas(x, delta, nugget,
                                                interpret=True))
    got = km.gaussian_corr_self_fused(T(x), T(delta), nugget).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    # difference-form distance: exactly symmetric, exact unit diagonal
    np.testing.assert_array_equal(got, got.T)
    np.testing.assert_array_equal(np.diag(got), np.float32(1.0 + nugget))


def test_k2_cross_build_matches_pallas():
    _, x1, x2, delta = _inputs(1, 257, 300, 4)      # m != n
    want = np.asarray(gaussian_corr_pallas(x1, x2, delta, interpret=True))
    got = km.gaussian_corr_fused(T(x1), T(x2), T(delta)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    with pytest.raises(ValueError, match="feature dims differ"):
        km.gaussian_corr_fused(T(x1), T(x2[:, :3]), T(delta))


@pytest.mark.parametrize("r", [1, 5, 10])
def test_k3_corr_matvec_matches_pallas(r):
    rng, xs, x, delta = _inputs(2, 513, 300, 3)     # nothing tile-aligned
    rhs = rng.standard_normal((300, r)).astype(np.float32)
    want = np.asarray(jserve.corr_matvec_pallas(xs, x, delta, rhs,
                                                interpret=True))
    got = tserve.corr_matvec(T(xs), T(x), T(delta), T(rhs)).numpy()
    assert got.shape == (513, r)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def test_k3_vector_rhs_round_trips_shape():
    rng, xs, x, delta = _inputs(3, 77, 120, 3)
    rhs = rng.standard_normal(120).astype(np.float32)
    want = np.asarray(jserve.corr_matvec_pallas(xs, x, delta, rhs,
                                                interpret=True))
    got = tserve.corr_matvec(T(xs), T(x), T(delta), T(rhs)).numpy()
    assert got.shape == (77,)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    with pytest.raises(ValueError, match="rhs width"):
        tserve.corr_matvec(T(xs), T(x), T(delta), torch.zeros(120, 129))


def _spd_inverse_factor(rng, n):
    mmat = rng.standard_normal((n, n))
    a = mmat @ mmat.T / n + np.eye(n)
    return np.linalg.inv(np.linalg.cholesky(a)).astype(np.float32)


@pytest.mark.parametrize("tier, rtol, atol", [("highest", 5e-4, 5e-5),
                                              ("high", 1e-3, 1e-4)])
def test_k4_corr_quad_matches_pallas(tier, rtol, atol):
    # n spans two of the TPU kernel's factor tiles, so its triangular skip
    # runs; the port's loop skips the same j > k entries
    rng, xs, x, delta = _inputs(4, 150, 600, 4)
    w = _spd_inverse_factor(rng, 600)
    want = np.asarray(jserve.corr_quad_pallas(xs, x, delta, w, interpret=True,
                                              quad_precision=tier))
    got = tserve.corr_quad(T(xs), T(x), T(delta), T(w),
                           quad_precision=tier).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    # the strict upper triangle is never read
    w_dirty = w + np.triu(rng.standard_normal(w.shape), 1).astype(np.float32)
    got_dirty = tserve.corr_quad(T(xs), T(x), T(delta), T(w_dirty),
                                 quad_precision=tier).numpy()
    np.testing.assert_array_equal(got_dirty, got)


def _fitted(seed=13, n=90, d=3, m=270):
    """One fp32 fit on both sides from the same numpy data."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2]).astype(np.float32)
    xs = rng.uniform(size=(m, d)).astype(np.float32)
    spec = linear_basis(d)
    # nugget 1e-2 keeps the variances above the fp32 rounding floor of both
    # paths (test_pallas_kernels.py::test_serve_meanvar_pallas_matches_predict_fast)
    jp = jparams(np.full(d, 0.7, np.float32), nugget=1e-2, dtype=jnp.float32)
    jstate = jgp.fit(jp, jnp.asarray(x), jnp.asarray(y),
                     jbasis(jnp.asarray(x), spec))
    tp = params_from_numpy(np.asarray(jp.log_delta), np.asarray(jp.log_sigma2),
                           np.asarray(jp.log_nugget), device="cpu",
                           dtype=torch.float32)
    tstate = tgp.fit(tp, T(x), T(y), tbasis(T(x), spec))
    return (x, xs, spec, jgp.predictor(jstate),
            tserve.serve_predictor(tstate), float(jstate.sigma2))


def test_serve_meanvar_matches_pallas_and_batches():
    x, xs, spec, jpred, tpred, s2 = _fitted()
    hs = np.array(jbasis(jnp.asarray(xs), spec))
    jm, jv = jserve.serve_meanvar_pallas(jpred, jnp.asarray(x), jnp.asarray(xs),
                                         jnp.asarray(hs), interpret=True)
    tm, tv = tserve.serve_meanvar(tpred, T(x), T(xs), T(hs))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2e-2,
                               atol=5e-4 * s2)
    # the host loop over chunks (m % batch != 0) == one shot
    bm, bv = tserve.serve_meanvar_batched(tpred, T(x), T(xs), T(hs), batch=128)
    np.testing.assert_allclose(bm.numpy(), tm.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(bv.numpy(), tv.numpy(), rtol=2e-3,
                               atol=1e-5 * s2)


def test_serve_mean_matches_pallas_and_batches():
    x, xs, spec, jpred, tpred, _ = _fitted(seed=5, n=60, m=333)
    hs = np.array(jbasis(jnp.asarray(xs), spec))
    want = np.asarray(jserve.serve_mean_pallas(
        jpred, jnp.asarray(x), jnp.asarray(xs), jnp.asarray(hs),
        interpret=True))
    got = tserve.serve_mean(tpred, T(x), T(xs), T(hs)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    got_b = tserve.serve_mean_batched(tpred, T(x), T(xs), T(hs), batch=128)
    assert got_b.shape == (333,)
    np.testing.assert_allclose(got_b.numpy(), got, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version (skips elsewhere)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_builds_match_plain(cuda_device):
    _, x1, x2, delta = _inputs(6, 700, 1030, 8)
    a, b, dl = T(x1, device=cuda_device), T(x2, device=cuda_device), T(
        delta, device=cuda_device)
    before = km.gaussian_corr_self_fused.launches
    got = km.gaussian_corr_self_fused(b, dl, 1e-4)
    assert km.gaussian_corr_self_fused.launches == before + 1
    torch.testing.assert_close(got, km.gaussian_corr_self_plain(b, dl, 1e-4),
                               rtol=2e-5, atol=2e-6)
    assert torch.equal(got, got.T)
    torch.testing.assert_close(km.gaussian_corr_fused(a, b, dl),
                               km.gaussian_corr_plain(a, b, dl),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 10, 33])
def test_cuda_corr_matvec_matches_plain(cuda_device, r):
    rng, xs, x, delta = _inputs(7, 1000, 777, 8)
    rhs = rng.standard_normal((777, r)).astype(np.float32)
    args = [T(v, device=cuda_device) for v in (xs, x, delta, rhs)]
    torch.testing.assert_close(tserve.corr_matvec(*args),
                               tserve.corr_matvec_plain(*args),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("tier, rtol, atol", [("highest", 5e-4, 5e-5),
                                              ("high", 1e-3, 1e-4)])
def test_cuda_corr_quad_matches_plain(cuda_device, tier, rtol, atol):
    rng, xs, x, delta = _inputs(8, 300, 700, 8)
    w = _spd_inverse_factor(rng, 700)
    args = [T(v, device=cuda_device) for v in (xs, x, delta, w)]
    torch.testing.assert_close(tserve.corr_quad(*args, quad_precision=tier),
                               tserve.corr_quad_plain(*args),
                               rtol=rtol, atol=atol)
