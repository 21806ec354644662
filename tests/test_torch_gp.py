"""The port's GP core against the JAX package on the same numpy inputs.

fp64 on the CPU: the two packages run the same algorithm through different
LAPACK builds, so values agree to rounding, checked at rtol 1e-9 (with an
absolute floor scaled to each quantity). fp32: the port is held to
tests/test_fp32.py's budgets against the fp64 reference.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from gp_emu_uqsa_tpu import gp as jgp
from gp_emu_uqsa_tpu import basis as jbasis_mod
from gp_emu_uqsa_tpu import kernels as jkernels
from gp_emu_uqsa_tpu.ops import cholesky as jchol

from gp_emu_uqsa_torch import basis as tbasis_mod
from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch import kernels as tkernels
from gp_emu_uqsa_torch.ops import cholesky as tchol

torch.set_num_threads(1)

RTOL = 1e-9


def _close(got, want, rtol=RTOL, atol_scale=1e-12):
    got = np.asarray(got.detach().cpu().numpy() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    atol = atol_scale * max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _tparams(jp, dtype=torch.float64):
    return tkernels.params_from_numpy(
        np.asarray(jp.log_delta), np.asarray(jp.log_sigma2),
        np.asarray(jp.log_nugget), device="cpu", dtype=dtype)


def _problem(n=120, d=3, m=50, seed=0, nugget=1e-6):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x.sum(1)
    xs = rng.uniform(size=(m, d))
    spec = jbasis_mod.linear_basis(d)
    delta = rng.uniform(0.4, 1.2, size=d)
    jp = jkernels.make_params(delta, sigma2=1.7, nugget=nugget,
                              dtype=jnp.float64)
    j = dict(x=jnp.asarray(x), y=jnp.asarray(y), xs=jnp.asarray(xs))
    j["h"] = jbasis_mod.basis_matrix(j["x"], spec)
    j["hs"] = jbasis_mod.basis_matrix(j["xs"], spec)
    t = dict(x=torch.tensor(x), y=torch.tensor(y), xs=torch.tensor(xs))
    t["h"] = tbasis_mod.basis_matrix(t["x"], spec)
    t["hs"] = tbasis_mod.basis_matrix(t["xs"], spec)
    return jp, _tparams(jp), j, t


# ----- kernels and basis ---------------------------------------------------

@pytest.mark.parametrize("family", sorted(jkernels.CORR_FAMILIES))
def test_corr_families_match(family):
    """The port sums exact differences (kernels.scaled_sq_dists); the JAX
    package expands |a|^2 + |b|^2 - 2 a.b, whose self build leaves d2 about
    1e-16 on the diagonal, which the exponential family's square root turns
    into 1 - 3e-8. So the self build is held to the NumPy oracle's exact
    differences everywhere and to JAX off the diagonal, at the same rtol."""
    jp, tp, j, t = _problem()
    _close(tkernels.corr(t["xs"], t["x"], tp, family),
           jkernels.corr(j["xs"], j["x"], jp, family))
    got = tkernels.corr_self(t["x"], tp, family).numpy()
    x, delta, nugget = t["x"].numpy(), tp.delta.numpy(), float(tp.nugget)
    _close(got, oracle.corr_family(x, x, delta, family)
           + nugget * np.eye(len(x)))
    np.testing.assert_array_equal(np.diag(got), 1.0 + nugget)
    off = ~np.eye(len(x), dtype=bool)
    _close(got[off], np.asarray(jkernels.corr_self(j["x"], jp, family))[off])


def test_params_and_basis_match():
    jp = jkernels.make_params([0.3, 2.0], sigma2=0.5, nugget=0.0,
                              dtype=jnp.float64)
    tp = tkernels.make_params([0.3, 2.0], sigma2=0.5, nugget=0.0,
                              device="cpu", dtype=torch.float64)
    for a, b in zip(tp, jp):
        _close(a, b)
    spec = jbasis_mod.parse_basis_strings(["1.0", "x", "x**2", "x[1]^3"],
                                          ["NA", "0", "1", "1"])
    assert tbasis_mod.parse_basis_strings(
        ["1.0", "x", "x**2", "x[1]^3"], ["NA", "0", "1", "1"]) == spec
    assert tbasis_mod.basis_strings(spec) == jbasis_mod.basis_strings(spec)
    x = np.random.default_rng(1).uniform(size=(7, 2))
    _close(tbasis_mod.basis_matrix(torch.tensor(x), spec),
           jbasis_mod.basis_matrix(jnp.asarray(x), spec))
    with pytest.raises(ValueError, match="basis references input dim"):
        tbasis_mod.basis_matrix(torch.tensor(x), tbasis_mod.linear_basis(3))


# ----- the jitter ladder ---------------------------------------------------

def _indefinite(n, k, shift, seed=2):
    """Rank-k PSD plus shift * I: indefinite for shift < 0."""
    z = np.random.default_rng(seed).standard_normal((n, k))
    return z @ z.T + shift * np.eye(n)


@pytest.mark.parametrize("a", [
    _indefinite(40, 60, 0.0),          # healthy: probe succeeds, jitter 0
    _indefinite(40, 10, -1e-10),       # first rung
    _indefinite(40, 10, -1e-7),        # a few rungs up
    _indefinite(40, 10, -1e3),         # every rung fails: NaN factor
], ids=["healthy", "first-rung", "later-rung", "total-failure"])
def test_cholesky_with_jitter_takes_the_same_rung(a):
    jl, jjit = jchol.cholesky_with_jitter(jnp.asarray(a))
    tl, tjit = tchol.cholesky_with_jitter(torch.tensor(a))
    _close(tjit, jjit, rtol=1e-12, atol_scale=0.0)
    if np.isnan(np.asarray(jl)).any():
        assert torch.isnan(tl).all()
        return
    assert torch.isfinite(tl).all()
    # the factor of the successful rung: near a singular matrix its trailing
    # entries depend on the LAPACK build, so hold its product, not its entries
    want = a + float(jjit) * np.eye(len(a))
    _close(tl @ tl.T, want, atol_scale=1e-12)
    if float(jjit) == 0.0:
        _close(tl, jl)


def test_duplicated_rows_tiny_nugget_ladder_and_no_nan():
    """Exactly duplicated rows with nugget 1e-12 in fp32: the probe fails in
    both packages and both take the first rung (2n * 1e-6 * mean diag).
    The NLL is then an fp32 value of a matrix with condition ~1/jitter:
    held at rtol 1e-4."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(40, 3))
    xd = np.concatenate([x, x]).astype(np.float32)
    yd = (np.sin(3 * xd[:, 0]) + xd[:, 1]).astype(np.float32)
    jp = jkernels.make_params(np.full(3, 0.7), nugget=1e-12, dtype=jnp.float32)
    tp = _tparams(jp, torch.float32)
    jx, tx = jnp.asarray(xd), torch.tensor(xd)
    jh = jbasis_mod.basis_matrix(jx, jbasis_mod.linear_basis(3))
    th = tbasis_mod.basis_matrix(tx, tbasis_mod.linear_basis(3))
    _, jjit = jchol.cholesky_with_jitter(jkernels.corr_self(jx, jp))
    tl, tjit = tchol.cholesky_with_jitter(tkernels.corr_self(tx, tp))
    assert float(jjit) > 0.0 and float(tjit) == float(jjit)
    assert torch.isfinite(tl).all()
    jn = jgp.nll(jp, jx, jnp.asarray(yd), jh)
    tn = tgp.nll(tp, tx, torch.tensor(yd), th)
    assert torch.isfinite(tn)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-4)


@pytest.mark.parametrize("ladder", [True, False])
def test_failed_factorization_gives_inf_not_a_finite_nll(ladder):
    """cholesky_ex returns a partial factor with no NaN; the port must read
    `info`, or a finite, wrong NLL gets past the guard."""
    jp, tp, j, t = _problem(n=30)
    noise = np.zeros(30)
    noise[7] = -2.0                    # a_77 = 1 + nugget - 2 < 0
    for mode in ("mucm", "gp4ml"):
        jn = jgp.nll(jp, j["x"], j["y"], j["h"], mode=mode,
                     noise_diag=jnp.asarray(noise), ladder=ladder)
        tn = tgp.nll(tp, t["x"], t["y"], t["h"], mode=mode,
                     noise_diag=torch.tensor(noise), ladder=ladder)
        assert np.isinf(float(jn)) and float(jn) > 0
        assert torch.isinf(tn) and tn > 0


def test_too_few_points_gives_inf_nll():
    jp, tp, j, t = _problem(n=5, d=3)      # n - q - 2 = -1
    jn = jgp.nll(jp, j["x"], j["y"], j["h"])
    tn = tgp.nll(tp, t["x"], t["y"], t["h"])
    assert np.isinf(float(jn)) and torch.isinf(tn)
    with pytest.raises(ValueError, match="likelihood mode"):
        tgp.nll(tp, t["x"], t["y"], t["h"], mode="bogus")


# ----- fit, predict, serve, validate ---------------------------------------

@pytest.mark.parametrize("mode", ["mucm", "gp4ml"])
def test_fit_and_nll_match(mode):
    jp, tp, j, t = _problem()
    js = jgp.fit(jp, j["x"], j["y"], j["h"], mode=mode)
    ts = tgp.fit(tp, t["x"], t["y"], t["h"], mode=mode)
    for field in ("lg", "beta", "sigma2", "jitter", "nll"):
        _close(getattr(ts, field), getattr(js, field))
    # entries of L near 0 carry absolute rounding of the O(1) pivots
    _close(ts.l, js.l, atol_scale=1e-10)
    # e and A^-1 H carry kappa(A) (nugget 1e-6): held to the solve's scale
    _close(ts.e, js.e, rtol=1e-7, atol_scale=1e-8)
    _close(ts.ainv_h, js.ainv_h, rtol=1e-7, atol_scale=1e-8)
    _close(tgp.nll(tp, t["x"], t["y"], t["h"], mode=mode),
           jgp.nll(jp, j["x"], j["y"], j["h"], mode=mode))
    # one refinement sweep (the port's residual is an fp64 product)
    js1 = jgp.fit(jp, j["x"], j["y"], j["h"], mode=mode, refine=1)
    ts1 = tgp.fit(tp, t["x"], t["y"], t["h"], mode=mode, refine=1)
    _close(ts1.beta, js1.beta)
    _close(ts1.e, js1.e, rtol=1e-7, atol_scale=1e-8)
    _close(ts1.ainv_h, js1.ainv_h, rtol=1e-7, atol_scale=1e-8)


@pytest.mark.parametrize("include_nugget", [False, True])
def test_predict_and_full_cov_match(include_nugget):
    jp, tp, j, t = _problem(nugget=1e-4)
    js = jgp.fit(jp, j["x"], j["y"], j["h"])
    ts = tgp.fit(tp, t["x"], t["y"], t["h"])
    for full_cov in (False, True):
        jm, jv = jgp.predict(js, j["x"], j["h"], j["xs"], j["hs"],
                             full_cov=full_cov, include_nugget=include_nugget)
        tm, tv = tgp.predict(ts, t["x"], t["h"], t["xs"], t["hs"],
                             full_cov=full_cov, include_nugget=include_nugget)
        _close(tm, jm, rtol=1e-8)
        _close(tv, jv, rtol=1e-7, atol_scale=1e-10)


def test_predictor_predict_fast_and_batched_match():
    jp, tp, j, t = _problem(nugget=1e-4, m=70)
    js = jgp.fit(jp, j["x"], j["y"], j["h"])
    ts = tgp.fit(tp, t["x"], t["y"], t["h"])
    jpred, tpred = jgp.predictor(js), tgp.predictor(ts)
    for field in ("beta", "w_chol", "sigma2"):
        _close(getattr(tpred, field), getattr(jpred, field), rtol=1e-8)
    # W = L^-1 carries kappa(L) (nugget 1e-4) in its small entries
    _close(tpred.linv, jpred.linv, rtol=1e-8, atol_scale=1e-10)
    jm, jv = jgp.predict_fast(jpred, j["x"], j["xs"], j["hs"])
    for quad_precision in ("highest", "high"):
        tm, tv = tgp.predict_fast(tpred, t["x"], t["xs"], t["hs"],
                                  quad_precision=quad_precision)
        _close(tm, jm, rtol=1e-8)
        _close(tv, jv, rtol=1e-7, atol_scale=1e-10)
    bm, bv = tgp.predict_batched(tpred, t["x"], t["xs"], t["hs"], batch=32)
    _close(bm, jm, rtol=1e-8)
    _close(bv, jv, rtol=1e-7, atol_scale=1e-10)
    with pytest.raises(ValueError, match="quad_precision"):
        tgp.predict_fast(tpred, t["x"], t["xs"], t["hs"], quad_precision="x")


def test_validate_and_loo_match():
    jp, tp, j, t = _problem(nugget=1e-4, m=30)
    js = jgp.fit(jp, j["x"], j["y"], j["h"])
    ts = tgp.fit(tp, t["x"], t["y"], t["h"])
    yv = np.cos(np.asarray(j["xs"]).sum(1))
    jd = jgp.validate(js, j["x"], j["h"], j["xs"], j["hs"], jnp.asarray(yv))
    td = tgp.validate(ts, t["x"], t["h"], t["xs"], t["hs"], torch.tensor(yv))
    assert set(td) == set(jd)
    for k in jd:
        _close(td[k], jd[k], rtol=1e-7)
    jlm, jlv = jgp.loo_diagnostics(js, j["x"], j["h"], j["y"])
    tlm, tlv = tgp.loo_diagnostics(ts, t["x"], t["h"], t["y"])
    _close(tlm, jlm, rtol=1e-7)
    _close(tlv, jlv, rtol=1e-7, atol_scale=1e-10)


def test_fp32_fit_predict_within_budget():
    """tests/test_fp32.py::test_fit_predict_fp32_vs_fp64 budgets: mean 1e-3
    of its scale, sigma2 rtol 1e-2, variance 1e-2 of sigma2."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(60, 2)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + x[:, 1] ** 2).astype(np.float32)
    xs = np.random.default_rng(1).uniform(size=(25, 2)).astype(np.float32)
    spec = jbasis_mod.linear_basis(2)
    jp = jkernels.make_params(np.array([0.6, 1.0]), nugget=1e-4,
                              dtype=jnp.float64)
    js = jgp.fit(jp, jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
                 jbasis_mod.basis_matrix(jnp.asarray(x, jnp.float64), spec))
    jm, jv = jgp.predict(js, jnp.asarray(x, jnp.float64),
                         jbasis_mod.basis_matrix(jnp.asarray(x, jnp.float64), spec),
                         jnp.asarray(xs, jnp.float64),
                         jbasis_mod.basis_matrix(jnp.asarray(xs, jnp.float64), spec))
    tp = _tparams(jp, torch.float32)
    tx, ty, txs = torch.tensor(x), torch.tensor(y), torch.tensor(xs)
    th, ths = tbasis_mod.basis_matrix(tx, spec), tbasis_mod.basis_matrix(txs, spec)
    ts = tgp.fit(tp, tx, ty, th)
    assert ts.l.dtype == torch.float32
    s2 = float(js.sigma2)
    np.testing.assert_allclose(float(ts.sigma2), s2, rtol=1e-2)
    for tm, tv in (tgp.predict(ts, tx, th, txs, ths),
                   tgp.predict_fast(tgp.predictor(ts), tx, txs, ths)):
        jm_np = np.asarray(jm)
        assert np.max(np.abs(tm.numpy() - jm_np)) / np.abs(jm_np).max() < 1e-3
        assert np.max(np.abs(tv.numpy() - np.asarray(jv))) / s2 < 1e-2
