"""The port's UQSA (`gp_emu_uqsa_torch.sensitivity`) against the JAX package.

Same numpy inputs into both packages. fp64 on the CPU: the engines run the
same closed forms, except the port's subset log rho (a sum and a difference
of scaled inputs a feature, `_core.Sensitivity._log_rho_sum`) and its
whitened effect-curve variance, so values agree to rounding: rtol 1e-9
with an absolute floor of 1e-12 times the largest value compared. Against
tests/oracle.py's literal fp64 formulas the tolerances of
tests/test_uqsa_oracle.py apply; the golden Sobol decomposition is met at
tests/test_golden_sobol.py's tolerances through the port's own `mle_fit`.
fp32 is held to fp64 within budgets stated where they are used.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import oracle
from gp_emu_uqsa_tpu import gp as jgp
from gp_emu_uqsa_tpu import kernels as jkernels
from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis
from gp_emu_uqsa_tpu.emulator import Emulator as JEmulator
from gp_emu_uqsa_tpu.sensitivity._core import Sensitivity as JSens
import gp_emu_uqsa_tpu.sensitivity as jsens_mod

from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch import kernels as tkernels
from gp_emu_uqsa_torch.basis import BasisSpec, basis_matrix as tbasis
from gp_emu_uqsa_torch.basis import const_basis, linear_basis
from gp_emu_uqsa_torch.emulator import Emulator as TEmulator
from gp_emu_uqsa_torch.inference import MLEConfig, mle_fit
from gp_emu_uqsa_torch.ops.cholesky import spd_inverse_from_chol
from gp_emu_uqsa_torch.sensitivity import Sensitivity as TSens
import gp_emu_uqsa_torch.sensitivity as tsens_mod
from gp_emu_uqsa_torch.tools import uqsa_forms

torch.set_num_threads(1)

RTOL = 1e-9
N, D = 26, 3
NUGGET = 1e-6
DELTA = np.array([0.7, 1.1, 0.5])
M = np.array([0.45, 0.5, 0.6])
V = np.array([0.02, 0.03, 0.015])


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _close(got, want, rtol=RTOL, atol_scale=1e-12):
    got, want = _np(got), np.asarray(want)
    atol = atol_scale * max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _data(n=N, d=D, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(2.5 * x[:, 0]) + 0.8 * x[:, 1] * x[:, 2] + 0.3 * x[:, 2] ** 2
    return x, y


def _pair(spec, fixed_beta=None):
    """(port Sensitivity, JAX Sensitivity) on the same fp64 fit."""
    x, y = _data()
    jp = jkernels.make_params(DELTA, nugget=NUGGET, dtype=jnp.float64)
    tp = tkernels.params_from_numpy(np.asarray(jp.log_delta),
                                    np.asarray(jp.log_sigma2),
                                    np.asarray(jp.log_nugget), device="cpu")
    tx = torch.tensor(x)
    if fixed_beta is None:
        yy, jh, th = y, jbasis(jnp.asarray(x), spec), tbasis(tx, spec)
    else:
        yy = y - np.asarray(jbasis(jnp.asarray(x), spec)) @ fixed_beta
        jh, th = jnp.zeros((N, 0)), torch.zeros((N, 0), dtype=torch.float64)
    jstate = jgp.fit(jp, jnp.asarray(x), jnp.asarray(yy), jh)
    tstate = tgp.fit(tp, tx, torch.tensor(yy), th)
    return (TSens(tstate, x, spec, M, V, beta=fixed_beta),
            JSens(jstate, x, spec, M, V, beta=fixed_beta))


BASES = {
    "linear": (linear_basis(D), None),
    "constant": (const_basis(), None),
    "partial_linear": (BasisSpec(True, (0, 2)), None),
    "fixed_beta": (linear_basis(D), np.array([0.3, 0.5, -0.2, 0.1])),
}


@pytest.mark.parametrize("basis", sorted(BASES))
def test_sensitivity_matches_jax(basis, tmp_path):
    spec, beta = BASES[basis]
    t, j = _pair(spec, beta)
    tu, ju = t.uncertainty(), j.uncertainty()
    for key in ("E_EY", "V_EY", "E_VarY"):
        _close(tu[key], ju[key])
    for name in ("sensitivity", "totaleffectvariance"):
        tr, jr = getattr(t, name)(), getattr(j, name)()
        for key in jr:
            _close(tr[key], jr[key])
    _close(t.sensitivity_variance((0, 1)), j.sensitivity_variance((0, 1)))
    grid = np.random.default_rng(3).uniform(size=(6, 2))
    for a, b in zip(t.effect_curve((0, 2), grid), j.effect_curve((0, 2), grid)):
        _close(a, b, atol_scale=1e-11)
    for a, b in zip(t.main_effect(1, points=9), j.main_effect(1, points=9)):
        _close(a, b, atol_scale=1e-11)
    for a, b in zip(t.interaction_effect(0, 2, points=5),
                    j.interaction_effect(0, 2, points=5)):
        _close(a, b, atol_scale=1e-11)
    t.to_file(tmp_path / "port")
    j.to_file(tmp_path / "jax")
    tl = (tmp_path / "port").read_text().splitlines()
    jl = (tmp_path / "jax").read_text().splitlines()
    assert len(tl) == len(jl) == 4 + D
    assert tl[3] == jl[3] == "input E*(V_i) S_i E*(V_Ti) S_Ti"
    for a, b in zip(tl[:3] + tl[4:], jl[:3] + jl[4:]):
        assert a.split()[0] == b.split()[0]
        _close(np.array(a.split()[1:], float), np.array(b.split()[1:], float),
               rtol=1e-8)


def test_sensitivity_matches_oracle():
    """The port against tests/oracle.py's literal U/S/Q integrals, at
    tests/test_uqsa_oracle.py's tolerances."""
    spec = linear_basis(D)
    t, _ = _pair(spec)
    x, y = _data()
    h_cols = [None] + list(spec.linear_dims)
    args = (x, y, h_cols, DELTA, NUGGET, M, V)
    m0, v0 = oracle.uqsa_uncertainty(*args)
    unc = t.uncertainty()
    np.testing.assert_allclose(float(unc["E_EY"]), m0, rtol=1e-9)
    np.testing.assert_allclose(float(unc["V_EY"]), v0, rtol=1e-7)
    total = oracle.uqsa_sensitivity_variance(*args, tuple(range(D)))
    np.testing.assert_allclose(float(unc["E_VarY"]), total, rtol=1e-6)
    res, tot = t.sensitivity(), t.totaleffectvariance()
    for i in range(D):
        want = oracle.uqsa_sensitivity_variance(*args, (i,))
        np.testing.assert_allclose(float(res["V_i"][i]), want, rtol=1e-6)
        comp = tuple(k for k in range(D) if k != i)
        want_t = total - oracle.uqsa_sensitivity_variance(*args, comp)
        np.testing.assert_allclose(float(tot["V_Ti"][i]), want_t, rtol=1e-5)
    np.testing.assert_allclose(
        float(t.sensitivity_variance((0, 1))),
        oracle.uqsa_sensitivity_variance(*args, (0, 1)), rtol=1e-6)
    grid = np.array([[0.2, 0.4], [0.5, 0.5], [0.9, 0.1]])
    want_m, want_v = oracle.uqsa_effect_curve(*args, (0, 2), grid)
    got_m, got_v = t.effect_curve((0, 2), grid)
    np.testing.assert_allclose(_np(got_m), want_m, rtol=1e-8)
    np.testing.assert_allclose(_np(got_v), want_v, rtol=1e-5,
                               atol=1e-10 * float(t.sigma2))


def test_spd_inverse_from_chol_matches_jax():
    from gp_emu_uqsa_tpu.ops.cholesky import spd_inverse_from_chol as jinv
    a = oracle.corr_self(_data()[0], DELTA, 1e-3)
    la = np.linalg.cholesky(a)
    _close(spd_inverse_from_chol(torch.tensor(la)), jinv(jnp.asarray(la)),
           rtol=1e-8)
    _close(spd_inverse_from_chol(torch.tensor(la)), np.linalg.inv(a), rtol=1e-8)


# ----- setup(raw_space) and marginalized: the facade ----------------------------

def _emulator_pair():
    """A JAX and a port Emulator, fp64, on the same raw-space data (inputs
    on [-1, 2], scaled to [0, 1] by both) and hyperparameters."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 2.0, size=(48, D))
    y = np.sin(1.5 * x[:, 0]) + 0.4 * x[:, 1] * x[:, 2]
    jemul = JEmulator.from_arrays(x, y, tv_config=(4, 0, 1),
                                  dtype=jnp.float64, seed=0)
    temul = TEmulator.from_arrays(x, y, tv_config=(4, 0, 1),
                                  dtype=torch.float64, device="cpu", seed=0)
    jemul.params = jkernels.make_params(DELTA, nugget=1e-4, dtype=jnp.float64)
    temul.params = tkernels.params_from_numpy(
        np.asarray(jemul.params.log_delta), np.asarray(jemul.params.log_sigma2),
        np.asarray(jemul.params.log_nugget), device="cpu")
    jemul.state = jgp.fit(jemul.params, *jemul.train_view())
    temul.state = tgp.fit(temul.params, *temul.train_view())
    return jemul, temul


def test_setup_raw_space_and_marginalized_match_jax():
    jemul, temul = _emulator_pair()
    m_raw, v_raw = np.array([0.4, 0.6, 0.5]), np.array([0.2, 0.3, 0.1])
    t = tsens_mod.setup(temul, m_raw, v_raw, raw_space=True)
    j = jsens_mod.setup(jemul, m_raw, v_raw, raw_space=True)
    _close(t.m, j.m)
    _close(t.v, j.v)
    _close(t.sensitivity()["S_i"], j.sensitivity()["S_i"])
    _close(t.totaleffectvariance()["V_Ti"], j.totaleffectvariance()["V_Ti"])
    # the same fixed draws (log delta, the MLE layout of a mucm fit with a
    # fixed nugget) into both packages: no sampler runs
    draws = np.log(DELTA) + 0.1 * np.random.default_rng(5).standard_normal(
        (2, 3, D))
    tm = tsens_mod.marginalized(temul, M, V, draws, max_draws=3)
    jm = jsens_mod.marginalized(jemul, M, V, draws, max_draws=3)
    assert tm["n_draws"] == jm["n_draws"] == 3
    for key in ("S_i_mean", "S_i_sd", "S_Ti_mean", "S_Ti_sd", "E_EY_mean",
                "E_EY_sd", "E_VarY_mean", "E_VarY_sd", "per_draw_S_i"):
        _close(tm[key], jm[key], rtol=1e-8)


def test_setup_refuses_what_the_integrals_do_not_cover():
    _, temul = _emulator_pair()
    with pytest.raises(ValueError, match="gaussian kernel family"):
        tsens_mod.setup(dataclasses.replace(
            temul, mle_config=dataclasses.replace(temul.mle_config,
                                                  family="matern52")), M, V)
    with pytest.raises(ValueError, match="at most linear"):
        TSens(temul.state, temul.train_view()[0], BasisSpec(True, (0,),
                                                            ((1, 2),)), M, V)
    with pytest.raises(RuntimeError, match="trained"):
        tsens_mod.setup(dataclasses.replace(temul, state=None), M, V)
    with pytest.raises(ValueError, match="shape"):
        tsens_mod.setup(temul, M[:2], V[:2])


# ----- the golden Sobol decomposition through the port's own training ------------

A1, A2, B = 1.0, 0.5, 0.75
V_TOTAL = A1**2 + A2**2 + B**2                   # 1.8125
S1, S2 = A1**2 / V_TOTAL, A2**2 / V_TOTAL        # 16/29, 4/29
ST1, ST2 = (A1**2 + B**2) / V_TOTAL, (A2**2 + B**2) / V_TOTAL


@pytest.fixture(scope="module")
def golden():
    """tests/test_golden_sobol.py's design and simulator (Y = a1 x1 + a2 x2
    + b x1 x2, x ~ N(0, 1)), trained by the port's mle_fit (its own
    starts: the seed of a CPU torch.Generator)."""
    rng = np.random.default_rng(7)
    n = 100
    cols = []
    for _ in range(2):
        strata = (np.arange(n) + rng.uniform(size=n)) / n
        cols.append(rng.permutation(strata))
    x = -3.0 + 6.0 * np.stack(cols, axis=1)
    y = A1 * x[:, 0] + A2 * x[:, 1] + B * x[:, 0] * x[:, 1]
    spec = linear_basis(2)
    tx, ty = torch.tensor(x), torch.tensor(y)
    h = tbasis(tx, spec)
    # 40 L-BFGS iterations: the 1e-8 gradient stop of the default 200 is
    # rarely met, and the best NLL is the same to 7 digits at 40
    params, _ = mle_fit(torch.Generator().manual_seed(0), tx, ty, h,
                        MLEConfig(tries=4, nugget=1e-8, max_iters=40))
    state = tgp.fit(params, tx, ty, h)
    return TSens(state, x, spec, m=np.zeros(2), v=np.ones(2))


def test_golden_first_and_total_indices(golden):
    np.testing.assert_allclose(_np(golden.sensitivity()["S_i"]), [S1, S2],
                               atol=5e-3)
    np.testing.assert_allclose(_np(golden.totaleffectvariance()["S_Ti"]),
                               [ST1, ST2], atol=5e-3)


def test_golden_moments_and_interaction(golden):
    unc = golden.uncertainty()
    assert abs(float(unc["E_EY"])) < 2e-2
    np.testing.assert_allclose(float(unc["E_VarY"]), V_TOTAL, rtol=2e-2)
    v12 = (float(golden.sensitivity_variance((0, 1)))
           - float(golden.sensitivity_variance((0,)))
           - float(golden.sensitivity_variance((1,))))
    np.testing.assert_allclose(v12, B**2, rtol=3e-2, atol=5e-3)


# ----- fp32 against fp64 ----------------------------------------------------------

def _fp32_problem(delta, n=300, d=8):
    x = np.random.default_rng(0).uniform(size=(n, d))
    return x, np.full(d, delta)


# Each entry of an fp32 subset log rho against fp64 at n = 300, d = 8, delta
# 0.8, m 0.5, v 0.02 (all eight dims; |log rho| up to 0.24): the port reads
# 7.0e-8. The JAX package's Gram products read 1.36e-6 on the same input (in
# the test below), and the textbook form over exact differences, the rank-1
# terms added after, 9.4e-7 (`python -m gp_emu_uqsa_torch.tools.uqsa_forms
# --n 300`).
LOG_RHO_FP32_BUDGET = 2e-7


def test_log_rho_forms_agree_in_fp64():
    """The port's log rho, the textbook form over exact differences and the
    Gram products are one function in exact arithmetic: in fp64 they agree
    to rounding, and so do the indices built on them."""
    out = uqsa_forms.run(120, 0.8, 1e-4, torch.device("cpu"))
    lr, res = out[torch.float64, "port"]
    for name in ("differences", "gram"):
        lr_other, res_other = out[torch.float64, name]
        np.testing.assert_allclose(_np(lr_other), _np(lr), rtol=0, atol=1e-13)
        for q in ("V_i", "S_i", "V_Ti", "S_Ti"):
            _close(res_other[q], res[q])


def test_log_rho_sum_fp32_within_budget_of_fp64():
    x, delta = _fp32_problem(0.8)
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x.sum(1)
    m, v = np.full(8, 0.5), np.full(8, 0.02)
    spec = linear_basis(8)
    got = {}
    for dt in (torch.float32, torch.float64):
        tx = torch.tensor(x, dtype=dt)
        p = tkernels.make_params(delta, nugget=1e-4, device="cpu", dtype=dt)
        st = tgp.fit(p, tx, torch.tensor(y, dtype=dt), tbasis(tx, spec))
        got[dt] = TSens(st, tx, spec, m, v)
    for w in ((0,), (2, 5), tuple(range(7)), tuple(range(8))):
        ref = got[torch.float64]._log_rho_sum(w)
        err = float((got[torch.float32]._log_rho_sum(w).double() - ref)
                    .abs().max())
        assert err <= LOG_RHO_FP32_BUDGET, (w, err)
    jx = jnp.asarray(x, jnp.float32)
    jp = jkernels.make_params(delta, nugget=1e-4, dtype=jnp.float32)
    jst = jgp.fit(jp, jx, jnp.asarray(y, jnp.float32), jbasis(jx, spec))
    gram = np.asarray(JSens(jst, x, spec, m, v)._log_rho_sum(tuple(range(8))),
                      np.float64)
    assert np.abs(gram - ref.numpy()).max() > 5 * LOG_RHO_FP32_BUDGET


# The plain self build in fp32 against fp64, entry by entry, at n = 300,
# d = 8 and delta 0.03: the port's exact differences read 1.7e-8; the JAX
# package's matmul expansion leaves 1 - diag(A) at 9.8e-4.
CORR_FP32_BUDGET = 1e-6


def test_plain_self_build_fp32_exact_diagonal():
    x, delta = _fp32_problem(0.03)
    nugget = 1e-4
    a = {}
    for dt in (torch.float32, torch.float64):
        p = tkernels.make_params(delta, nugget=nugget, device="cpu", dtype=dt)
        a[dt] = tkernels.corr_self(torch.tensor(x, dtype=dt), p)
    a32, a64 = a[torch.float32], a[torch.float64]
    np.testing.assert_array_equal(_np(a32.diagonal()),
                                  np.float32(1.0) + np.float32(nugget))
    assert float((a32.double() - a64).abs().max()) <= CORR_FP32_BUDGET
    jp = jkernels.make_params(delta, nugget=nugget, dtype=jnp.float32)
    ja = np.asarray(jkernels.corr_self(jnp.asarray(x, jnp.float32), jp),
                    np.float64)
    assert np.abs(ja - _np(a64)).max() > 100 * CORR_FP32_BUDGET


def test_plain_distance_backward_saves_no_pair_tensor():
    """Autograd through `scaled_sq_dists` keeps its inputs only, no
    (n1, n2) tensor a feature, and its gradients equal those of the
    textbook expression (fp64, rtol 1e-12)."""
    rng = np.random.default_rng(4)
    n1, n2, d, b = 30, 20, 5, 3
    x1 = torch.tensor(rng.uniform(size=(n1, d)), requires_grad=True)
    x2 = torch.tensor(rng.uniform(size=(n2, d)), requires_grad=True)
    delta = torch.tensor(rng.uniform(0.2, 1.5, size=(b, d)),
                         requires_grad=True)
    w = torch.tensor(rng.normal(size=(b, n1, n2)))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        d2 = tkernels.scaled_sq_dists(x1, x2, delta)
    assert saved and max(saved) < n1 * n2
    got = torch.autograd.grad(torch.sum(w * d2), (x1, x2, delta))
    dl = delta[..., None, :]
    ref = torch.sum(((x1 / dl)[..., :, None, :] - (x2 / dl)[..., None, :, :])
                    ** 2, -1)
    np.testing.assert_allclose(_np(d2), _np(ref), rtol=1e-12)
    want = torch.autograd.grad(torch.sum(w * ref), (x1, x2, delta))
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(r), rtol=1e-12, atol=1e-12)
