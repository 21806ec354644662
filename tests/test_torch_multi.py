"""Multi-output emulation in the port against the JAX package.

`gp.nll` with y carrying the restarts' batch axis, (B, n), against B
single-y calls; `multi.MultiEmulator` against the JAX package's from the
same starts (JAX `_lhc_starts(jax.random.key(0), ...)`, fed to the port's
`fit`): the best NLL of every output at rtol 1e-6 (two L-BFGS
implementations in fp64 that follow optax step for step), and `predict`
and `sense_matrix` at the same parameters at rtol 1e-9 (variances with an
absolute floor of 1e-10 sigma2).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu.inference.lbfgs import (
    MLEConfig as JMLEConfig, _default_bounds, _lhc_starts as jlhc,
)
from gp_emu_uqsa_tpu.multi import MultiEmulator as JMulti

from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference import MLEConfig
from gp_emu_uqsa_torch.inference.lbfgs import (
    _make_objective, run_restarts,
)
from gp_emu_uqsa_torch.kernels import GPParams, params_from_numpy
from gp_emu_uqsa_torch.multi import MultiEmulator

TRIES = 3
NUGGET = 1e-6
# the L-BFGS cap of both packages: the 1e-8 gradient stop of the default
# 200 iterations is rarely met
MAX_ITERS = 40


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _data(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 2))
    y = np.stack([np.sin(4 * x[:, 0]) + 0.2 * x[:, 1],
                  x[:, 0] * 0.1 + 2.0 * np.cos(3 * x[:, 1]),
                  np.exp(x[:, 0]) * x[:, 1]], axis=1)
    return x, y


@pytest.mark.parametrize("mode", ["mucm", "gp4ml"])
def test_nll_with_batched_y_equals_single_calls(mode):
    x, y = _data()
    tx = torch.tensor(x)
    h = basis_matrix(tx, linear_basis(2))
    yb = torch.tensor(y.T)                                   # (3, n)
    log_delta = torch.log(torch.tensor([[0.3, 0.5], [0.4, 0.9], [1.2, 0.6]],
                                       dtype=torch.float64)).requires_grad_()
    params = GPParams(log_delta, torch.log(torch.tensor([1.0, 0.5, 2.0],
                                                        dtype=torch.float64)),
                      torch.full((3,), np.log(NUGGET), dtype=torch.float64))
    yb.requires_grad_()
    got = tgp.nll(params, tx, yb, h, mode=mode)
    g_delta, g_y = torch.autograd.grad(got.sum(), (log_delta, yb))
    for b in range(3):
        ld = log_delta[b].detach().clone().requires_grad_()
        yi = yb[b].detach().clone().requires_grad_()
        one = tgp.nll(GPParams(ld, params.log_sigma2[b], params.log_nugget[b]),
                      tx, yi, h, mode=mode)
        w_delta, w_y = torch.autograd.grad(one, (ld, yi))
        np.testing.assert_allclose(float(got[b].detach()), float(one.detach()),
                                   rtol=1e-12)
        np.testing.assert_allclose(_np(g_delta[b]), _np(w_delta), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(_np(g_y[b]), _np(w_y), rtol=1e-10,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def fitted():
    x, y = _data()
    jcfg = JMLEConfig(tries=TRIES, nugget=NUGGET, max_iters=MAX_ITERS)
    jme = JMulti.fit(jax.random.key(0), x, y, cfg=jcfg)
    lo, hi = _default_bounds(jcfg, 2)
    starts = np.array(jlhc(jax.random.key(0), TRIES, jnp.asarray(lo),
                           jnp.asarray(hi), jnp.float64))
    cfg = MLEConfig(tries=TRIES, nugget=NUGGET, max_iters=MAX_ITERS)
    tme = MultiEmulator.fit(None, x, y, cfg=cfg, device="cpu", starts=starts)
    return x, y, jme, tme, starts


def test_fit_matches_jax_from_the_same_starts(fitted):
    _, _, jme, tme, _ = fitted
    assert tme.n_outputs == 3
    jn, tn = np.asarray(jme.info["nlls"]), _np(tme.info["nlls"])
    assert tn.shape == jn.shape == (3, TRIES)
    np.testing.assert_allclose(tn.min(axis=1), jn.min(axis=1), rtol=1e-6)
    for k in range(3):
        np.testing.assert_allclose(_np(tme.params.log_delta[k]),
                                   np.asarray(jme.params.log_delta[k]),
                                   rtol=1e-4, atol=1e-6)


def test_fit_rows_equal_a_single_output_run(fitted):
    """One output of the (outputs x restarts) batch against run_restarts on
    that output alone, from the same starts: the rows do not interact."""
    x, y, _, tme, starts = fitted
    tx = torch.tensor(x)
    h = basis_matrix(tx, linear_basis(2))
    cfg = tme.cfg
    lo, hi = _default_bounds(cfg, 2)
    obj, _, frm = _make_objective(tx, torch.tensor(y[:, 1]), h, cfg, lo, hi)
    _, vs, iters = run_restarts(obj, frm(torch.tensor(starts)),
                                cfg.max_iters, cfg.tol)
    np.testing.assert_allclose(_np(tme.info["nlls"][1]), _np(vs), rtol=1e-12)
    np.testing.assert_array_equal(_np(tme.info["iters"][1]), _np(iters))


def test_predict_and_sense_matrix_match_jax_at_the_same_parameters(fitted):
    x, y, jme, tme, _ = fitted
    params = params_from_numpy(np.asarray(jme.params.log_delta),
                               np.asarray(jme.params.log_sigma2),
                               np.asarray(jme.params.log_nugget), device="cpu")
    states = [tgp.fit(GPParams(*(t[k] for t in params)), tme.x, tme.y[:, k],
                      tme.h) for k in range(3)]
    same = dataclasses.replace(tme, params=params, states=states)
    xs = np.random.default_rng(5).uniform(size=(30, 2))
    tm, tv = same.predict(xs)
    jm, jv = jme.predict(xs)
    assert tm.shape == tv.shape == (3, 30)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-9, atol=1e-12)
    # the variance is sigma2 times a difference of terms of size 1: rtol
    # 1e-9 with an absolute floor of 1e-10 sigma2 (tests/test_torch_emulator.py)
    s2 = np.asarray(jme.states.sigma2)[:, None]
    assert np.all(np.abs(_np(tv) - np.asarray(jv))
                  <= 1e-9 * np.abs(np.asarray(jv)) + 1e-10 * s2)
    m, v = np.full(2, 0.5), np.full(2, 0.02)
    ts, js = same.sense_matrix(m, v), jme.sense_matrix(m, v)
    assert ts.shape == (3, 2)
    np.testing.assert_allclose(ts, js, rtol=1e-9, atol=1e-12)
    assert same.state_for(2) is states[2]
    assert len(same.sensitivities(m, v)) == 3
