"""The port's training path against the JAX package on the same inputs.

fp64 on the CPU unless a test says otherwise, n <= 300, one thread. The
Cholesky adjoint and the kernel adjoints are the same formulas through
different BLAS/LAPACK builds: rtol 1e-10. The NLL gradient goes through
A^-1 on a problem with kappa(A) about 1e6: rtol 1e-7. The batched L-BFGS
follows optax's steps from the JAX package's own starts; restarts that
have not converged within the iteration cap drift apart at rounding level
(measured up to 6e-7 relative in the NLL), so per-restart NLLs are held to
rtol 1e-5 and the best restart, which has converged, to rtol 1e-8 in the
NLL and 1e-5 in its log-parameters.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu import gp as jgp
from gp_emu_uqsa_tpu import kernels as jkernels
from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis, linear_basis
from gp_emu_uqsa_tpu.inference import lbfgs as jlbfgs
from gp_emu_uqsa_tpu.ops import cholesky as jchol

from gp_emu_uqsa_torch import dataio as tdataio
from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch import kernels as tkernels
from gp_emu_uqsa_torch import native as tnative
from gp_emu_uqsa_torch.basis import basis_matrix as tbasis
from gp_emu_uqsa_torch.inference import lbfgs as tlbfgs
from gp_emu_uqsa_torch.ops import cholesky as tchol
from gp_emu_uqsa_torch.ops import kernel_matrix as tkm

import oracle


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _close(got, want, rtol, atol_scale=1e-12):
    want = np.asarray(want)
    atol = atol_scale * max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol)


def _spd(n, seed, shift=None):
    m = np.random.default_rng(seed).standard_normal((n, n))
    return m @ m.T + (n if shift is None else shift) * np.eye(n)


def _problem(n=90, d=3, seed=0, nugget=1e-6):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x.sum(1)
    spec = linear_basis(d)
    j = dict(x=jnp.asarray(x), y=jnp.asarray(y))
    j["h"] = jbasis(j["x"], spec)
    t = dict(x=torch.tensor(x), y=torch.tensor(y))
    t["h"] = tbasis(t["x"], spec)
    delta = rng.uniform(0.4, 1.2, size=d)
    return x, y, delta, nugget, j, t


def _tparams(log_delta, log_sigma2, log_nugget, grad=True):
    return tkernels.GPParams(
        *(torch.tensor(np.asarray(v, np.float64), requires_grad=grad)
          for v in (log_delta, log_sigma2, log_nugget)))


# ----- ops/cholesky.py -------------------------------------------------------

def test_chol_rev_matches_jax():
    a = _spd(40, 0)
    l = np.linalg.cholesky(a)
    l_bar = np.random.default_rng(1).standard_normal((40, 40))
    want = jchol._chol_rev(jnp.asarray(l), jnp.asarray(l_bar))
    got = tchol._chol_rev(torch.tensor(l), torch.tensor(l_bar))
    _close(got, want, rtol=1e-10)
    # batched: each matrix its own adjoint
    got2 = tchol._chol_rev(torch.tensor(np.stack([l, 2 * l])),
                           torch.tensor(np.stack([l_bar, l_bar])))
    _close(got2[1], jchol._chol_rev(jnp.asarray(2 * l), jnp.asarray(l_bar)),
           rtol=1e-10)


def _ladder_batch():
    """Two healthy matrices and two that need jitter: duplicated rows with
    no nugget (fp64), and one that no rung can save (NaN)."""
    x = np.random.default_rng(2).uniform(size=(30, 2))
    x = np.vstack([x, x[:10]])                      # duplicated rows
    dup = oracle.corr_self(x, np.array([0.5, 0.7]), 0.0)
    return np.stack([_spd(40, 3), dup, _spd(40, 4, shift=80.0),
                     np.full((40, 40), np.nan)])


def test_batched_ladder_matches_vmap(monkeypatch):
    batch = _ladder_batch()
    jl, jj = jax.vmap(jchol.cholesky_with_jitter)(jnp.asarray(batch))
    seen = []
    factor = torch.linalg.cholesky_ex

    def recording(a, *args, **kwargs):
        seen.append(a.shape[0])
        return factor(a, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", recording)
    tl, tj = tchol.cholesky_with_jitter(torch.tensor(batch))
    monkeypatch.undo()
    # each matrix its own rung, as under vmap; the NaN matrix fails all
    np.testing.assert_array_equal(_np(tj), np.asarray(jj))
    assert float(tj[0]) == 0.0 and float(tj[2]) == 0.0 and float(tj[1]) > 0
    for b in range(3):
        _close(tl[b], jl[b], rtol=1e-9, atol_scale=1e-10)
    # (XLA leaves zeros above the diagonal of a failed factor)
    assert bool(torch.isnan(tl[3][np.tril_indices(40)]).all())
    assert bool(jnp.isnan(jl[3][np.tril_indices(40)]).all())
    # the probe factors all four; the rungs only the two that failed it
    assert seen[0] == 4 and all(s <= 2 for s in seen[1:])
    assert seen[1] == 2
    # one matrix alone gives the same factor as inside the batch
    l1, j1 = tchol.cholesky_with_jitter(torch.tensor(batch[1]))
    assert float(j1) == float(tj[1]) and torch.equal(l1, tl[1])


def test_ladder_gradient_is_chol_rev_of_returned_factor():
    """The analogue of tests/test_fp32.py::test_jitter_ladder_gradients:
    equal to torch's own Cholesky gradient on the healthy branch, and, when
    the ladder engages, finite and equal to the JAX package's."""
    ah = torch.tensor(_spd(24, 0), requires_grad=True)
    g1, = torch.autograd.grad(torch.sum(torch.sin(
        tchol.cholesky_with_jitter(ah)[0])), ah)
    a2 = ah.detach().clone().requires_grad_(True)
    g2, = torch.autograd.grad(torch.sum(torch.sin(
        torch.linalg.cholesky(a2))), a2)
    # torch symmetrizes its adjoint; _chol_rev (as JAX's) leaves it lower
    _close(g1 + g1.mT - torch.diag_embed(torch.diagonal(g1)), g2 + g2.mT
           - torch.diag_embed(torch.diagonal(g2)), rtol=1e-10)
    dup = _ladder_batch()[1]
    jg = jax.grad(lambda a: jnp.sum(jchol.cholesky_with_jitter(a)[0] ** 2))(
        jnp.asarray(dup))
    a = torch.tensor(dup, requires_grad=True)
    l, jit = tchol.cholesky_with_jitter(a)
    assert float(jit) > 0
    tg, = torch.autograd.grad(torch.sum(l ** 2), a)
    assert bool(torch.isfinite(tg).all())
    _close(tg, jg, rtol=1e-6, atol_scale=1e-8)

    # fp32, clustered inputs, zero nugget: the first rung n eps diag succeeds
    rng = np.random.default_rng(0)
    x = np.repeat(rng.uniform(size=(50, 2)), 4, axis=0)
    x = (x + 1e-5 * rng.standard_normal(x.shape)).astype(np.float32)
    p = tkernels.make_params(np.array([0.5, 0.5]), nugget=0.0, device="cpu")
    a32 = tkernels.gaussian_corr_self(torch.tensor(x), p).requires_grad_(True)
    assert int(torch.linalg.cholesky_ex(a32.detach())[1]) != 0
    l32, j32 = tchol.cholesky_with_jitter(a32)
    assert float(j32) > 0 and bool(torch.isfinite(l32).all())
    assert float(j32) <= 1.1 * 200 * 1e-6 * float(a32.detach().diagonal().mean())
    g32, = torch.autograd.grad(torch.sum(l32 ** 2), a32)
    assert bool(torch.isfinite(g32).all())


# ----- kernels.py: the K1/K2 adjoints ------------------------------------------

def test_gaussian_grads_match_jax():
    rng = np.random.default_rng(3)
    x1, x2 = rng.uniform(size=(50, 3)), rng.uniform(size=(37, 3))
    delta = np.array([0.5, 0.9, 1.3])
    c = oracle.corr(x1, x2, delta)
    ct = rng.standard_normal(c.shape)
    want = jkernels._gaussian_cross_grads(*map(jnp.asarray,
                                               (x1, x2, delta, c, ct)))
    got = tkernels._gaussian_cross_grads(*map(torch.tensor,
                                              (x1, x2, delta, c, ct)))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-10)
    a = oracle.corr_self(x1, delta, 1e-3)
    cts = rng.standard_normal(a.shape)
    want = jkernels._gaussian_self_grads(
        jnp.asarray(x1), jnp.asarray(delta), jnp.asarray(1e-3),
        jnp.asarray(a), jnp.asarray(cts))
    got = tkernels._gaussian_self_grads(
        torch.tensor(x1), torch.tensor(delta), torch.tensor(1e-3),
        torch.tensor(a), torch.tensor(cts))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-10)


def test_fast_build_functions_batched_and_differentiable():
    """_GaussianSelfFast / _GaussianCrossFast on CPU tensors (the kernels'
    plain versions, fp32): values bitwise the plain builds, B hyperparameter
    sets equal to B single builds, gradients equal to autograd through the
    general fp32 build (fp32 rounding: rtol 2e-4)."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.uniform(size=(60, 3)), dtype=torch.float32)
    xv = torch.tensor(rng.uniform(size=(20, 3)), dtype=torch.float32)
    deltas = torch.tensor([[0.5, 0.9, 1.3], [0.7, 0.6, 1.1]],
                          requires_grad=True)
    nuggets = torch.tensor([1e-3, 1e-2], requires_grad=True)
    a = tkernels._GaussianSelfFast.apply(x, deltas, nuggets)
    assert a.shape == (2, 60, 60)
    for b in range(2):
        assert torch.equal(a[b], tkm.gaussian_corr_self_plain(
            x, deltas[b].detach(), nuggets[b].detach()))
        assert torch.equal(a[b], tkernels._GaussianSelfFast.apply(
            x, deltas[b], nuggets[b]))
    assert torch.equal(tkm.gaussian_corr_self_batched(x, deltas.detach(),
                                                      nuggets.detach()),
                       a.detach())
    w = torch.tensor(rng.standard_normal((2, 60, 60)), dtype=torch.float32)
    gd, gn = torch.autograd.grad(torch.sum(w * a), (deltas, nuggets))
    d2, n2 = deltas.detach().clone().requires_grad_(True), \
        nuggets.detach().clone().requires_grad_(True)
    ref = tkernels.corr_self(x, tkernels.GPParams(torch.log(d2),
                                                  torch.zeros(2), torch.log(n2)))
    rd, rn = torch.autograd.grad(torch.sum(w * ref), (d2, n2))
    _close(gd, _np(rd), rtol=2e-4, atol_scale=1e-5)
    _close(gn, _np(rn), rtol=2e-4, atol_scale=1e-5)
    c = tkernels._GaussianCrossFast.apply(xv, x, deltas)
    assert torch.equal(c[1], tkm.gaussian_corr_plain(xv, x, deltas[1].detach()))
    gc, = torch.autograd.grad(torch.sum(c[:, :5]), deltas)
    rc, = torch.autograd.grad(torch.sum(torch.exp(-tkernels.scaled_sq_dists(
        xv, x, d2))[:, :5]), d2)
    _close(gc, _np(rc), rtol=2e-4, atol_scale=1e-5)


# ----- gp.py: the likelihood gradients -------------------------------------------

def test_nll_mucm_gradient_matches_jax_and_autograd():
    _, _, delta, nugget, j, t = _problem()
    jp = jkernels.make_params(delta, nugget=nugget, dtype=jnp.float64)
    jv, jg = jax.value_and_grad(
        lambda p, y: jgp.nll_mucm(p, j["x"], y, j["h"]), argnums=(0, 1))(
            jp, j["y"])
    tp = _tparams(jp.log_delta, jp.log_sigma2, jp.log_nugget)
    ty = t["y"].clone().requires_grad_(True)
    tv = tgp.nll_mucm(tp, t["x"], ty, t["h"])
    g_delta, g_sigma, g_nugget, g_y = torch.autograd.grad(
        tv, (tp.log_delta, tp.log_sigma2, tp.log_nugget, ty))
    _close(tv, jv, rtol=1e-10)
    _close(g_delta, jg[0].log_delta, rtol=1e-7)
    _close(g_nugget, jg[0].log_nugget, rtol=1e-7)
    _close(g_y, jg[1], rtol=1e-7, atol_scale=1e-9)
    assert float(g_sigma) == 0.0
    # the adjoint against torch autograd through the factorization
    tp2 = _tparams(jp.log_delta, jp.log_sigma2, jp.log_nugget)
    ad = tgp.nll_mucm_ad(tp2, t["x"], t["y"], t["h"])
    a_delta, a_nugget = torch.autograd.grad(ad, (tp2.log_delta,
                                                 tp2.log_nugget))
    _close(g_delta, _np(a_delta), rtol=1e-7)
    _close(g_nugget, _np(a_nugget), rtol=1e-7)


@pytest.mark.parametrize("cfg", [
    dict(mode="gp4ml", nugget=1e-5),
    dict(train_nugget=True, nugget_bounds=(1e-8, 1.0)),
    dict(mode="gp4ml", train_nugget=True, nugget_bounds=(1e-6, 1.0)),
], ids=["gp4ml", "train_nugget", "gp4ml_train_nugget"])
def test_objective_gradient_matches_jax(cfg):
    """The L-BFGS objective in its sigmoid coordinates, value and gradient:
    gp4ml through autograd (`_chol_rev` and the build's autograd), the
    trained nugget through the analytic adjoint. The nuggets keep kappa(A)
    under about 1e6, so values hold to rtol 1e-9 and gradients to 1e-7."""
    x, y, _, _, j, t = _problem(seed=1)
    jcfg = jlbfgs.MLEConfig(tries=3, **cfg)
    tcfg = tlbfgs.MLEConfig(**dataclasses.asdict(jcfg))
    lo, hi = jlbfgs._default_bounds(jcfg, 3)
    jobj, _, _ = jlbfgs._make_objective(j["x"], j["y"], j["h"], jcfg, lo, hi)
    tobj, _, _ = tlbfgs._make_objective(t["x"], t["y"], t["h"], tcfg, lo, hi)
    u = np.random.default_rng(5).uniform(-0.2, 0.2, size=(3, lo.shape[0]))
    tv, tg = tlbfgs.value_and_grad(tobj, torch.tensor(u))
    for b in range(3):
        jv, jg = jax.value_and_grad(jobj)(jnp.asarray(u[b]))
        _close(tv[b], jv, rtol=1e-9)
        _close(tg[b], jg, rtol=1e-7, atol_scale=1e-9)


def test_gradient_with_the_ladder_engaged_matches_jax():
    """Duplicated rows and a nugget of 1e-300: the probe fails and the
    first rung (4e-11) factors A, so kappa is about 1e11 and the two
    packages' gradients agree to about kappa eps64 (measured 4e-6
    relative; held to 3e-5), the values to 1e-7."""
    x = np.random.default_rng(2).uniform(size=(30, 2))
    x = np.vstack([x, x[:10]])
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    spec = linear_basis(2)
    jp = jkernels.GPParams(jnp.log(jnp.asarray([0.5, 0.7])), jnp.asarray(0.0),
                           jnp.asarray(np.log(1e-300)))
    jx = jnp.asarray(x)
    jv, jg = jax.value_and_grad(lambda p: jgp.nll_mucm(
        p, jx, jnp.asarray(y), jbasis(jx, spec)))(jp)
    tp = _tparams(jp.log_delta, jp.log_sigma2, jp.log_nugget)
    tx = torch.tensor(x)
    tv = tgp.nll_mucm(tp, tx, torch.tensor(y), tbasis(tx, spec))
    g_delta, = torch.autograd.grad(tv, tp.log_delta)
    assert float(tgp.fit(tp, tx, torch.tensor(y), tbasis(tx, spec)).jitter) > 0
    assert bool(torch.isfinite(g_delta).all())
    _close(tv, jv, rtol=1e-7)
    _close(g_delta, jg.log_delta, rtol=3e-5)


def test_batched_restarts_equal_single_calls():
    _, _, delta, nugget, _, t = _problem(seed=2)
    ld = np.log(np.stack([delta, 1.3 * delta, 0.6 * delta]))
    ln = np.log(np.array([nugget, 1e-4, 1e-3]))
    for mode in ("mucm", "gp4ml"):
        tp = _tparams(ld, np.array([0.0, 0.3, -0.2]), ln)
        v = tgp.nll(tp, t["x"], t["y"], t["h"], mode=mode)
        grads = torch.autograd.grad(v.sum(), tp)
        for b in range(3):
            pb = _tparams(ld[b], [0.0, 0.3, -0.2][b], ln[b])
            vb = tgp.nll(pb, t["x"], t["y"], t["h"], mode=mode)
            gb = torch.autograd.grad(vb, pb)
            _close(v[b], _np(vb), rtol=1e-12)
            for g, w in zip(grads, gb):
                _close(g[b], _np(w), rtol=1e-10)


def test_inf_rows_get_zero_gradient():
    """A restart whose A fails every rung gives +inf and a zero gradient,
    and leaves the other restarts' values and gradients alone."""
    _, _, delta, nugget, _, t = _problem(seed=3)
    ld = np.log(np.stack([delta, delta]))
    tp = _tparams(ld, [0.0, 0.0], np.log([nugget, nugget]))
    x = t["x"].clone()
    good = tgp.nll_mucm(tp, x, t["y"], t["h"])
    tp_bad = _tparams(np.stack([ld[0], [np.nan] * 3]), [0.0, 0.0],
                      np.log([nugget, nugget]))
    v = tgp.nll_mucm(tp_bad, x, t["y"], t["h"])
    assert float(v[1].detach()) == float("inf")
    g, = torch.autograd.grad(v.sum(), tp_bad.log_delta)
    g_good, = torch.autograd.grad(good.sum(), tp.log_delta)
    assert torch.equal(g[1], torch.zeros(3, dtype=torch.float64))
    _close(v[0], _np(good[0]), rtol=1e-14)
    _close(g[0], _np(g_good[0]), rtol=1e-12)


# ----- inference/lbfgs.py ---------------------------------------------------------

@pytest.mark.parametrize("mode,train_nugget", [
    ("mucm", False), ("gp4ml", False), ("mucm", True), ("gp4ml", True)])
def test_bounds_unpack_and_sigmoid_map_equal_jax(mode, train_nugget):
    jcfg = jlbfgs.MLEConfig(mode=mode, train_nugget=train_nugget,
                            delta_bounds=(np.array([1e-2, 1e-1]), 1e2),
                            nugget=3e-7)
    tcfg = tlbfgs.MLEConfig(**dataclasses.asdict(jcfg))
    jlo, jhi = jlbfgs._default_bounds(jcfg, 2)
    tlo, thi = tlbfgs._default_bounds(tcfg, 2)
    np.testing.assert_array_equal(tlo, jlo)
    np.testing.assert_array_equal(thi, jhi)
    z = np.random.default_rng(7).uniform(jlo, jhi, size=(5, jlo.shape[0]))
    for b in range(5):
        jp = jlbfgs._unpack(jnp.asarray(z[b]), jcfg, 2, jnp.float64)
        tp = tlbfgs._unpack(torch.tensor(z[b]), tcfg, 2, torch.float64)
        for got, want in zip(tp, jp):
            np.testing.assert_array_equal(_np(got), np.asarray(want))
    tpb = tlbfgs._unpack(torch.tensor(z), tcfg, 2, torch.float64)
    assert tpb.log_delta.shape == (5, 2) and tpb.log_nugget.shape == (5,)
    x = jnp.zeros((4, 2))
    _, jto, jfrom = jlbfgs._make_objective(x, jnp.zeros(4), jnp.zeros((4, 1)),
                                           jcfg, jlo, jhi)
    _, tto, tfrom = tlbfgs._make_objective(
        torch.zeros((4, 2), dtype=torch.float64), torch.zeros(4),
        torch.zeros((4, 1)), tcfg, tlo, thi)
    u = np.random.default_rng(8).uniform(-12, 12, size=(5, jlo.shape[0]))
    _close(tto(torch.tensor(u)), jax.vmap(jto)(jnp.asarray(u)), rtol=1e-15,
           atol_scale=1e-15)
    _close(tfrom(torch.tensor(z)), jax.vmap(jfrom)(jnp.asarray(z)), rtol=1e-14,
           atol_scale=1e-14)


def test_lhc_starts_are_stratified():
    lo, hi = np.array([-2.0, 0.0, 3.0]), np.array([2.0, 1.0, 9.0])
    z = tlbfgs._lhc_starts(torch.Generator().manual_seed(3), 7, lo, hi,
                           torch.float64)
    assert z.shape == (7, 3) and z.dtype == torch.float64
    frac = (_np(z) - lo) / (hi - lo)
    for col in range(3):
        np.testing.assert_array_equal(np.sort(np.floor(frac[:, col] * 7)),
                                      np.arange(7))
    again = tlbfgs._lhc_starts(torch.Generator().manual_seed(3), 7, lo, hi,
                               torch.float64)
    assert torch.equal(z, again)


def _draw_gp(seed, n, d, delta, nugget=1e-8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    a = oracle.corr_self(x, delta, nugget)
    return x, np.linalg.cholesky(a) @ rng.standard_normal(n)


def _mle_problem(name):
    """tests/test_mle.py's problems, with its configurations (the iteration
    cap keeps the unconverged mucm and gp4ml runs short)."""
    if name == "mucm":
        x, y = _draw_gp(0, 120, 2, np.array([0.3, 0.8]))
        return x, y, jlbfgs.MLEConfig(tries=6, nugget=1e-8, max_iters=30,
                                      delta_bounds=(1e-2, 1e2)), 0
    if name == "gp4ml":
        x, y = _draw_gp(3, 80, 1, np.array([0.5]))
        return x, 2.0 * y, jlbfgs.MLEConfig(mode="gp4ml", tries=4,
                                            nugget=1e-8, max_iters=60), 1
    x, y = _draw_gp(7, 100, 1, np.array([0.4]))
    y = y + 0.05 * np.random.default_rng(8).standard_normal(len(y))
    return x, y, jlbfgs.MLEConfig(tries=4, train_nugget=True,
                                  nugget_bounds=(1e-8, 1.0)), 2


@pytest.mark.parametrize("name", ["mucm", "gp4ml", "train_nugget"])
def test_run_restarts_matches_jax_mle_fit(name):
    x, y, jcfg, seed = _mle_problem(name)
    d = x.shape[1]
    spec = linear_basis(d)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jh = jbasis(jx, spec)
    jparams, info = jlbfgs.mle_fit(jax.random.key(seed), jx, jy, jh, jcfg)
    lo, hi = jlbfgs._default_bounds(jcfg, d)
    _, _, jfrom = jlbfgs._make_objective(jx, jy, jh, jcfg, lo, hi)
    u0s = np.asarray(jax.vmap(jfrom)(info["starts_logspace"]))

    tcfg = tlbfgs.MLEConfig(**dataclasses.asdict(jcfg))
    tx, ty = torch.tensor(x), torch.tensor(y)
    tobj, tto, _ = tlbfgs._make_objective(tx, ty, tbasis(tx, spec), tcfg,
                                          lo, hi)
    us, vs, iters = tlbfgs.run_restarts(tobj, torch.tensor(u0s),
                                        tcfg.max_iters, tcfg.tol)
    jv = np.asarray(info["nlls"])
    _close(vs, jv, rtol=1e-5)
    np.testing.assert_array_equal(_np(iters), np.asarray(info["iters"]))
    best = int(info["best_index"])
    # the JAX package's best restart is a best restart of the port too
    assert float(vs[best]) <= float(vs.min()) + 1e-8 * abs(float(vs.min()))
    _close(vs.min(), info["best_nll"], rtol=1e-8)
    got = tlbfgs._unpack(tto(us[best]), tcfg, d, torch.float64)
    for g, w in zip(got, jparams):
        _close(g, w, rtol=0.0, atol_scale=1e-5)


def test_mle_fit_info_and_inf_restart():
    """mle_fit's info keys; a restart that starts where A cannot be factored
    stays +inf with zero gradient and does not stop the others."""
    x, y, jcfg, _ = _mle_problem("train_nugget")
    tcfg = tlbfgs.MLEConfig(**dataclasses.asdict(jcfg))
    tx, ty = torch.tensor(x), torch.tensor(y)
    th = tbasis(tx, linear_basis(1))
    params, info = tlbfgs.mle_fit(torch.Generator().manual_seed(0), tx, ty,
                                  th, tcfg)
    assert set(info) == {"nlls", "iters", "best_index", "starts_logspace",
                         "best_nll"}
    assert info["starts_logspace"].shape == (4, 2)
    assert float(info["best_nll"]) == float(info["nlls"].min())
    assert params.log_delta.shape == (1,) and params.log_nugget.shape == ()
    lo, hi = tlbfgs._default_bounds(tcfg, 1)
    obj, _, frm = tlbfgs._make_objective(tx, ty, th, tcfg, lo, hi)
    u0 = frm(info["starts_logspace"].clone())
    u0[0, 0] = float("nan")
    us, vs, iters = tlbfgs.run_restarts(obj, u0, 50, tcfg.tol)
    assert float(vs[0]) == float("inf") and int(iters[0]) == 1
    assert bool(torch.isfinite(vs[1:]).all())
    assert float(vs[1:].min()) <= float(info["best_nll"]) + 1e-6


# ----- gp.fit(refine) ---------------------------------------------------------------

def _clustered(n=256, d=4, nugget=1e-3, seed=3):
    """tests/test_fp32.py's clustered system at n = 256: near-duplicate
    pairs, kappa about 1e5 at this nugget."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(n // 2, d))
    x = np.vstack([base, base + 1e-3 * rng.standard_normal((n // 2, d))])
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.05 * rng.standard_normal(n)
    return x, y, np.full(d, 1.2), nugget


def test_fit_refine_fp64_and_fp32_against_jax_and_an_fp64_solve():
    x, y, delta, nugget = _clustered()
    spec = linear_basis(x.shape[1])
    errs = {}
    for dtype, jdt, tdt in (("fp64", jnp.float64, torch.float64),
                            ("fp32", jnp.float32, torch.float32)):
        jx, jy = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
        jh = jbasis(jx, spec)
        jp = jkernels.make_params(delta, nugget=nugget, dtype=jdt)
        tx, ty = torch.tensor(x, dtype=tdt), torch.tensor(y, dtype=tdt)
        th = tbasis(tx, spec)
        tp = tkernels.make_params(delta, nugget=nugget, dtype=tdt,
                                  device="cpu")
        for pkg, fit, args, corr_self in (
                ("jax", jgp.fit, (jp, jx, jy, jh), jkernels.corr_self),
                ("torch", tgp.fit, (tp, tx, ty, th), tkernels.corr_self)):
            st0 = fit(*args)
            st1 = fit(*args, refine=1)
            st3 = fit(*args, refine=3) if dtype == "fp32" else st1
            np.testing.assert_array_equal(_np(st0.beta), _np(st1.beta))
            # the fp64 solve of the matrix this package factored, at its beta
            a64 = _np(corr_self(args[1], args[0])).astype(np.float64)
            h64 = _np(args[3]).astype(np.float64)
            beta = _np(st1.beta).astype(np.float64)
            rhs = _np(args[2]).astype(np.float64) - h64 @ beta
            e64 = np.linalg.solve(a64, rhs)
            ah64 = np.linalg.solve(a64, h64)
            err = lambda st: max(
                np.linalg.norm(_np(st.e) - e64) / np.linalg.norm(e64),
                np.linalg.norm(_np(st.ainv_h) - ah64) / np.linalg.norm(ah64))
            errs[dtype, pkg] = [err(st0), err(st1), err(st3)]
    for pkg in ("jax", "torch"):
        assert errs["fp64", pkg][1] <= 1e-10, (pkg, errs["fp64", pkg])
    j, t = errs["fp32", "jax"], errs["fp32", "torch"]
    assert t[1] < t[0] / 10, t            # the sweep acted
    # one sweep of the port (its correction through the fp64 factor) is at
    # least as close as one of the JAX package's compensated path
    # (measured 2.56e-8 against 4.74e-6)
    assert t[1] <= j[1], (j, t)
    # three sweeps: both at the floor of fp32 storage, each against its own
    # package's fp64 solve (measured 2.56e-8 and 2.51e-8)
    assert t[2] <= 1.1 * j[2] and t[2] <= 1e-7, (j, t)


def test_cho_solve_refined_one_sweep_against_jax():
    """tests/test_fp32.py::test_refined_solve_error_bound_n4096 at n = 256:
    one sweep of the port's fp32 refined solve against the fp64 solve of
    the same fp32 matrix, and against one sweep of the JAX package's."""
    x, _, delta, nugget = _clustered()
    rng = np.random.default_rng(3)
    a32 = _np(tkernels.corr_self(
        torch.tensor(x, dtype=torch.float32),
        tkernels.make_params(delta, nugget=nugget, dtype=torch.float32,
                             device="cpu")))
    b32 = rng.standard_normal((a32.shape[0], 3)).astype(np.float32)
    x_true = np.linalg.solve(a32.astype(np.float64), b32.astype(np.float64))
    err = lambda v: np.linalg.norm(_np(v) - x_true) / np.linalg.norm(x_true)
    ta, tb = torch.tensor(a32), torch.tensor(b32)
    tl, tj = tchol.cholesky_with_jitter(ta)
    ja, jb = jnp.asarray(a32), jnp.asarray(b32)
    jl, jj = jchol.cholesky_with_jitter(ja)
    assert float(tj) == 0.0 and float(jj) == 0.0
    t0 = err(tchol.cho_solve(tl, tb))
    t1 = err(tchol.cho_solve_refined(tl, ta, tb, iters=1))
    j1 = err(jchol.cho_solve_refined(jl, ja, jb, iters=1))
    assert t0 > 1e-4, t0                  # the unrefined fp32 solve is off
    # one sweep: the budget of the n = 4096 test, and at least as close as
    # the JAX package's compensated sweep (measured 2.3e-8 and 5.2e-6,
    # from 1.8e-3)
    assert t1 <= 1e-5 and t1 <= j1, (t0, t1, j1)
    # fp64 input: classic refinement on its own factor, as in JAX; the two
    # round their products in different orders, kappa about 1e5 (measured
    # 2.9e-10 at worst)
    ta64, tb64 = ta.double(), tb.double()
    tl64 = tchol.cholesky_with_jitter(ta64)[0]
    _close(tchol.cho_solve_refined(tl64, ta64, tb64, iters=1),
           jchol.cho_solve_refined(jnp.asarray(_np(tl64)), jnp.asarray(
               a32.astype(np.float64)), jnp.asarray(b32.astype(np.float64)),
               iters=1), rtol=1e-8)


# ----- dataio.py --------------------------------------------------------------------

def test_load_and_save_matrix_round_trip(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    arr = rng.standard_normal((25, 4)) * 10.0 ** rng.integers(-5, 5, (25, 4))
    path = tmp_path / "m.txt"
    tdataio.save_matrix(path, arr)
    text = "# header\n\n" + path.read_text().replace("\n", "  # note\n", 3)
    path.write_text(text)
    native = tdataio.load_matrix(path)
    assert tnative.available()
    np.testing.assert_allclose(native, arr, rtol=1e-11)
    np.testing.assert_array_equal(native, np.loadtxt(path, ndmin=2))
    col = tmp_path / "col.txt"
    tdataio.save_matrix(col, arr[:, 0])
    assert tdataio.load_matrix(col).shape == (25, 1)
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2\n3\n")
    with pytest.raises(ValueError):
        tdataio.load_matrix(bad)
    # without the C loader: np.loadtxt, the same array
    monkeypatch.setattr(tnative, "load_matrix_native", lambda p: None)
    np.testing.assert_array_equal(tdataio.load_matrix(path), native)
    assert tdataio.load_matrix(col).shape == (25, 1)


# ----- on the card (skips elsewhere) --------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_batched_k1_and_its_adjoint(cuda_device):
    """The batched K1 (one launch a restart into out[b]) bitwise the plain
    builds, and its adjoint equal to the same adjoint on the CPU."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.uniform(size=(700, 8)), dtype=torch.float32)
    deltas = torch.tensor(rng.uniform(0.3, 1.5, size=(3, 8)),
                          dtype=torch.float32)
    nuggets = torch.tensor([1e-4, 1e-3, 1e-2])
    before = tkm.gaussian_corr_self_fused.launches
    xd, dd, nd = (t.to(cuda_device) for t in (x, deltas, nuggets))
    a = tkm.gaussian_corr_self_batched(xd, dd, nd)
    assert tkm.gaussian_corr_self_fused.launches == before + 3
    assert torch.equal(a.cpu(), tkm.gaussian_corr_self_batched_plain(
        x, deltas, nuggets))
    ct = torch.tensor(rng.standard_normal((3, 700, 700)), dtype=torch.float32)
    got = tkernels._gaussian_self_grads(xd, dd, nd, a, ct.to(cuda_device))
    want = tkernels._gaussian_self_grads(x, deltas, nuggets, a.cpu(), ct)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
