"""The port's matrix-free stack (ops/cg.py, ops/slq.py,
inference/matrix_free.py) against the JAX package's on the same inputs.

fp64 on the CPU, n <= 300, one thread; every JAX side compiled once a
shape. Tolerances:
- the matvec: rtol 1e-12 (the port sums exact differences where the JAX
  package expands the distance; both are exact to about 1e-16);
- CG with and without the pivoted-Cholesky preconditioner: the same
  iteration count, x at rtol 1e-8;
- the pivoted Cholesky: the same pivots, the factor at rtol 1e-10; the
  Woodbury operators' log|M| and applies at rtol 1e-10;
- fit_matrix_free and predict_mean_matrix_free: rtol 1e-8;
- Lanczos and SLQ fed the JAX package's Rademacher probes: rtol 1e-8;
- nll_and_grad_matrix_free fed the JAX package's probes (the split of
  `matrix_free.py:69-71`): NLL, gradient, CG iterations and residuals at
  rtol 1e-8; mle_fit_matrix_free fed them, 10 Adam steps: the NLL trace
  and the parameters at rtol 1e-8;
- the fp32 delta-gradient pass against fp64 on the same fp32 M: within
  0.5 eps32 sum_ij |M_ij| (x_il - x_jl)^2 a dimension (the sum is
  ill-conditioned: its terms cancel 1e3- to 1e7-fold, so this is the
  unit of its rounding), which the JAX package's t1 - 2 quad form breaks
  on the same M;
- tests/test_matrix_free.py's four checks, with its bounds, on the port;
- tools/mf_fp32_floor.case at n = 256, nugget 1e-2 (far above the fp32
  floor 0.25 eps32 n): fp32 against fp64 from the same probes, gradient
  cosine > 0.999, norm ratio within 1%, NLL within 1e-5; the fp32 fit's
  true residual under 1e-4.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis, linear_basis
from gp_emu_uqsa_tpu.inference import matrix_free as jmf
from gp_emu_uqsa_tpu.kernels import make_params as jparams
from gp_emu_uqsa_tpu.ops import cg as jcg
from gp_emu_uqsa_tpu.ops import slq as jslq

from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch.basis import basis_matrix as tbasis
from gp_emu_uqsa_torch.inference import MLEConfig, mle_fit
from gp_emu_uqsa_torch.inference import matrix_free as tmf
from gp_emu_uqsa_torch.kernels import GPParams, gaussian_corr_self
from gp_emu_uqsa_torch.kernels import make_params as tparams
from gp_emu_uqsa_torch.ops import cg as tcg
from gp_emu_uqsa_torch.ops import slq as tslq
from gp_emu_uqsa_torch.ops.precision import fp32_exact

EPS32 = 2.0 ** -24


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _problem(n=160, d=2, seed=0, delta=(0.7, 0.9), nugget=1e-2):
    """tests/test_matrix_free.py's data in both packages: (jax side, port
    side), each (x, y, h, params)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = (np.sin(3 * x[:, 0]) + np.sin(2 * x[:, 1])
         + 0.05 * rng.standard_normal(n))
    jx = jnp.asarray(x)
    tx = torch.tensor(x)
    delta = np.asarray(delta, dtype=np.float64)
    return ((jx, jnp.asarray(y), jbasis(jx, linear_basis(d)),
             jparams(delta, nugget=nugget, dtype=jnp.float64)),
            (tx, torch.tensor(y), tbasis(tx, linear_basis(d)),
             tparams(delta, nugget=nugget, dtype=torch.float64,
                     device="cpu")))


def _rhs(n, k, seed=2):
    b = np.random.default_rng(seed).standard_normal((n, k))
    return jnp.asarray(b), torch.tensor(b)


def _jax_probes(key, n, p):
    """The JAX package's Rademacher draws of one evaluation: kz, kl =
    split(key), z (n, p) from kz, the SLQ's (p, n) from kl."""
    kz, kl = jax.random.split(key)
    z = jax.random.rademacher(kz, (n, p), dtype=jnp.float64)
    zs = jax.random.rademacher(kl, (p, n), dtype=jnp.float64)
    return torch.tensor(np.asarray(z)), torch.tensor(np.asarray(zs))


# ----- ops/cg.py ----------------------------------------------------------------

def test_matvec_matches_jax():
    (jx, _, _, jp), (tx, _, _, tp) = _problem(n=150, d=3, delta=(0.7,) * 3)
    jv, tv = _rhs(150, 4)
    noise = np.linspace(0.0, 0.1, 150)
    for nd in (None, noise):
        jmv = jcg.make_corr_matvec(jx, jp, chunk=64, noise_diag=nd)
        tmv = tcg.make_corr_matvec(tx, tp, chunk=64, noise_diag=nd)
        np.testing.assert_allclose(_np(tmv(tv)), np.asarray(jax.jit(jmv)(jv)),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(_np(tmv(tv[:, 0])),
                                   np.asarray(jax.jit(jmv)(jv[:, 0])),
                                   rtol=1e-12, atol=1e-12)
    # against the dense matrix too
    a = gaussian_corr_self(tx, tp)
    np.testing.assert_allclose(_np(tcg.make_corr_matvec(tx, tp, chunk=64)(tv)),
                               _np(a @ tv), rtol=1e-12, atol=1e-12)


def _cg_problem(nugget):
    n = 300
    x = np.random.default_rng(5).uniform(size=(n, 2))
    jx, tx = jnp.asarray(x), torch.tensor(x)
    jp = jparams(np.full(2, 0.6), nugget=nugget, dtype=jnp.float64)
    tp = tparams(np.full(2, 0.6), nugget=nugget, dtype=torch.float64,
                 device="cpu")
    return jx, tx, jp, tp, _rhs(n, 2, seed=6)


@pytest.mark.parametrize("rank", [0, 48])
def test_cg_solve_matches_jax_with_and_without_preconditioner(rank):
    """At nugget 1e-2 (CG converges in tens of iterations, so rounding does
    not move the count; at 1e-4 unpreconditioned CG runs hundreds, and the
    two packages' 1e-16 distance roundings move it by tens)."""
    jx, tx, jp, tp, (jb, tb) = _cg_problem(1e-2)
    jmv = jcg.make_corr_matvec(jx, jp, chunk=128)
    tmv = tcg.make_corr_matvec(tx, tp, chunk=128)
    jpre = jcg.pivoted_chol_precond(jx, jp, rank=rank) if rank else None
    tpre = tcg.pivoted_chol_precond(tx, tp, rank=rank) if rank else None
    jsol, jinfo = jcg.cg_solve(jmv, jb, tol=1e-8, maxiter=3000, precond=jpre)
    tsol, tinfo = tcg.cg_solve(tmv, tb, tol=1e-8, maxiter=3000, precond=tpre)
    assert tinfo["iters"] == int(jinfo["iters"])
    assert tinfo["host_syncs"] == tinfo["iters"] + 1
    np.testing.assert_allclose(_np(tsol), np.asarray(jsol), rtol=1e-8,
                               atol=1e-8 * float(jnp.max(jnp.abs(jsol))))
    # the residuals at the stop are rounding (1e-9 of b): each below tol
    assert float(tinfo["rel_resid"].max()) < 1e-8
    # a vector right-hand side, stopped at maxiter
    jsol, jinfo = jcg.cg_solve(jmv, jb[:, 0], tol=1e-30, maxiter=7,
                               precond=jpre)
    tsol, tinfo = tcg.cg_solve(tmv, tb[:, 0], tol=1e-30, maxiter=7,
                               precond=tpre)
    assert tinfo["iters"] == int(jinfo["iters"]) == 7
    np.testing.assert_allclose(_np(tsol), np.asarray(jsol), rtol=1e-8)


def test_port_preconditioner_cuts_iterations():
    """tests/test_cg.py's check at nugget 1e-4, on the port."""
    _, tx, _, tp, (_, tb) = _cg_problem(1e-4)
    a = gaussian_corr_self(tx, tp)
    mv = tcg.make_corr_matvec(tx, tp, chunk=128)
    sol0, info0 = tcg.cg_solve(mv, tb, tol=1e-8, maxiter=3000)
    sol1, info1 = tcg.cg_solve(mv, tb, tol=1e-8, maxiter=3000,
                               precond=tcg.pivoted_chol_precond(tx, tp, 48))
    np.testing.assert_allclose(_np(a @ sol1), _np(tb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(sol0), _np(sol1), rtol=1e-4, atol=1e-6)
    assert info1["iters"] < info0["iters"] / 2, (info0["iters"],
                                                 info1["iters"])


def test_pivoted_cholesky_and_woodbury_match_jax():
    (jx, _, _, jp), (tx, _, _, tp) = _problem(n=300, nugget=1e-4)
    jl, jpiv = jax.jit(partial(jcg.pivoted_cholesky, rank=48))(jx, jp)
    tl, tpiv = tcg.pivoted_cholesky(tx, tp, 48)
    np.testing.assert_array_equal(_np(tpiv), np.asarray(jpiv))
    assert tpiv.dtype == torch.int32 and np.unique(_np(tpiv)).size == 48
    # late columns hold entries of 1e-11 and below: absolute there
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-10,
                               atol=1e-10)
    dvec = np.full(300, 1e-4) + np.linspace(0.0, 1e-3, 300)
    jw = jcg.woodbury_ops(jl, jnp.asarray(dvec))
    tw = tcg.woodbury_ops(tl, torch.tensor(dvec))
    np.testing.assert_allclose(float(tw["logdet_m"]), float(jw["logdet_m"]),
                               rtol=1e-10)
    jv, tv = _rhs(300, 3)
    for name in ("apply_minv", "apply_binv", "apply_binv_t"):
        want = np.asarray(jax.jit(jw[name])(jv))
        np.testing.assert_allclose(_np(tw[name](tv)), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
        np.testing.assert_allclose(_np(tw[name](tv[:, 0])), want[:, 0],
                                   rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    # B B^T = M: binv(M binv_t(v)) = v
    m = tl @ tl.T + torch.diag(torch.tensor(dvec))
    np.testing.assert_allclose(_np(tw["apply_binv"](m @ tw["apply_binv_t"](tv))),
                               _np(tv), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("rank", [0, 24])
def test_fit_and_predict_matrix_free_match_jax(rank):
    """At tol 1e-10 on this problem the residual crosses it cleanly (from
    1.1e-9 to 2.3e-11 unpreconditioned, from 1.5e-9 to 2.1e-12 with the
    preconditioner), so both packages stop at the same iteration; an
    erratic unpreconditioned residual near tol can move the count by one."""
    (jx, jy, jh, jp), (tx, ty, th, tp) = _problem()
    xs = np.random.default_rng(3).uniform(size=(31, 2))
    jxs, txs = jnp.asarray(xs), torch.tensor(xs)
    jhs, ths = jbasis(jxs, linear_basis(2)), tbasis(txs, linear_basis(2))
    jff = jcg.fit_matrix_free(jp, jx, jy, jh, tol=1e-10, maxiter=4000,
                              precond_rank=rank)
    tff = tcg.fit_matrix_free(tp, tx, ty, th, tol=1e-10, maxiter=4000,
                              precond_rank=rank)
    assert tff["info"]["iters"] == int(jff["info"]["iters"])
    for k in ("beta", "e", "sigma2", "g", "ainv_h"):
        want = np.asarray(jff[k])
        np.testing.assert_allclose(_np(tff[k]), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max(), err_msg=k)
    jm = jcg.predict_mean_matrix_free(jff, jx, jxs, jhs, jp, chunk=16)
    tm = tcg.predict_mean_matrix_free(tff, tx, txs, ths, tp, chunk=16)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-8)


def test_port_fit_matrix_free_matches_factorized():
    """tests/test_cg.py's check against the factorized path, on the port."""
    _, (tx, ty, th, tp) = _problem(n=150, d=3, delta=(0.7,) * 3, nugget=1e-3)
    xs = torch.tensor(np.random.default_rng(3).uniform(size=(31, 3)))
    hs = tbasis(xs, linear_basis(3))
    ff = tcg.fit_matrix_free(tp, tx, ty, th, tol=1e-12, maxiter=4000)
    st = tgp.fit(tp, tx, ty, th)
    np.testing.assert_allclose(_np(ff["beta"]), _np(st.beta), rtol=1e-7)
    np.testing.assert_allclose(_np(ff["e"]), _np(st.e), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(float(ff["sigma2"]), float(st.sigma2),
                               rtol=1e-8)
    np.testing.assert_allclose(
        _np(tcg.predict_mean_matrix_free(ff, tx, xs, hs, tp, chunk=16)),
        _np(tgp.predict(st, tx, th, xs, hs)[0]), rtol=1e-7, atol=1e-9)


# ----- ops/slq.py ---------------------------------------------------------------

def test_lanczos_with_a_breakdown_probe_matches_jax():
    """Lanczos of the port's lockstep probes against one JAX Lanczos a
    probe. Probe 0 lies in a two-dimensional invariant subspace, so it
    breaks down after 2 steps and its tridiagonal is padded; the others
    are the JAX package's Rademacher draws."""
    n, p, k = 120, 4, 10
    diag = np.linspace(0.5, 3.0, n)
    z = np.array(jax.random.rademacher(jax.random.key(3), (p, n),
                                       dtype=jnp.float64))
    z[0] = 0.0
    z[0, [5, 90]] = 1.0
    jd, td = jnp.asarray(diag), torch.tensor(diag)
    ja, jb, jq = jax.jit(jax.vmap(lambda v: jslq.lanczos(lambda u: jd * u, v,
                                                         k)))(jnp.asarray(z))
    ta, tb, tq = tslq.lanczos(lambda u: td[:, None] * u, torch.tensor(z).T, k)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=1e-8)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(_np(tq), np.asarray(jq), rtol=1e-8, atol=1e-10)
    # the padding: probe 0 keeps its two alphas, then 1.0, and no coupling
    assert np.all(_np(ta[0, 2:]) == 1.0) and np.all(_np(tb[0, 1:]) == 0.0)
    assert np.all(_np(tb[1:]) > 0.0)
    # a vector start gives one probe's arrays
    a1, b1, q1 = tslq.lanczos(lambda u: td[:, None] * u, torch.tensor(z[1]), k)
    np.testing.assert_allclose(_np(a1), _np(ta[1]), rtol=1e-13)
    assert q1.shape == (k, n) and b1.shape == (k - 1,)
    # the quadrature of the padded probe is its two-point one
    np.testing.assert_allclose(
        _np(tslq._logdet_quadrature(ta, tb, torch.tensor((z * z).sum(1)))),
        np.asarray(jax.vmap(jslq._logdet_quadrature)(ja, jb, (z * z).sum(1))),
        rtol=1e-8)


def test_slq_logdet_plain_and_preconditioned_match_jax():
    (jx, _, _, jp), (tx, _, _, tp) = _problem(nugget=1e-2)
    n = 160
    key = jax.random.key(0)
    zj = jax.random.rademacher(key, (16, n), dtype=jnp.float64)
    zt = torch.tensor(np.asarray(zj))
    jmv = jcg.make_corr_matvec(jx, jp, chunk=64)
    tmv = tcg.make_corr_matvec(tx, tp, chunk=64)
    jval = float(jax.jit(lambda: jslq.slq_logdet(jmv, n, key, num_probes=16,
                                                 k=32))())
    tval = float(tslq.slq_logdet_from_probes(tmv, zt, k=32))
    np.testing.assert_allclose(tval, jval, rtol=1e-8)
    a = gaussian_corr_self(tx, tp)
    true = float(torch.linalg.slogdet(a)[1])
    assert abs(tval - true) / abs(true) < 0.02          # tests/test_matrix_free.py
    jl, _ = jcg.pivoted_cholesky(jx, jp, 24)
    jw = jcg.woodbury_ops(jl, jnp.full((n,), 1e-2))
    tl, _ = tcg.pivoted_cholesky(tx, tp, 24)
    tw = tcg.woodbury_ops(tl, torch.full((n,), 1e-2, dtype=torch.float64))
    jpre = float(jax.jit(lambda: jslq.slq_logdet_preconditioned(
        jmv, jw, n, key, num_probes=16, k=12))())
    tpre = float(tslq.slq_logdet_preconditioned_from_probes(tmv, tw, zt, k=12))
    np.testing.assert_allclose(tpre, jpre, rtol=1e-8)
    # the port's own draws: +-1, on the generator's device, a fixed stream
    g = torch.Generator().manual_seed(0)
    r = tslq.rademacher(g, (16, n))
    assert set(np.unique(_np(r))) == {-1.0, 1.0} and r.dtype == torch.float64
    own = float(tslq.slq_logdet(tmv, n, torch.Generator().manual_seed(0),
                                num_probes=16, k=32))
    assert own == float(tslq.slq_logdet_from_probes(tmv, r, k=32))


# ----- inference/matrix_free.py ---------------------------------------------------

@pytest.mark.parametrize("rank", [0, 48])
def test_nll_and_grad_fed_jax_probes_match_jax(rank):
    nugget = 1e-2 if rank == 0 else 1e-4
    (jx, jy, jh, jp), (tx, ty, th, tp) = _problem(nugget=nugget)
    kw = dict(num_probes=8, lanczos_k=24, cg_tol=1e-10, cg_maxiter=2000,
              chunk=64, precond_rank=rank)
    key = jax.random.key(1)
    jnll, jg, jaux = jax.jit(lambda p: jmf.nll_and_grad_matrix_free(
        p, jx, jy, jh, key, jmf.MFConfig(**kw)))(jp)
    tnll, tg, taux = tmf.nll_and_grad_from_probes(
        tp, tx, ty, th, _jax_probes(key, 160, 8), tmf.MFConfig(**kw))
    np.testing.assert_allclose(float(tnll), float(jnll), rtol=1e-8)
    for name in ("log_delta", "log_sigma2", "log_nugget"):
        np.testing.assert_allclose(_np(getattr(tg, name)),
                                   np.asarray(getattr(jg, name)), rtol=1e-8,
                                   atol=1e-12, err_msg=name)
    for name in ("sigma2", "beta", "e", "resid", "logdet_a"):
        np.testing.assert_allclose(_np(taux[name]), np.asarray(jaux[name]),
                                   rtol=1e-8, err_msg=name)
    assert taux["cg_info"]["iters"] == int(jaux["cg_info"]["iters"])
    assert float(taux["cg_info"]["rel_resid"].max()) < 1e-10


@fp32_exact
def _t1_minus_2quad(m, x1, x2):
    """The JAX package's form of sum_ij M_ij (x1_il - x2_jl)^2
    (`matrix_free.py:134-157`): row and column sums against x^2, minus
    twice x1^T M x2, whose terms cancel."""
    return (m.sum(-1) @ (x1 * x1) + m.sum(-2) @ (x2 * x2)
            - 2.0 * torch.sum(x1 * (m @ x2), dim=0))


def test_fp32_delta_gradient_pass_within_budget_t1_minus_2quad_breaks_it(
        monkeypatch):
    """The delta-gradient pass in fp32, fed the fp64 solves rounded to
    fp32, against the same sums in fp64 of the same fp32 blocks M: within
    0.5 eps32 sum_ij |M_ij| (x_il - x_jl)^2 a dimension. The JAX
    package's t1 - 2 quad on the same blocks breaks that budget."""
    (_, _, _, _), (tx, ty, th, tp) = _problem(n=300, delta=(0.2, 0.2))
    cfg = tmf.MFConfig(num_probes=8, lanczos_k=24, cg_tol=1e-10,
                       cg_maxiter=2000, chunk=64)
    probes = tmf.matrix_free_probes(torch.Generator().manual_seed(0), 300,
                                    cfg)
    seen = {}
    real_pass = tmf._grad_log_delta

    def spy(*args):
        seen["args"] = args
        return real_pass(*args)

    monkeypatch.setattr(tmf, "_grad_log_delta", spy)
    tmf.nll_and_grad_from_probes(tp, tx, ty, th, probes, cfg)
    params, x, left, right, chunk = seen["args"]
    p32 = GPParams(*(v.float() for v in params))
    blocks = []
    real_sum = tmf.sq_diff_contraction

    def keep(m, a, b):
        blocks.append((m, a, b))
        return real_sum(m, a, b)

    monkeypatch.setattr(tmf, "sq_diff_contraction", keep)
    g32 = real_pass(p32, x.float(), left.float(), right.float(), chunk)
    assert g32.dtype == torch.float32 and len(blocks) == 5
    scale = 2.0 / torch.exp(2.0 * p32.log_delta.double())

    def total(form, dtype):
        return scale * sum(form(m.to(dtype), a.to(dtype), b.to(dtype)).double()
                           for m, a, b in blocks)

    want = total(real_sum, torch.float64)
    unit = EPS32 * total(lambda m, a, b: real_sum(m.abs(), a, b),
                         torch.float64)
    err_port = ((g32.double() - want).abs() / unit).max()
    err_jax = ((total(_t1_minus_2quad, torch.float32) - want).abs()
               / unit).max()
    assert err_port <= 0.5, float(err_port)
    assert err_jax > 0.5, float(err_jax)


def test_mle_fit_matrix_free_fed_jax_probes_matches_jax():
    (jx, jy, jh, _), (tx, ty, th, _) = _problem()
    cfg_kw = dict(num_probes=8, lanczos_k=24, cg_tol=1e-8, cg_maxiter=1000,
                  chunk=64)
    init = (np.log([0.5, 0.6]), 0.0, np.log(3e-3))
    jinit = jmf.GPParams(*(jnp.asarray(v, dtype=jnp.float64) for v in init))
    tinit = GPParams(*(torch.tensor(v, dtype=torch.float64) for v in init))
    key = jax.random.key(1)
    kw = dict(steps=10, learning_rate=0.03, min_nugget=1e-4)
    jpar, jinfo = jmf.mle_fit_matrix_free(key, jx, jy, jh, init=jinit,
                                          cfg=jmf.MFConfig(**cfg_kw), **kw)
    k_probe, _ = jax.random.split(key)
    tpar, tinfo = tmf.mle_fit_from_probes(
        _jax_probes(k_probe, 160, 8), tx, ty, th, init=tinit,
        cfg=tmf.MFConfig(**cfg_kw), **kw)
    np.testing.assert_allclose(_np(tinfo["nll_trace"]),
                               np.asarray(jinfo["nll_trace"]), rtol=1e-8)
    for name in ("log_delta", "log_sigma2", "log_nugget"):
        np.testing.assert_allclose(_np(getattr(tpar, name)),
                                   np.asarray(getattr(jpar, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)


# ----- tests/test_matrix_free.py's checks, on the port ------------------------------

def test_port_slq_logdet_matches_dense():
    _, (tx, _, _, _) = _problem()
    p = tparams(np.full(2, 0.7), nugget=1e-2, dtype=torch.float64,
                device="cpu")
    true = float(torch.linalg.slogdet(gaussian_corr_self(tx, p))[1])
    est = float(tslq.slq_logdet(tcg.make_corr_matvec(tx, p, chunk=64), 160,
                                torch.Generator().manual_seed(0),
                                num_probes=32, k=32))
    assert abs(est - true) / abs(true) < 0.02


def _exact_nll_and_grad(p, x, y, h):
    leaves = [v.clone().requires_grad_(True) for v in p]
    val = tgp.nll_mucm(GPParams(*leaves), x, y, h)
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), np.concatenate([_np(grads[0]), [float(grads[2])]])


def test_port_nll_and_grad_match_exact():
    _, (tx, ty, th, tp) = _problem()
    val, ge = _exact_nll_and_grad(tp, tx, ty, th)
    cfg = tmf.MFConfig(num_probes=64, lanczos_k=40, cg_tol=1e-10,
                       cg_maxiter=2000, chunk=64)
    nll, g, aux = tmf.nll_and_grad_matrix_free(
        tp, tx, ty, th, torch.Generator().manual_seed(1), cfg)
    assert abs(float(nll) - val) / abs(val) < 0.01
    gm = np.concatenate([_np(g.log_delta), [float(g.log_nugget)]])
    cos = gm @ ge / (np.linalg.norm(gm) * np.linalg.norm(ge))
    assert cos > 0.95, (cos, gm, ge)
    ratio = np.linalg.norm(gm) / np.linalg.norm(ge)
    assert 0.6 < ratio < 1.6, (ratio, gm, ge)
    assert float(aux["cg_info"]["rel_resid"].max()) < 1e-8


def test_port_preconditioned_nll_matches_exact():
    _, (tx, ty, th, tp) = _problem(nugget=1e-4)
    val = float(tgp.nll_mucm(tp, tx, ty, th))
    cfg = tmf.MFConfig(num_probes=16, lanczos_k=32, cg_tol=1e-9,
                       cg_maxiter=2000, chunk=64, precond_rank=48)
    nll, _, aux = tmf.nll_and_grad_matrix_free(
        tp, tx, ty, th, torch.Generator().manual_seed(2), cfg)
    assert abs(float(nll) - val) / abs(val) < 0.01, (float(nll), val)
    assert aux["cg_info"]["iters"] < 200


def test_port_matrix_free_mle_approaches_exact_optimum():
    _, (tx, ty, th, _) = _problem()
    mcfg = dict(mode="mucm", train_nugget=True, nugget_bounds=(1e-6, 1.0))
    _, info = mle_fit(torch.Generator().manual_seed(0), tx, ty, th,
                      MLEConfig(tries=8, **mcfg))
    p_sub, _ = mle_fit(torch.Generator().manual_seed(2), tx[:60], ty[:60],
                       th[:60], MLEConfig(tries=4, **mcfg))
    cfg = tmf.MFConfig(num_probes=8, lanczos_k=24, cg_tol=1e-8,
                       cg_maxiter=1000, chunk=64)
    p_mf, _ = tmf.mle_fit_matrix_free(
        torch.Generator().manual_seed(1), tx, ty, th, steps=100,
        learning_rate=0.03, min_nugget=1e-4, init=p_sub, cfg=cfg)
    nll_ref = float(info["best_nll"])
    nll_mf = float(tgp.nll_mucm(p_mf, tx, ty, th))
    assert nll_mf < nll_ref + 10.0, (nll_mf, nll_ref)


def test_fp32_floor_tool_agrees_with_fp64_above_the_floor():
    """tools/mf_fp32_floor.case on the CPU at n = 256: at a nugget far
    above 0.25 eps32 n, fp32 and fp64 evaluations from the same probes
    agree, the fp32 fit's true residual is small and the mean is finite."""
    from gp_emu_uqsa_torch.tools import mf_fp32_floor

    r = mf_fp32_floor.case(256, 1e-2, [0.7, 0.9], torch.device("cpu"), 64)
    assert r["grad_cosine"] > 0.999, r
    assert abs(r["grad_norm_ratio"] - 1.0) < 0.01, r
    assert r["nll_rel_diff"] < 1e-5, r
    assert r["fit_true_resid"] < 1e-4, r
    assert np.isfinite(r["rmse"]) and r["rmse"] < 0.05, r


# ----- on the card (skips elsewhere) -----------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_matrix_free_fp32_through_k3_and_k2(cuda_device):
    """fp32 on the card: make_corr_matvec is one K3 launch a call and
    agrees with the chunked plain matvec; one evaluation launches K3 from
    the CG and Lanczos loops and K2 from the gradient pass, and its NLL
    is within 1e-3 of the fp64 CPU evaluation from the same probes."""
    from gp_emu_uqsa_torch.ops import kernel_matrix, serve

    n = 1024
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(n, 2))
    y = np.sin(3 * x[:, 0]) + np.sin(2 * x[:, 1])
    cfg = tmf.MFConfig(num_probes=8, lanczos_k=24, cg_tol=1e-5,
                       cg_maxiter=500, chunk=256, precond_rank=48)
    probes = tmf.matrix_free_probes(torch.Generator().manual_seed(0), n, cfg)
    out = {}
    for dev, dt in ((torch.device("cpu"), torch.float64),
                    (cuda_device, torch.float32)):
        tx = torch.tensor(x, dtype=dt, device=dev)
        ty = torch.tensor(y, dtype=dt, device=dev)
        p = tparams(np.full(2, 0.5), nugget=1e-2, dtype=dt, device=dev)
        if dev.type == "cuda":
            v = torch.randn((n, 12), device=dev)
            serve.corr_matvec.launches = 0
            got = tcg.make_corr_matvec(tx, p)(v)
            assert serve.corr_matvec.launches == 1
            want = tcg.corr_times_chunked(tx, tx, p, v, 256) + p.nugget * v
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                       atol=1e-4)
            serve.corr_matvec.launches = 0
            kernel_matrix.gaussian_corr_fused.launches = 0
        out[dt] = tmf.nll_and_grad_from_probes(
            p, tx, ty, tbasis(tx, linear_basis(2)),
            tuple(t.to(device=dev, dtype=dt) for t in probes), cfg)
    assert serve.corr_matvec.launches > 0
    assert kernel_matrix.gaussian_corr_fused.launches == n // 256
    nll64, nll32 = float(out[torch.float64][0]), float(out[torch.float32][0])
    assert abs(nll32 - nll64) / abs(nll64) < 1e-3
