"""The port's Bayesian workflow against the JAX package on the same inputs.

fp64 on the CPU, n <= 60, one thread. Tolerances:
- `predict_marginalized` and `predict_bayes` fed the same hyperparameter
  draws, and `sample_posterior` fed the JAX package's own normals and
  chi-square draws (`gp.py:475-513`'s key split): rtol 1e-8 (fits and
  predictions through different LAPACK builds on mildly conditioned
  problems, as in tests/test_torch_emulator.py);
- the port's own `sample_posterior` draws against `predict`'s mean and
  covariance: 5 Monte-Carlo standard errors of the mean, 10% on the
  covariance's diagonal;
- `train_bayes` -> `predict_bayes` on tests/test_workflow.py's problem:
  its bounds (accept rate > 0.4, the mean within 0.3 of the truth);
- checkpoints: arrays and generator state bit for bit, and a segment
  rerun from its checkpoint equal bit for bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu import gp as jgp
from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis, linear_basis
from gp_emu_uqsa_tpu.emulator import Emulator as JEmulator
from gp_emu_uqsa_tpu.inference import MLEConfig as JMLEConfig
from gp_emu_uqsa_tpu.inference import hmc as jhmc
from gp_emu_uqsa_tpu.kernels import make_params as jparams
from gp_emu_uqsa_tpu.utils.checkpoint import save_hmc_state as jsave_hmc

from gp_emu_uqsa_torch import Emulator as TEmulator
from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch.basis import basis_matrix as tbasis
from gp_emu_uqsa_torch.inference import MLEConfig as TMLEConfig
from gp_emu_uqsa_torch.inference import hmc as thmc
from gp_emu_uqsa_torch.inference import nuts as tnuts
from gp_emu_uqsa_torch.kernels import params_from_numpy
from gp_emu_uqsa_torch.utils import load_hmc_state, save_hmc_state


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _problem(n=40, d=2, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, -1]
    xs = rng.uniform(size=(9, d))
    return x, y, xs


def test_predict_marginalized_matches_jax():
    x, y, xs = _problem()
    spec = linear_basis(2)
    draws = np.log([0.4, 0.6]) + 0.15 * np.random.default_rng(1) \
        .standard_normal((3, 11, 2))
    jcfg, tcfg = JMLEConfig(nugget=1e-6), TMLEConfig(nugget=1e-6)
    jm, jv = jhmc.predict_marginalized(
        jnp.asarray(draws), jnp.asarray(x), jnp.asarray(y),
        jbasis(jnp.asarray(x), spec), jnp.asarray(xs),
        jbasis(jnp.asarray(xs), spec), jcfg, max_draws=8)
    tx, txs = _t(x), _t(xs)
    tm, tv = thmc.predict_marginalized(
        _t(draws), tx, _t(y), tbasis(tx, spec), txs, tbasis(txs, spec), tcfg,
        max_draws=8)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-8)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-8)


def _fits(x, y, xs, spec, nugget=1e-4):
    jx, jxs = jnp.asarray(x), jnp.asarray(xs)
    jh, jhs = jbasis(jx, spec), jbasis(jxs, spec)
    jst = jgp.fit(jparams([0.4, 0.6], nugget=nugget, dtype=jnp.float64), jx,
                  jnp.asarray(y), jh)
    tx, txs = _t(x), _t(xs)
    th, ths = tbasis(tx, spec), tbasis(txs, spec)
    tst = tgp.fit(params_from_numpy(np.log([0.4, 0.6]), 0.0, np.log(nugget),
                                    device="cpu"), tx, _t(y), th)
    return (jst, jx, jh, jxs, jhs), (tst, tx, th, txs, ths)


@pytest.mark.parametrize("student_t", [True, False])
def test_sample_posterior_matches_jax_from_its_draws(student_t):
    x, y, xs = _problem()
    (jst, jx, jh, jxs, jhs), (tst, tx, th, txs, ths) = _fits(
        x, y, xs, linear_basis(2))
    key = jax.random.key(7)
    n_draws = 5
    want = jgp.sample_posterior(key, jst, jx, jh, jxs, jhs, n_draws,
                                student_t=student_t)
    # gp.py:506-512: zkey, gkey = split(key); z normals, g = 2 gamma(dof/2)
    zkey, gkey = jax.random.split(key)
    dof = x.shape[0] - 3
    z = jax.random.normal(zkey, (n_draws, xs.shape[0]), jnp.float64)
    g = 2.0 * jax.random.gamma(gkey, 0.5 * dof, (n_draws, 1), jnp.float64)
    mean, cov = tgp.predict(tst, tx, th, txs, ths, full_cov=True)
    got = tgp.sample_posterior_from_draws(mean, cov, dof, _t(z), _t(g),
                                          student_t=student_t)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-8,
                               atol=1e-10)


def test_sample_posterior_moments_and_generator():
    x, y, xs = _problem()
    _, (tst, tx, th, txs, ths) = _fits(x, y, xs, linear_basis(2))
    mean, cov = tgp.predict(tst, tx, th, txs, ths, full_cov=True)
    n_draws = 4000
    draws = tgp.sample_posterior(torch.Generator().manual_seed(0), tst, tx,
                                 th, txs, ths, n_draws)
    again = tgp.sample_posterior(torch.Generator().manual_seed(0), tst, tx,
                                 th, txs, ths, n_draws)
    assert draws.shape == (n_draws, xs.shape[0])
    assert torch.equal(draws, again)
    sd = torch.sqrt(torch.diagonal(cov))
    err = (draws.mean(0) - mean).abs() / (sd / n_draws**0.5)
    assert float(err.max()) < 5.0, err
    emp = torch.cov(draws.T)
    np.testing.assert_allclose(_np(torch.diagonal(emp)),
                               _np(torch.diagonal(cov)), rtol=0.1)


def test_student_t_with_dof_at_most_2_raises():
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(5, 2))
    y = x[:, 0]
    spec = linear_basis(2)                      # q = 3: dof = 2
    tx = _t(x)
    # a gp4ml fit (sigma2 explicit): the Gaussian draws it allows
    st = tgp.fit(params_from_numpy(np.log([0.5, 0.5]), 0.0, np.log(1e-4),
                                   device="cpu"), tx, _t(y), tbasis(tx, spec),
                 mode="gp4ml")
    txs = _t(rng.uniform(size=(4, 2)))
    args = (st, tx, tbasis(tx, spec), txs, tbasis(txs, spec), 3)
    with pytest.raises(ValueError, match="n - q > 2"):
        tgp.sample_posterior(torch.Generator().manual_seed(0), *args)
    out = tgp.sample_posterior(torch.Generator().manual_seed(0), *args,
                               student_t=False)
    assert out.shape == (3, 4) and torch.isfinite(out).all()


def _emulator_pair(fixed_beta):
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(40, 2))
    y = np.sin(4 * x[:, 0]) + x[:, 1]
    jem = JEmulator.from_arrays(x, y, tries=3, seed=2, nugget=1e-4)
    tem = TEmulator.from_arrays(x, y, tries=3, seed=2, nugget=1e-4,
                                device="cpu")
    jem.params = jparams([0.5, 0.8], nugget=1e-4, dtype=jnp.float64)
    tem.params = params_from_numpy(np.log([0.5, 0.8]), 0.0, np.log(1e-4),
                                   device="cpu")
    if fixed_beta:
        jem.fixed_beta = np.array([0.2, 1.5, 0.7])
        tem.fixed_beta = jem.fixed_beta
    return jem, tem


@pytest.mark.parametrize("fixed_beta", [False, True])
def test_predict_bayes_from_jax_train_bayes_draws(fixed_beta):
    """JAX train_bayes draws the hyperparameters; both packages'
    predict_bayes marginalize over the same draws."""
    jem, tem = _emulator_pair(fixed_beta)
    jem.train_bayes(sampler="hmc", n_chains=3, n_warmup=8, n_samples=12,
                    key=jax.random.key(0))
    tem.hyper_samples = _t(jem.hyper_samples)
    tem.n_folded = jem.n_folded          # train_bayes trains on all data
    q = np.array([[0.3, 0.6], [0.8, 0.2], [0.05, 0.95]])
    jm, jv = jem.predict_bayes(q, max_draws=8)
    tm, tv = tem.predict_bayes(q, max_draws=8)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-8)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-8)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_train_bayes_predict_bayes(sampler):
    """tests/test_workflow.py::TestBayesFacade's problem through the port:
    MLE first, then the chains, then the marginalized prediction."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(40, 2))
    y = np.sin(4 * x[:, 0]) + x[:, 1]
    emul = TEmulator.from_arrays(x, y, tries=3, seed=2, device="cpu")
    emul.mle_config = dataclasses.replace(emul.mle_config, max_iters=40)
    with pytest.raises(RuntimeError, match="train_bayes"):
        emul.predict_bayes(x[:2])
    stats = emul.train_bayes(sampler=sampler, n_chains=4, n_warmup=100,
                             n_samples=100, max_depth=5)
    assert emul.hyper_samples.shape == (4, 100, 2)
    assert float(stats["accept_rate"]) > 0.4
    mean, var = emul.predict_bayes(np.array([[0.3, 0.6], [0.8, 0.2]]),
                                   max_draws=8)
    truth = np.sin(4 * np.array([0.3, 0.8])) + np.array([0.6, 0.2])
    assert np.all(np.abs(_np(mean) - truth) < 0.3)
    assert np.all(_np(var) >= 0)


def _gaussian_ld(z):
    return -0.5 * torch.sum((z / _t([1.0, 2.0])) ** 2, -1)


def test_hmc_state_round_trip_and_bitwise_segment_resume(tmp_path):
    gen = torch.Generator().manual_seed(0)
    cfg = thmc.HMCConfig(n_warmup=30, n_samples=1)
    warm, stats = tnuts.nuts_sample(gen, _gaussian_ld,
                                    torch.zeros((4, 2), dtype=torch.float64),
                                    cfg, max_depth=4)
    z, eps, im = warm[:, -1], stats["step_size"], stats["inv_mass"]
    save_hmc_state(tmp_path / "chain", z, eps, im, gen, meta={"segment": 0})
    seg, _, gen = tnuts.nuts_continue(gen, _gaussian_ld, z, eps, im, 12,
                                      max_depth=4)
    z2, eps2, im2, gen2, meta = load_hmc_state(tmp_path / "chain",
                                               device="cpu")
    assert meta == {"segment": 0}
    for got, want in ((z2, z), (eps2, eps), (im2, im)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    rerun, _, gen2 = tnuts.nuts_continue(gen2, _gaussian_ld, z2, eps2, im2,
                                         12, max_depth=4)
    assert torch.equal(rerun, seg)
    assert torch.equal(gen2.get_state(), gen.get_state())
    # the next segment from the returned generator continues the chain
    nxt, _, _ = thmc.hmc_continue(gen, _gaussian_ld, seg[:, -1], eps, im, 4,
                                  thmc.HMCConfig(n_leapfrog=4))
    assert nxt.shape == (4, 4, 2) and not torch.equal(nxt[:, 0], seg[:, -1])


def test_load_hmc_state_reads_a_file_of_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((3, 2))
    jsave_hmc(tmp_path / "jax_chain", jnp.asarray(z), jnp.asarray(0.25),
              jnp.asarray([1.0, 0.5]), jax.random.key(3), meta={"n": 7})
    tz, eps, im, gen, meta = load_hmc_state(tmp_path / "jax_chain",
                                            device="cpu")
    np.testing.assert_array_equal(_np(tz), z)
    assert float(eps) == 0.25
    np.testing.assert_array_equal(_np(im), [1.0, 0.5])
    assert gen is None and meta == {"n": 7}


# ----- on the card (skips elsewhere) --------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_train_bayes_predict_bayes_fp32(cuda_device):
    """fp32 on the card at n = 600 (K1 in every log-density evaluation):
    finite draws, and the marginalized prediction against the same draws
    in fp64 on the CPU."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(600, 2))
    y = np.sin(4 * x[:, 0]) + x[:, 1]
    emul = TEmulator.from_arrays(x, y, tries=2, seed=2, nugget=1e-4,
                                 dtype=torch.float32, device=cuda_device)
    emul.params = params_from_numpy(np.log([0.5, 0.8]), 0.0, np.log(1e-4),
                                    device=cuda_device, dtype=torch.float32)
    emul.train_bayes(n_chains=4, n_warmup=10, n_samples=10, max_depth=3)
    assert torch.isfinite(emul.hyper_samples).all()
    q = rng.uniform(size=(300, 2))
    mean, var = emul.predict_bayes(q, max_draws=4)
    ref = TEmulator.from_arrays(x, y, tries=2, seed=2, nugget=1e-4,
                                device="cpu")
    ref.hyper_samples = emul.hyper_samples.double().cpu()
    m64, v64 = ref.predict_bayes(q, max_draws=4)
    np.testing.assert_allclose(_np(mean), _np(m64), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(var), _np(v64), rtol=0.1, atol=1e-4)
