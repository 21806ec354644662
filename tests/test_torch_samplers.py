"""The port's samplers against the JAX package's on the same inputs.

fp64 on the CPU, n <= 200, one thread. Tolerances:
- the GP log density and its gradient: rtol 1e-7 (the same formulas
  through different LAPACK builds, A^-1 on a problem with kappa(A) about
  1e6, as in tests/test_torch_train.py);
- one HMC and one NUTS transition fed the JAX package's own draws (the
  key splits of `hmc.py:93-106` and `nuts.py:58-59, 97-98, 123, 132`):
  z and the accept statistic at rtol 1e-10, the divergence flags exactly;
- the drivers with one deterministic step function written in both
  packages: rtol 1e-12 (only the order of scalar arithmetic differs);
- split R-hat and ESS: rtol 1e-12;
- statistics of the port's own chains: the bounds of tests/test_nuts.py
  and tests/test_hmc.py on Gaussian targets, and 5 Monte-Carlo standard
  errors (sd / sqrt(ESS)) of a quadrature of the JAX log density on a
  80 x 80 grid for a d = 2 GP posterior.
At the failing point (fp32, n = 200, d = 2, nugget 1e-6) both packages give
the density -1e12 and a non-finite gradient, and a trajectory that
crosses into that region is rejected by both.
"""
import functools
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis, linear_basis
from gp_emu_uqsa_tpu.inference import MLEConfig as JMLEConfig
from gp_emu_uqsa_tpu.inference import hmc as jhmc
from gp_emu_uqsa_tpu.inference import nuts as jnuts

from gp_emu_uqsa_torch.basis import basis_matrix as tbasis
from gp_emu_uqsa_torch.inference import MLEConfig as TMLEConfig
from gp_emu_uqsa_torch.inference import hmc as thmc
from gp_emu_uqsa_torch.inference import nuts as tnuts

import oracle

torch.set_num_threads(1)


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _gp_pair(n, d, mode="mucm", train_nugget=False, nugget=1e-6, seed=3,
             dtype=np.float64, device="cpu"):
    """(JAX log density, port log density) on the same data."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(dtype)
    y = (np.sin(3 * x[:, 0]) + x[:, 1] * x[:, -1]).astype(dtype)
    kw = dict(mode=mode, train_nugget=train_nugget, nugget=nugget)
    jx = jnp.asarray(x)
    jld = jhmc.make_gp_logdensity(jx, jnp.asarray(y),
                                  jbasis(jx, linear_basis(d)),
                                  JMLEConfig(**kw))
    tx = torch.tensor(x, device=device)
    tld = thmc.make_gp_logdensity(tx, torch.tensor(y, device=device),
                                  tbasis(tx, linear_basis(d)),
                                  TMLEConfig(**kw))
    return jld, tld


def _gaussian_pair():
    """A strongly correlated 2-D Gaussian in both packages."""
    prec = np.linalg.inv(np.array([[1.0, 0.95], [0.95, 1.0]]))
    tprec = _t(prec)
    return (lambda z: -0.5 * z @ jnp.asarray(prec) @ z,
            lambda z: -0.5 * torch.einsum("ci,ij,cj->c", z, tprec, z))


def _jax_value_and_grad(jld):
    """The JAX package's batched value and gradient, compiled whole (as
    its samplers run it; its eager op-by-op path rounds otherwise)."""
    return jax.jit(jax.vmap(jax.value_and_grad(jld)))


def _ld_grad(tld):
    return lambda z: thmc.value_and_grad(tld, z)


# ----- the log density ----------------------------------------------------------

@pytest.mark.parametrize("mode, train_nugget, z", [
    ("mucm", False, [[0.0, 0.0, 0.0], [-1.0, 0.3, 0.5], [1.0, 1.0, -2.0]]),
    ("gp4ml", True, [[0.0, 0.0, 0.0, -1.0, -8.0], [-1.0, 0.3, 0.5, 0.2, -6.0],
                     [1.0, 1.0, -2.0, 0.0, -3.0]]),
])
def test_gp_logdensity_matches_jax(mode, train_nugget, z):
    jld, tld = _gp_pair(60, 3, mode, train_nugget)
    jv, jg = _jax_value_and_grad(jld)(jnp.asarray(z))
    tv, tg = thmc.value_and_grad(tld, _t(z))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-7)
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-7,
                               atol=1e-7 * float(np.abs(jg).max()))


def test_gp_logdensity_failed_factor_gives_nan_gradient_like_jax():
    """The fault the port's `_NllMucm` alone would hide: where the plain
    factor fails, the JAX density is -1e12 with a NaN gradient; `_NllMucm`
    gives such rows a zero gradient, and `make_gp_logdensity` restores
    the NaN so that samplers reject."""
    jld, tld = _gp_pair(200, 2, nugget=1e-6, dtype=np.float32)
    z = np.array([[0.0, 0.0], [3.0, 3.0], [6.0, 6.0]], np.float32)
    jv, jg = _jax_value_and_grad(jld)(jnp.asarray(z))
    tv, tg = thmc.value_and_grad(tld, _t(z, torch.float32))
    np.testing.assert_array_equal(np.asarray(jv), np.float32(-1e12))
    np.testing.assert_array_equal(_np(tv), np.float32(-1e12))
    assert not np.isfinite(np.asarray(jg)).any()
    assert not np.isfinite(_np(tg)).any()
    # a healthy row in the same batch keeps its finite gradient
    tv, tg = thmc.value_and_grad(tld, _t([[-3.0, -3.0], [3.0, 3.0]],
                                         torch.float32))
    assert np.isfinite(_np(tg)[0]).all() and not np.isfinite(_np(tg)[1]).any()


# ----- one transition fed the JAX package's draws ------------------------------

def _jax_hmc_draws(key, shape, dtype=jnp.float64):
    """hmc.py:93-106: kp, ka = split(key); normals (chains, dim), uniforms."""
    kp, ka = jax.random.split(key)
    return (_t(jax.random.normal(kp, shape, dtype)),
            _t(jax.random.uniform(ka, (shape[0],), dtype)))


def _one_chain_nuts_draws(key, dim, max_depth, dtype):
    """nuts.py:58-59 (momenta), 97-98 (direction, subtree merge), 123 and
    132 (one key a leaf) for one chain."""
    k_mom, k_tree = jax.random.split(key)

    def leaf(k, _):
        k, k_mult = jax.random.split(k)
        return k, jax.random.uniform(k_mult, dtype=dtype)

    def depth(k, _):
        k, k_dir, k_acc, k_sub = jax.random.split(k, 4)
        _, u_leaf = jax.lax.scan(leaf, k_sub, None, length=1 << (max_depth - 1))
        return k, (jax.random.bernoulli(k_dir),
                   jax.random.uniform(k_acc, dtype=dtype), u_leaf)

    _, (go, u_sub, u_leaf) = jax.lax.scan(depth, k_tree, None,
                                          length=max_depth)
    return jax.random.normal(k_mom, (dim,), dtype), go, u_sub, u_leaf


@functools.cache
def _jax_nuts_draws_fn(dim, max_depth, dtype):
    return jax.jit(jax.vmap(partial(_one_chain_nuts_draws, dim=dim,
                                    max_depth=max_depth, dtype=dtype)))


def _jax_nuts_draws(key, chains, dim, max_depth, dtype=jnp.float64):
    """The draws of JAX `make_nuts_step`'s `step` (one key a chain)."""
    r0, go, u_sub, u_leaf = _jax_nuts_draws_fn(dim, max_depth, dtype)(
        jax.random.split(key, chains))
    tdtype = torch.float64 if dtype == jnp.float64 else torch.float32
    return tnuts.NutsDraws(_t(r0, tdtype), torch.tensor(np.asarray(go)),
                           _t(u_sub, tdtype), _t(u_leaf, tdtype))


def _target(name):
    """(JAX log density, port log density, z (6, dim), eps, inv_mass)."""
    rng = np.random.default_rng(0)
    if name == "gaussian":
        jld, tld = _gaussian_pair()
        return (jld, tld, rng.standard_normal((6, 2)), 0.3,
                np.array([1.0, 0.7]))
    jld, tld = _gp_pair(40, 2, nugget=1e-3)
    z = np.log([0.3, 0.5]) + 0.2 * rng.standard_normal((6, 2))
    return jld, tld, z, 0.15, np.array([0.4, 0.9])


@pytest.mark.parametrize("target", ["gaussian", "gp"])
def test_hmc_transition_matches_jax_from_its_draws(target):
    jld, tld, z, eps, im = _target(target)
    cfg = thmc.HMCConfig(n_leapfrog=8)
    jstep = jax.jit(jhmc.make_hmc_step(jld, jhmc.HMCConfig(n_leapfrog=8),
                                       jnp.float64))
    for seed in range(3):
        key = jax.random.key(seed)
        jz, ja, jd = jstep(jnp.asarray(z), key, eps, jnp.asarray(im))
        noise, u = _jax_hmc_draws(key, z.shape)
        tz, ta, td = thmc._hmc_transition(_ld_grad(tld), _t(z), noise, u,
                                          _t(eps), _t(im), cfg)
        np.testing.assert_allclose(_np(tz), np.asarray(jz), rtol=1e-10)
        np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=1e-10,
                                   atol=1e-300)
        np.testing.assert_array_equal(_np(td), np.asarray(jd))


@pytest.mark.parametrize("target", ["gaussian", "gp"])
def test_nuts_transition_matches_jax_from_its_draws(target):
    jld, tld, z, eps, im = _target(target)
    max_depth = 4
    jstep = jax.jit(jnuts.make_nuts_step(jld, max_depth=max_depth))
    counts = tnuts.new_counts()
    for seed in range(3):
        key = jax.random.key(seed)
        jz, ja, jd = jstep(jnp.asarray(z), key, eps, jnp.asarray(im))
        draws = _jax_nuts_draws(key, z.shape[0], z.shape[1], max_depth)
        tz, ta, td = tnuts._nuts_transition(_ld_grad(tld), _t(z), draws,
                                            _t(eps), _t(im), max_depth,
                                            1000.0, counts)
        np.testing.assert_allclose(_np(tz), np.asarray(jz), rtol=1e-10)
        np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=1e-10)
        np.testing.assert_array_equal(_np(td), np.asarray(jd))
    # one host sync a leaf tried; the useful chain-leaves within the slots
    assert counts["transitions"] == 3
    assert counts["evaluations"] == counts["leaves"] + 3
    assert counts["leaves"] <= counts["host_syncs"] <= counts["leaves"] + 3
    assert 0 < int(counts["useful_chain_leaves"]) <= counts["chain_leaves"]
    assert counts["chain_leaves"] == 6 * counts["leaves"]


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_trajectory_into_a_failed_factor_is_rejected_by_both(sampler):
    """Chains start where the fp32 factor holds (log delta -2.5) and run
    toward the region where it fails (log delta > -1.5): those whose
    trajectory touches it keep their start, accept nothing and diverge,
    in both packages."""
    jld, tld = _gp_pair(200, 2, nugget=1e-6, dtype=np.float32)
    chains = 4
    z = np.full((chains, 2), -2.5, np.float32)
    eps, im = 0.6, np.ones(2, np.float32)
    key = jax.random.key(4)
    if sampler == "hmc":
        jstep = jhmc.make_hmc_step(jld, jhmc.HMCConfig(n_leapfrog=8),
                                   jnp.float32)
        noise, u = _jax_hmc_draws(key, z.shape, jnp.float32)
        noise, u = noise.float(), u.float()
        tz, ta, td = thmc._hmc_transition(
            _ld_grad(tld), _t(z, torch.float32), noise, u,
            _t(eps, torch.float32), _t(im, torch.float32),
            thmc.HMCConfig(n_leapfrog=8))
    else:
        jstep = jnuts.make_nuts_step(jld, max_depth=4)
        draws = _jax_nuts_draws(key, chains, 2, 4, jnp.float32)
        tz, ta, td = tnuts._nuts_transition(
            _ld_grad(tld), _t(z, torch.float32), draws,
            _t(eps, torch.float32), _t(im, torch.float32), 4, 1000.0)
    jz, ja, jd = jax.jit(jstep)(jnp.asarray(z), key, eps, jnp.asarray(im))
    jd, td = np.asarray(jd), _np(td)
    np.testing.assert_array_equal(td, jd)
    assert jd.any(), "no trajectory reached the failed region"
    np.testing.assert_array_equal(np.asarray(jz)[jd], z[jd])
    np.testing.assert_array_equal(_np(tz)[td], z[td])
    if sampler == "hmc":
        np.testing.assert_array_equal(np.asarray(ja)[jd], 0.0)
        np.testing.assert_array_equal(_np(ta)[td], 0.0)


# ----- the drivers ------------------------------------------------------------------

def _jax_det_step(z, key, eps, inv_mass):
    z_new = 0.9 * z + eps * inv_mass * jnp.cos(z)
    acc = jnp.minimum(1.0, jnp.exp(-eps * (1.0 + 0.1 * jnp.sum(z_new**2, 1))))
    return z_new, acc, acc < 0.3


def _torch_det_step(z, generator, eps, inv_mass):
    z_new = 0.9 * z + eps * inv_mass * torch.cos(z)
    acc = torch.clamp(torch.exp(-eps * (1.0 + 0.1 * torch.sum(z_new**2, 1))),
                      max=1.0)
    return z_new, acc, acc < 0.3


def test_adaptive_mcmc_and_mcmc_continue_match_jax():
    """Stage boundaries at 37 // 4 = 9 and 3 * 37 // 4 = 27, thin 2."""
    z0 = np.random.default_rng(1).standard_normal((5, 3))
    jcfg = jhmc.HMCConfig(n_warmup=37, n_samples=21, thin=2,
                          init_step_size=0.3)
    tcfg = thmc.HMCConfig(n_warmup=37, n_samples=21, thin=2,
                          init_step_size=0.3)
    js, jst = jhmc.adaptive_mcmc(jax.random.key(0), _jax_det_step,
                                 jnp.asarray(z0), jcfg)
    ts, tst = thmc.adaptive_mcmc(None, _torch_det_step, _t(z0), tcfg)
    assert ts.shape == js.shape == (5, 11, 3)
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-12)
    for k in ("step_size", "inv_mass", "accept_rate", "divergence_rate",
              "warmup_accept_trace"):
        np.testing.assert_allclose(_np(tst[k]), np.asarray(jst[k]),
                                   rtol=1e-12, err_msg=k)
    assert not np.allclose(np.asarray(jst["inv_mass"]), 1.0)
    z = np.asarray(js)[:, -1]
    js2, jst2, _ = jhmc.mcmc_continue(
        jax.random.key(1), _jax_det_step, jnp.asarray(z), jst["step_size"],
        jst["inv_mass"], 9, thin=2)
    ts2, tst2, _ = thmc.mcmc_continue(
        None, _torch_det_step, _t(z), tst["step_size"], tst["inv_mass"], 9,
        thin=2)
    np.testing.assert_allclose(_np(ts2), np.asarray(js2), rtol=1e-12)
    for k in ("accept_rate", "divergence_rate"):
        np.testing.assert_allclose(_np(tst2[k]), np.asarray(jst2[k]),
                                   rtol=1e-12, err_msg=k)


def test_split_rhat_and_ess_match_jax():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((4, 301, 3)).cumsum(1) * 0.1 + rng.standard_normal(
        (4, 301, 3))
    np.testing.assert_allclose(_np(thmc.split_rhat(_t(s))),
                               np.asarray(jhmc.split_rhat(jnp.asarray(s))),
                               rtol=1e-12)
    np.testing.assert_allclose(thmc.ess(_t(s)), jhmc.ess(jnp.asarray(s)),
                               rtol=1e-12)


# ----- statistics of the port's own chains --------------------------------------------

def _gaussian_3d():
    var = _t([0.5, 4.0, 0.02])
    mean = _t([1.0, -2.0, 0.3])
    return var, mean, lambda z: -0.5 * torch.sum((z - mean) ** 2 / var, -1)


def test_nuts_gaussian_target_moments():
    var, mean, ld = _gaussian_3d()
    gen = torch.Generator().manual_seed(0)
    z0 = torch.randn((6, 3), generator=gen, dtype=torch.float64)
    cfg = thmc.HMCConfig(n_warmup=300, n_samples=500, init_step_size=0.2)
    samples, stats = tnuts.nuts_sample(gen, ld, z0, cfg, max_depth=7)
    flat = _np(samples).reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(0), _np(mean), atol=0.25)
    np.testing.assert_allclose(flat.var(0), _np(var), rtol=0.35)
    assert float(stats["divergence_rate"]) < 0.05
    assert np.all(_np(thmc.split_rhat(samples)) < 1.15)
    counts = stats["counts"]
    assert counts["transitions"] == 800
    assert int(counts["useful_chain_leaves"]) <= counts["chain_leaves"]


def test_hmc_gaussian_target_moments_and_continue():
    var, mean, ld = _gaussian_3d()
    gen = torch.Generator().manual_seed(1)
    z0 = torch.randn((8, 3), generator=gen, dtype=torch.float64)
    cfg = thmc.HMCConfig(n_warmup=400, n_samples=300, n_leapfrog=8,
                         init_step_size=0.2)
    samples, stats = thmc.hmc_sample(gen, ld, z0, cfg)
    seg, seg_stats, gen = thmc.hmc_continue(
        gen, ld, samples[:, -1], stats["step_size"], stats["inv_mass"], 300,
        cfg)
    flat = np.concatenate([_np(samples), _np(seg)], 1).reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(0), _np(mean), atol=0.25)
    np.testing.assert_allclose(flat.var(0), _np(var), rtol=0.35)
    assert 0.6 < float(stats["accept_rate"]) <= 1.0
    assert float(seg_stats["accept_rate"]) > 0.5
    assert float(stats["divergence_rate"]) < 0.05
    assert np.all(_np(thmc.split_rhat(samples)) < 1.15)
    inv_mass = _np(stats["inv_mass"])
    assert inv_mass[1] > inv_mass[2]


def test_nuts_gp_posterior_within_5_mcse_of_quadrature():
    """NUTS on a d = 2 GP posterior (n = 30) against the JAX log density
    integrated on an 80 x 80 grid of log delta."""
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(30, 2))
    y = np.linalg.cholesky(oracle.corr_self(x, np.array([0.4, 0.7]), 1e-6)) \
        @ rng.standard_normal(30)
    jx = jnp.asarray(x)
    jld = jhmc.make_gp_logdensity(jx, jnp.asarray(y),
                                  jbasis(jx, linear_basis(2)),
                                  JMLEConfig(nugget=1e-6))
    tx = _t(x)
    tld = thmc.make_gp_logdensity(tx, _t(y), tbasis(tx, linear_basis(2)),
                                  TMLEConfig(nugget=1e-6))
    gen = torch.Generator().manual_seed(5)
    z0 = float(np.log(0.5)) + 0.1 * torch.randn(
        (8, 2), generator=gen, dtype=torch.float64)
    cfg = thmc.HMCConfig(n_warmup=200, n_samples=400, init_step_size=0.1)
    samples, stats = tnuts.nuts_sample(gen, tld, z0, cfg, max_depth=6)
    draws = _np(samples)
    assert np.isfinite(draws).all()
    assert float(stats["divergence_rate"]) < 0.05
    grid = np.linspace(-3.5, 2.5, 80)
    g0, g1 = np.meshgrid(grid, grid, indexing="ij")
    pts = np.stack([g0.ravel(), g1.ravel()], 1)
    logp = np.asarray(jax.jit(jax.vmap(jld))(jnp.asarray(pts)))
    w = np.exp(logp - logp.max())
    w /= w.sum()
    # the box holds the mass: its rim carries a negligible weight
    rim = (np.abs(pts - grid[0]) < 1e-12) | (np.abs(pts - grid[-1]) < 1e-12)
    assert w[rim.any(1)].sum() < 1e-6
    q_mean = w @ pts
    q_sd = np.sqrt(w @ (pts - q_mean) ** 2)
    flat = draws.reshape(-1, 2)
    mcse = flat.std(0) / np.sqrt(thmc.ess(draws))
    assert np.all(np.abs(flat.mean(0) - q_mean) < 5 * mcse), (
        flat.mean(0), q_mean, mcse)
    assert np.all(np.abs(flat.std(0) - q_sd) < 5 * mcse), (
        flat.std(0), q_sd, mcse)


# ----- on the card (skips elsewhere) --------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_nuts_transition_matches_the_cpu(cuda_device):
    """One NUTS transition from the same draws on the card and the CPU
    (fp64): z and the accept statistic within 1e-10, the flags and the
    leaf counts equal."""
    rng = np.random.default_rng(0)
    z = _t(np.log([0.3, 0.5, 0.4]) + 0.2 * rng.standard_normal((8, 3)))
    draws = tnuts._nuts_draws(torch.Generator().manual_seed(0), z, 5)
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        _, tld = _gp_pair(256, 3, nugget=1e-4, device=dev)
        counts = tnuts.new_counts()
        res = tnuts._nuts_transition(
            _ld_grad(tld), z.to(dev),
            tnuts.NutsDraws(*(t.to(dev) for t in draws)), _t(0.1).to(dev),
            torch.ones(3, dtype=torch.float64, device=dev), 5, 1000.0, counts)
        out.append((*res, counts["leaves"]))
    (cz, ca, cd, cl), (gz, ga, gd, gl) = out
    np.testing.assert_allclose(_np(gz), _np(cz), rtol=1e-10)
    np.testing.assert_allclose(_np(ga), _np(ca), rtol=1e-10)
    np.testing.assert_array_equal(_np(gd), _np(cd))
    assert gl == cl
