"""Chains over four gloo ranks: the samplers' `group`, held against the
one-process run fed the same draws, against the JAX package's shard_map
`adaptive_mcmc` with one deterministic step function (rtol 1e-12) and,
statistically, against its shard_map sampler.

The ranks are spawned once for the module; each runs every case (fp64)
and returns numpy arrays. Rank r's chains draw from
`hmc.rank_generator(generator, r)`; the one-process replays draw chain
block r from the same generator, so the sharded run (its adaptation by
all-reduce) must give the replay's chains to rounding. JAX is imported
inside the tests only.
"""
import os
import traceback

import numpy as np
import pytest
import torch

from gp_emu_uqsa_torch import Emulator
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference import MLEConfig, hmc, nuts
from gp_emu_uqsa_torch.inference.hmc import HMCConfig, rank_generator
from gp_emu_uqsa_torch.parallel import make_mesh, spawn_ranks
from gp_emu_uqsa_torch.parallel.mesh import all_gather, axis_group, group_of

torch.set_num_threads(1)

WORLD = 4
PER_RANK = 4
CHAINS = WORLD * PER_RANK
SEED = 8
VAR = np.array([1.0, 0.25])
HMC_CFG = HMCConfig(n_warmup=40, n_samples=30, n_leapfrog=4)
NUTS_CFG = HMCConfig(n_warmup=12, n_samples=6)
NUTS_DEPTH = 4
CONTINUE = 8
# tests/test_hmc.py::test_sharded_chains_match_unsharded's run and bounds
STAT_CFG = HMCConfig(n_warmup=400, n_samples=700, n_leapfrog=8)
# the deterministic adaptive_mcmc run of tests/test_torch_samplers.py: stage
# boundaries at 37 // 4 = 9 and 3 * 37 // 4 = 27, thin 2
DET_CFG = HMCConfig(n_warmup=37, n_samples=21, thin=2, init_step_size=0.3)
DET_CONTINUE = 9


def _gauss(z):
    return -0.5 * torch.sum(z * z / torch.as_tensor(VAR), -1)


def _gp_problem():
    """tests/test_hmc.py::_gp_problem."""
    import oracle
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(40, 2))
    a = oracle.corr_self(x, np.array([0.4, 0.7]), 1e-6)
    return x, np.linalg.cholesky(a) @ rng.standard_normal(40)


def _gp_density():
    x, y = _gp_problem()
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    h = basis_matrix(xt, linear_basis(2))
    return hmc.make_gp_logdensity(xt, yt, h, MLEConfig(nugget=1e-6)), xt, yt


def _z0(seed, center=0.0):
    return center + torch.as_tensor(
        np.random.default_rng(seed).standard_normal((CHAINS, 2)))


def _gen():
    return torch.Generator().manual_seed(SEED)


def _np(t):
    return t.detach().cpu().numpy()


def _det_z0():
    return np.random.default_rng(1).standard_normal((CHAINS, 3))


def _torch_det_step(z, generator, eps, inv_mass):
    """tests/test_torch_samplers.py's deterministic step: it draws
    nothing, so the rank streams do not enter and the JAX sampler's keys
    need not be replayed."""
    z_new = 0.9 * z + eps * inv_mass * torch.cos(z)
    acc = torch.clamp(torch.exp(-eps * (1.0 + 0.1 * torch.sum(z_new**2, 1))),
                      max=1.0)
    return z_new, acc, acc < 0.3


def _stats_np(stats):
    return {k: _np(v) for k, v in stats.items() if torch.is_tensor(v)}


# ----- the ranks' side ----------------------------------------------------


def _gathered(t, group):
    return _np(all_gather(t, group_of(group)).reshape(-1, *t.shape[1:]))


def _case_hmc(group, me):
    gen = _gen()
    mine = slice(me * PER_RANK, (me + 1) * PER_RANK)
    samples, stats = hmc.hmc_sample(gen, _gauss, _z0(7)[mine], HMC_CFG,
                                    group=group)
    more, stats2, _ = hmc.hmc_continue(gen, _gauss, samples[:, -1],
                                       stats["step_size"], stats["inv_mass"],
                                       CONTINUE, HMC_CFG, group=group)
    return {"samples": _gathered(samples, group), "stats": _stats_np(stats),
            "more": _gathered(more, group), "stats2": _stats_np(stats2)}


def _case_nuts(group, me):
    ld, _, _ = _gp_density()
    gen = _gen()
    mine = slice(me * PER_RANK, (me + 1) * PER_RANK)
    samples, stats = nuts.nuts_sample(gen, ld, _z0(2, np.log(0.5))[mine],
                                      NUTS_CFG, max_depth=NUTS_DEPTH,
                                      group=group)
    more, stats2, _ = nuts.nuts_continue(
        gen, ld, samples[:, -1], stats["step_size"], stats["inv_mass"],
        CONTINUE, max_depth=NUTS_DEPTH, group=group)
    return {"samples": _gathered(samples, group), "stats": _stats_np(stats),
            "more": _gathered(more, group), "stats2": _stats_np(stats2)}


def _case_det(group, me):
    mine = slice(me * PER_RANK, (me + 1) * PER_RANK)
    samples, stats = hmc.adaptive_mcmc(_gen(), _torch_det_step,
                                       torch.as_tensor(_det_z0()[mine]),
                                       DET_CFG, group=group)
    more, stats2, _ = hmc.mcmc_continue(
        _gen(), _torch_det_step, samples[:, -1], stats["step_size"],
        stats["inv_mass"], DET_CONTINUE, thin=DET_CFG.thin, group=group)
    return {"samples": _gathered(samples, group), "stats": _stats_np(stats),
            "more": _gathered(more, group), "stats2": _stats_np(stats2)}


def _case_same_start(group, me):
    """Identical chains on every rank: the rank streams must tell them
    apart."""
    z = torch.as_tensor([[0.5, -0.5], [1.0, 0.25]])
    samples, _ = hmc.hmc_sample(_gen(), _gauss, z,
                                HMCConfig(n_warmup=20, n_samples=30,
                                          n_leapfrog=4), group=group)
    first = torch.randn(3, generator=rank_generator(_gen(), me),
                        dtype=torch.float64)
    return {"samples": _gathered(samples, group),
            "first": _gathered(first[None], group)}


def _case_statistics(group, me):
    mine = slice(me * PER_RANK, (me + 1) * PER_RANK)
    samples, stats = hmc.hmc_sample(_gen(), _gauss, _z0(17)[mine], STAT_CFG,
                                    group=group)
    return {"samples": _gathered(samples, group),
            "accept_rate": float(stats["accept_rate"])}


def _case_train_bayes(group, me):
    x, y = _gp_problem()
    emul = Emulator.from_arrays(x, y, device="cpu", dtype=torch.float64)
    emul.mle_config = MLEConfig(tries=2, max_iters=20, nugget=1e-6)
    stats = emul.train_bayes(sampler="nuts", n_chains=2, n_warmup=8,
                             n_samples=4, max_depth=3,
                             generator=_gen(), group=group)
    return {"step_size": float(stats["step_size"]),
            "samples": _gathered(emul.hyper_samples, group)}


def _cases(rank):
    os.nice(10)        # below the other test workers: their timing tests
    mesh = make_mesh({"chains": WORLD}, device_type="cpu")
    group = (mesh, "chains")
    me = axis_group(mesh, "chains").rank()
    out = {}
    for name, case in (("hmc", _case_hmc), ("nuts", _case_nuts),
                       ("det", _case_det),
                       ("same_start", _case_same_start),
                       ("statistics", _case_statistics),
                       ("train_bayes", _case_train_bayes)):
        try:
            out[name] = case(group, me)
        except Exception:  # noqa: BLE001 - reported by the test of the case
            out[name] = RuntimeError(traceback.format_exc())
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_cases, WORLD, device_type="cpu", timeout=300)


def _case(ranks, name, rank=0):
    got = ranks[rank][name]
    if isinstance(got, Exception):
        pytest.fail(f"case {name} failed on rank {rank}:\n{got}")
    return got


# ----- the one-process replays ----------------------------------------------


def _rank_generators():
    """Rank r's generator as the sharded run derives it: each rank holds a
    fresh `_gen()` and advances it by one draw."""
    return [rank_generator(_gen(), r) for r in range(WORLD)]


def _blocks(gens, draw, z):
    return [draw(g, z[r * PER_RANK:(r + 1) * PER_RANK])
            for r, g in enumerate(gens)]


def _hmc_replay(z0, cfg, eps=None, inv_mass=None, n_continue=0):
    gens = _rank_generators()

    def ld_grad(z):
        return hmc.value_and_grad(_gauss, z)

    def step(z, _gen_unused, eps, inv_mass):
        parts = _blocks(gens, hmc._hmc_draws, z)
        noise = torch.cat([p[0] for p in parts])
        u = torch.cat([p[1] for p in parts])
        return hmc._hmc_transition(ld_grad, z, noise, u, eps, inv_mass, cfg)

    samples, stats = hmc.adaptive_mcmc(None, step, z0, cfg)
    gens[:] = [rank_generator(_gen_after_one_draw(), r)
               for r in range(WORLD)]
    more, stats2, _ = hmc.mcmc_continue(None, step, samples[:, -1],
                                        stats["step_size"],
                                        stats["inv_mass"], n_continue)
    return samples, stats, more, stats2


def _gen_after_one_draw():
    """The caller's generator after the first sampler call's draw."""
    g = _gen()
    torch.randint(0, 2 ** 62, (2,), generator=g)
    return g


def _nuts_replay(ld, z0):
    gens = _rank_generators()
    counts = nuts.new_counts()

    def ld_grad(z):
        return hmc.value_and_grad(ld, z)

    def step(z, _gen_unused, eps, inv_mass):
        parts = _blocks(gens, lambda g, zz: nuts._nuts_draws(g, zz,
                                                            NUTS_DEPTH), z)
        draws = nuts.NutsDraws(*(torch.cat(f) for f in zip(*parts)))
        return nuts._nuts_transition(ld_grad, z, draws, eps, inv_mass,
                                     NUTS_DEPTH,
                                     NUTS_CFG.divergence_threshold, counts)

    samples, stats = hmc.adaptive_mcmc(None, step, z0, NUTS_CFG)
    gens[:] = [rank_generator(_gen_after_one_draw(), r)
               for r in range(WORLD)]
    more, stats2, _ = hmc.mcmc_continue(None, step, samples[:, -1],
                                        stats["step_size"],
                                        stats["inv_mass"], CONTINUE)
    return samples, stats, more, stats2


def _assert_run(got, samples, stats, more, stats2, rtol=1e-12):
    np.testing.assert_allclose(got["samples"], _np(samples), rtol=rtol,
                               atol=1e-13)
    np.testing.assert_allclose(got["more"], _np(more), rtol=rtol, atol=1e-13)
    for key in ("step_size", "inv_mass", "accept_rate", "divergence_rate",
                "warmup_accept_trace"):
        np.testing.assert_allclose(got["stats"][key], _np(stats[key]),
                                   rtol=rtol, atol=1e-14)
    for key in ("accept_rate", "divergence_rate"):
        np.testing.assert_allclose(got["stats2"][key], _np(stats2[key]),
                                   rtol=rtol, atol=1e-14)


# ----- the tests ------------------------------------------------------------


def test_sharded_hmc_equals_the_one_process_run_from_the_same_draws(ranks):
    got = _case(ranks, "hmc")
    for r in range(1, WORLD):              # one adaptation on every rank
        other = _case(ranks, "hmc", r)
        np.testing.assert_array_equal(other["stats"]["step_size"],
                                      got["stats"]["step_size"])
        np.testing.assert_array_equal(other["stats"]["inv_mass"],
                                      got["stats"]["inv_mass"])
    _assert_run(got, *_hmc_replay(_z0(7), HMC_CFG, n_continue=CONTINUE))


def test_sharded_nuts_equals_the_one_process_run_from_the_same_draws(ranks):
    got = _case(ranks, "nuts")
    ld, _, _ = _gp_density()
    _assert_run(got, *_nuts_replay(ld, _z0(2, np.log(0.5))))
    assert np.all(np.isfinite(got["samples"]))


def test_sharded_adaptive_mcmc_equals_the_jax_shard_map_with_a_fixed_step(
        ranks):
    """The port's adaptive_mcmc and mcmc_continue over the ranks against
    the JAX package's under shard_map over 4 devices (axis_name
    "chains"), with one deterministic step written in both packages: the
    placement of every cross-rank mean (dual averaging, the Welford
    variance, the rates) is held at rtol 1e-12."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from gp_emu_uqsa_tpu.inference import hmc as jhmc

    def det_step(z, key, eps, inv_mass):
        z_new = 0.9 * z + eps * inv_mass * jnp.cos(z)
        acc = jnp.minimum(1.0,
                          jnp.exp(-eps * (1.0 + 0.1 * jnp.sum(z_new**2, 1))))
        return z_new, acc, acc < 0.3

    got = _case(ranks, "det")
    cfg = jhmc.HMCConfig(n_warmup=DET_CFG.n_warmup,
                         n_samples=DET_CFG.n_samples, thin=DET_CFG.thin,
                         init_step_size=DET_CFG.init_step_size)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("chains",))
    run = jax.jit(jax.shard_map(
        lambda k, z: jhmc.adaptive_mcmc(k, det_step, z, cfg,
                                        axis_name="chains"),
        mesh=mesh, in_specs=(P(), P("chains")),
        out_specs=(P("chains"), P()), check_vma=False))
    js, jst = run(jax.random.key(0), jnp.asarray(_det_z0()))
    more = jax.jit(jax.shard_map(
        lambda k, z, eps, inv_mass: jhmc.mcmc_continue(
            k, det_step, z, eps, inv_mass, DET_CONTINUE,
            axis_name="chains", thin=DET_CFG.thin)[:2],
        mesh=mesh, in_specs=(P(), P("chains"), P(), P()),
        out_specs=(P("chains"), P()), check_vma=False))
    js2, jst2 = more(jax.random.key(1), js[:, -1], jst["step_size"],
                     jst["inv_mass"])
    assert got["samples"].shape == js.shape == (CHAINS, 11, 3)
    assert not np.allclose(np.asarray(jst["inv_mass"]), 1.0)
    np.testing.assert_allclose(got["samples"], np.asarray(js), rtol=1e-12)
    for k in ("step_size", "inv_mass", "accept_rate", "divergence_rate",
              "warmup_accept_trace"):
        np.testing.assert_allclose(got["stats"][k], np.asarray(jst[k]),
                                   rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(got["more"], np.asarray(js2), rtol=1e-12)
    for k in ("accept_rate", "divergence_rate"):
        np.testing.assert_allclose(got["stats2"][k], np.asarray(jst2[k]),
                                   rtol=1e-12, err_msg=k)


def test_rank_streams_differ_and_repeat(ranks):
    got = _case(ranks, "same_start")
    first = got["first"]
    assert len({tuple(row) for row in first}) == WORLD
    for r in range(WORLD):
        expect = torch.randn(3, generator=rank_generator(_gen(), r),
                             dtype=torch.float64)
        np.testing.assert_array_equal(first[r], _np(expect))
    # identical starting chains on every rank, distinct trajectories
    chains = got["samples"].reshape(WORLD, 2, -1, 2)
    for a in range(WORLD):
        for b in range(a + 1, WORLD):
            assert not np.allclose(chains[a], chains[b])


def test_sharded_chains_match_the_jax_shard_map_statistically(ranks):
    """tests/test_hmc.py::test_sharded_chains_match_unsharded's target,
    run and bounds, for the port's ranks and for JAX's shard_map over 4
    devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from gp_emu_uqsa_tpu.inference.hmc import HMCConfig as JCfg
    from gp_emu_uqsa_tpu.inference.hmc import hmc_sample as jhmc

    got = _case(ranks, "statistics")
    var = jnp.asarray(VAR)

    def logdensity(z):
        return -0.5 * jnp.sum(z * z / var)

    cfg = JCfg(n_warmup=STAT_CFG.n_warmup, n_samples=STAT_CFG.n_samples,
               n_leapfrog=STAT_CFG.n_leapfrog)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("chains",))
    z0 = jax.random.normal(jax.random.key(7), (CHAINS, 2), jnp.float64)
    run = jax.jit(jax.shard_map(
        lambda k, z: jhmc(k, logdensity, z, cfg, axis_name="chains"),
        mesh=mesh, in_specs=(P(), P("chains")),
        out_specs=(P("chains"), P()), check_vma=False))
    samples_j, stats_j = run(jax.random.key(8), z0)
    for flat, accept in ((got["samples"].reshape(-1, 2),
                          got["accept_rate"]),
                         (np.asarray(samples_j).reshape(-1, 2),
                          float(stats_j["accept_rate"]))):
        np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.2)
        np.testing.assert_allclose(flat.var(0), VAR, rtol=0.35)
        assert accept > 0.5
    assert got["samples"].shape[0] == CHAINS


def test_train_bayes_over_ranks_shares_its_adaptation(ranks):
    got = [_case(ranks, "train_bayes", r) for r in range(WORLD)]
    for g in got[1:]:
        assert g["step_size"] == got[0]["step_size"]
    samples = got[0]["samples"]
    assert samples.shape == (2 * WORLD, 4, 2)
    assert np.all(np.isfinite(samples))
    per_rank = samples.reshape(WORLD, -1)
    assert len({tuple(row) for row in per_rank}) == WORLD
