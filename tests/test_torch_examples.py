"""The port's example workflows (`gp_emu_uqsa_torch.examples`) against the
JAX package's scripts under examples/, loaded by path.

fp64 on the CPU, one torch thread, small sizes. The port draws its LHC
designs and L-BFGS starts from torch generators, so the tests feed it the
JAX package's: the design as `x=`, the starts by replacing
`inference.lbfgs._lhc_starts` with the JAX package's draw from the key of
the same seed (`jax.random.key(seed + n_folded)` in both `optimize`s).
Tolerances:
- Branin (config 2) at n = 30, 2 tries: S_i, S_Ti and E*[E Y] at atol 1e-6
  (one L-BFGS trajectory in two packages; the optimum's flat directions
  move the indices by less);
- toy-sim (config 1) through setup -> train -> final_build, 8 L-BFGS
  iterations an optimize in both: the written -f beliefs at rtol 1e-5 and
  the LOO standardized errors (at most 0.77) at atol 1e-4. At the fixed
  nugget 1e-10, kappa(A) is 1.4e11 and kappa(A) eps64 3e-5, the distance
  at which two LAPACK builds part; measured 1.1e-6 (beta) and 4.6e-5;
- config 5 on one CPU rank against `run_large.main` on the 8-device test
  mesh at n = 512, block 64, m = 512: the NLL and the first mean and
  variance at rtol 1e-8; the fused tier (fp32 plain versions here)
  against the ring at tests/test_serve_facade.py:35-38's tolerances;
- HMC (config 4) at its n = 120, 8 chains (one a JAX device), 16 warmup
  and 8 draws: the
  port fed the JAX package's z0 and its draws (the key splits of
  `hmc.py:159, 222-240, 93`) gives its samples and statistics at rtol
  1e-5. At the script's nugget 1e-6 the two packages' log densities and
  gradients agree to about 1e-7 (tests/test_torch_samplers.py holds them
  at rtol 1e-7), and 16 transitions of 12 leapfrog steps carry that
  along; measured 9e-7. (Longer or wilder runs part for good: where
  the factor of A fails in one package's LAPACK and not in the other's,
  one flags a divergence and the other does not.)
- every workflow writes nothing outside its workdir.
"""
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_emu_uqsa_tpu as jg
from gp_emu_uqsa_tpu import gp as jgp
from gp_emu_uqsa_tpu.configs import Beliefs as JBeliefs
from gp_emu_uqsa_tpu.design_inputs import optLatinHyperCube as jlhc_design
from gp_emu_uqsa_tpu.inference.lbfgs import _lhc_starts as jlhc_starts

from gp_emu_uqsa_torch.configs import Beliefs
from gp_emu_uqsa_torch.examples import (
    branin_2d, hmc_bayes, large_scale, matrix_free, noise_fit,
    sensitivity_2d, synthetic_10d, toy_sim,
)
from gp_emu_uqsa_torch.inference import lbfgs as tlbfgs

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def _script(rel: str):
    """An examples/ script as a module, loaded by path."""
    path = EXAMPLES / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.fixture
def jax_starts(monkeypatch):
    """The port's restarts start where the JAX package's do."""
    def starts(generator, tries, lo, hi, dtype):
        z = jlhc_starts(jax.random.key(generator.initial_seed()), tries,
                        jnp.asarray(np.asarray(lo, np.float64)),
                        jnp.asarray(np.asarray(hi, np.float64)), jnp.float64)
        return torch.tensor(np.asarray(z), dtype=dtype)
    monkeypatch.setattr(tlbfgs, "_lhc_starts", starts)


def test_branin_matches_the_jax_script(jax_starts, monkeypatch):
    run_branin = _script("branin-2d/run_branin.py")
    tries = 2
    plain = jg.Emulator.from_arrays.__func__

    def two_tries(cls, *args, **kw):
        return plain(cls, *args, **{**kw, "tries": tries})
    monkeypatch.setattr(jg.Emulator, "from_arrays", classmethod(two_tries))
    jem, jsens = run_branin.main(n=30, verbose=False)
    x = jlhc_design(2, 30, 200, branin_2d.MINMAX, seed=0)
    tem, tsens = branin_2d.main(n=30, tries=tries, x=x, device="cpu",
                                verbose=False)
    np.testing.assert_array_equal(branin_2d.branin(x[:, 0], x[:, 1]),
                                  run_branin.branin(x[:, 0], x[:, 1]))
    got = (tsens.sensitivity()["S_i"], tsens.totaleffectvariance()["S_Ti"],
           tsens.uncertainty()["E_EY"])
    want = (jsens.sensitivity()["S_i"], jsens.totaleffectvariance()["S_Ti"],
            jsens.uncertainty()["E_EY"])
    for name, g, w in zip(("S_i", "S_Ti", "E_EY"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=name)
    # the trained nugget: the injected noise variance 4 is in the fit
    noise_var = float(torch.exp(tem.params.log_nugget) * tem.state.sigma2)
    assert 0.2 < noise_var < 80.0, noise_var


def test_toy_sim_matches_the_jax_workflow(jax_starts, tmp_path):
    """The port's setup -> train -> final_build against the JAX package's
    setup -> final_build: the written beliefs and the final state come
    from the last optimize alone (on all rows, from the key of seed +
    n_folded), so the JAX side skips train's first two optimizes and
    their compilations."""
    import dataclasses
    import shutil
    iters = 8
    tem, (_, _, tse), (xg, mean, var) = toy_sim.main(
        device="cpu", workdir=tmp_path / "torch", max_iters=iters,
        verbose=False)
    jdir = tmp_path / "jax" / "toy-sim"
    shutil.copytree(EXAMPLES / "toy-sim", jdir)
    jem = jg.setup(jdir / "toy-sim_config")
    jem.mle_config = dataclasses.replace(jem.mle_config, max_iters=iters)
    jg.final_build(jem)
    x, y, h = jem.train_view()
    jm, jv = jgp.loo_diagnostics(jem.state, x, h, y)
    jse = (y - jm) / jnp.sqrt(jv)
    tb = Beliefs.from_file(tmp_path / "torch" / "toy-sim"
                           / "toy-sim_beliefs-f")
    jb = JBeliefs.from_file(jdir / "toy-sim_beliefs-f")
    for key in ("delta", "sigma", "beta", "nugget", "input_minmax"):
        np.testing.assert_allclose(np.asarray(getattr(tb, key), float),
                                   np.asarray(getattr(jb, key), float),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(_np(tse), np.asarray(jse), rtol=0, atol=1e-4)
    # BASELINE config 1's grid: 201 points over the input range
    assert xg.shape == (201, 1) and mean.shape == var.shape == (201,)
    rmse = float(np.sqrt(np.mean((_np(mean) - toy_sim.toy_sim(xg)) ** 2)))
    assert rmse < 0.05 and float(var.min()) >= 0.0


def test_large_scale_matches_the_jax_script():
    run_large = _script("large-scale/run_large.py")
    kw = dict(n=512, m=512, block=64, verbose=False)
    jstate, jmean, jvar = run_large.main(**kw)
    tstate, tmean, tvar = large_scale.main(**kw, device="cpu")
    np.testing.assert_allclose(float(tstate.nll), float(jstate.nll),
                               rtol=1e-8)
    np.testing.assert_allclose([tmean, tvar], [jmean, jvar], rtol=1e-8)


def test_large_scale_fused_tier_matches_the_ring():
    """The script's TPU branch on the CPU (fp32 plain versions of K3 and
    K4) against the fp64 ring on the same queries, over several ring
    calls (chunk 128 a rank)."""
    out = large_scale.run(n=384, m=1000, block=64, chunk=128, fused=True,
                          device="cpu", verbose=False)
    s2 = float(out.state.sigma2)
    (rm, rv), (fm, fv) = out.ring, out.fused
    assert rm.shape == fm.shape == out.fused_mean.shape == (1000,)
    for mean in (fm, out.fused_mean):
        np.testing.assert_allclose(_np(mean), _np(rm), rtol=1e-4,
                                   atol=1e-4 * max(1.0, s2))
    np.testing.assert_allclose(_np(fv), _np(rv), rtol=2e-3, atol=1e-4 * s2)
    assert set(out.seconds) == {"fit_large", "predictor_large",
                                "ring_predict", "gather W", "fused mean",
                                "fused mean+var"}


def _jax_hmc_draws(chains, devices, n_warmup, n_samples, dim=3):
    """run_hmc.py's draws, one step at a time: each device's key
    fold_in(key(1), device), split into the warmup's and the samples'
    step keys, each step key into the momenta's and the accept's keys."""
    per = chains // devices
    steps = []
    for dev in range(devices):
        k_warm, k_samp = jax.random.split(
            jax.random.fold_in(jax.random.key(1), dev))
        steps.append(list(jax.random.split(k_warm, n_warmup))
                     + list(jax.random.split(k_samp, n_samples)))
    it = iter(range(n_warmup + n_samples))

    def draws(z):
        t = next(it)
        noise, u = [], []
        for dev in range(devices):
            kp, ka = jax.random.split(steps[dev][t])
            noise.append(np.asarray(jax.random.normal(kp, (per, dim),
                                                      jnp.float64)))
            u.append(np.asarray(jax.random.uniform(ka, (per,), jnp.float64)))
        return (torch.as_tensor(np.concatenate(noise)),
                torch.as_tensor(np.concatenate(u)))
    return draws


def test_hmc_matches_the_jax_script_from_its_draws():
    run_hmc = _script("hmc-bayes/run_hmc.py")
    kw = dict(n=120, n_chains=8, n_warmup=16, n_samples=8)
    js, jstats = run_hmc.main(**kw, verbose=False)
    x = jlhc_design(3, kw["n"], 80, [[0, 1]] * 3, seed=0)
    z0 = jnp.log(0.5) + 0.2 * jax.random.normal(
        jax.random.key(0), (kw["n_chains"], 3), jnp.float64)
    ts, tstats = hmc_bayes.main(
        **kw, x=x, z0=np.asarray(z0), device="cpu", verbose=False,
        draws=_jax_hmc_draws(kw["n_chains"], len(jax.devices()),
                             kw["n_warmup"], kw["n_samples"]))
    assert ts.shape == js.shape == (8, 8, 3)
    assert float(tstats["accept_rate"]) > 0.5
    np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-5)
    for key in ("step_size", "inv_mass", "accept_rate", "divergence_rate"):
        np.testing.assert_allclose(_np(tstats[key]), np.asarray(jstats[key]),
                                   rtol=1e-5, err_msg=key)


def test_hmc_default_start_is_the_scripts_rule():
    z0 = hmc_bayes.default_z0(64)
    assert z0.shape == (64, 3) and z0.dtype == torch.float64
    assert abs(float(z0.mean()) - np.log(0.5)) < 0.1
    assert 0.15 < float(z0.std()) < 0.25


# ----- nothing written outside the workdir ----------------------------------

def _tree_state(*dirs):
    """(path, size, mtime) of every file under dirs but Python's and the
    native loader's caches. (Not the repo root's entries: other tests'
    tools, hypothesis for one, make theirs there.)"""
    out = set()
    for d in dirs:
        for p in d.rglob("*"):
            if p.is_file() and not {"__pycache__", "_build"} & set(p.parts):
                st = p.stat()
                out.add((str(p), st.st_size, st.st_mtime_ns))
    return out


_RUNS = {
    "branin_2d": lambda w: branin_2d.main(n=12, tries=2, workdir=w,
                                          device="cpu", verbose=False),
    "synthetic_10d": lambda w: synthetic_10d.main(
        n=30, tries=2, workdir=w, device="cpu", verbose=False),
    "hmc_bayes": lambda w: hmc_bayes.main(
        n=20, n_chains=4, n_warmup=4, n_samples=4, workdir=w, device="cpu",
        verbose=False),
    "large_scale": lambda w: large_scale.main(
        n=128, m=256, block=32, workdir=w, device="cpu", verbose=False),
    "toy_sim": lambda w: toy_sim.main(max_iters=3, workdir=w, device="cpu",
                                      verbose=False),
    "sensitivity_2d": lambda w: sensitivity_2d.main(
        max_iters=3, workdir=w, device="cpu", verbose=False),
    "noise_fit": lambda w: noise_fit.main(n=40, stopat=1, tries=2,
                                          workdir=w, device="cpu",
                                          verbose=False),
    "noise_fit_files": lambda w: noise_fit.main_files(
        stopat=1, workdir=w, device="cpu", verbose=False),
    "matrix_free": lambda w: matrix_free.main(n=120, n_sub=40, steps=2,
                                              workdir=w, device="cpu",
                                              verbose=False),
}
# what each file-driven workflow writes into its copy of the tree
_WRITES = {
    "toy_sim": ("toy-sim", {"toy-sim_beliefs-f", "toy-sim_input-f",
                            "toy-sim_output-f"}),
    "sensitivity_2d": ("sensitivity-2d", {"sens2d_beliefs-f",
                                          "sens2d_input-f", "sens2d_output-f",
                                          "sens2d_indices"}),
    "noise_fit_files": ("noise-fit", {"noisefit_output-noise",
                                      "noisefit_output-noise-it0",
                                      "noisefit_data_beliefs-f",
                                      "noisefit_noise_beliefs-f"}),
}


@pytest.mark.parametrize("name", sorted(_RUNS))
def test_example_writes_only_in_its_workdir(name, tmp_path, monkeypatch):
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    work = tmp_path / "work"
    watched = (EXAMPLES, ROOT / "gp_emu_uqsa_torch")
    before = _tree_state(*watched)
    _RUNS[name](work)
    assert _tree_state(*watched) == before
    assert not any(cwd.iterdir())
    tree, outputs = _WRITES.get(name, (None, set()))
    if tree is None:
        assert not work.exists() or not any(work.iterdir())
        return
    src = {p.name for p in (EXAMPLES / tree).iterdir()}
    written = {p.name for p in (work / tree).iterdir()} - src
    assert outputs <= written, written
    assert os.listdir(work) == [tree]
