"""The port's heteroscedastic noise fit against the JAX package's.

fp64 on the CPU, n <= 120, one thread. Tolerances:
- `_maximin_subset`: the same indices;
- the orchestration, without L-BFGS: `mle_fit` replaced in both noise-fit
  modules by one function that returns the same fixed hyperparameters at
  every call (the port's `mle_fit` is held against the JAX package's by
  tests/test_torch_train.py, and its starts come from another random
  stream). Then the per-iteration noise variances, the history,
  `noise_at_train`, `noise_x` and `predict_noise` at rtol 1e-10, with and
  without a design subset, n = 120;
- the data GP's fit under a per-point noise (gp4ml, a trained nugget,
  `noise_diag`), the one `mle_fit` configuration the noise fit adds to
  tests/test_torch_train.py's: L-BFGS from the JAX package's starts, the
  final NLLs at rtol 1e-5, the iteration counts equal, the best
  parameters within 1e-5 (tests/test_torch_train.py's tolerances);
- tests/test_noise_fit.py's ramp-recovery, design-size and file-driven
  checks, with its bounds, on the port alone (its own L-BFGS); the ramp
  at n = 120 and stopat 4 (its 150 and 6) to keep the file short.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu import noise_fit as jnf
from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis
from gp_emu_uqsa_tpu.inference import lbfgs as jlbfgs
from gp_emu_uqsa_tpu.kernels import GPParams as JParams

from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch import noise_fit as tnf
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference import lbfgs as tlbfgs
from gp_emu_uqsa_torch.kernels import GPParams as TParams


def _hetero_data(n=150, seed=0):
    """tests/test_noise_fit.py's 1-D function, noise sd 0.02 -> 0.4."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(size=(n, 1)), axis=0)
    sd = 0.02 + 0.38 * x[:, 0]
    y = np.sin(2 * np.pi * x[:, 0]) + sd * rng.standard_normal(n)
    return x, y, sd


# log delta, log sigma2, log nugget of each GP: the data GP's config has
# nugget bounds from 1e-8, the noise GP's from 1e-6
_FIXED = {1e-8: (np.log([0.25]), np.log(0.8), np.log(0.05)),
          1e-6: (np.log([0.4]), np.log(1.5), np.log(0.3))}


def _fixed_fit(make):
    calls = []

    def mle_fit(key, x, y, h, cfg, noise_diag=None):
        calls.append(noise_diag is not None)
        return make(*_FIXED[cfg.nugget_bounds[0]]), {}

    mle_fit.calls = calls
    return mle_fit


def _jax_params(ld, ls, ln):
    return JParams(jnp.asarray(ld), jnp.asarray(ls), jnp.asarray(ln))


def _torch_params(ld, ls, ln):
    return TParams(torch.tensor(ld), torch.tensor(ls, dtype=torch.float64),
                   torch.tensor(ln, dtype=torch.float64))


def test_maximin_subset_matches_jax():
    x = np.random.default_rng(0).uniform(size=(200, 3))
    for k in (1, 20, 77, 199, 200, 250):
        np.testing.assert_array_equal(tnf._maximin_subset(x, k),
                                      jnf._maximin_subset(x, k))


@pytest.mark.parametrize("design_size", [None, 40])
def test_orchestration_with_fixed_fits_matches_jax(monkeypatch, design_size):
    x, y, _ = _hetero_data(n=120, seed=1)
    jfit = _fixed_fit(_jax_params)
    tfit = _fixed_fit(_torch_params)
    monkeypatch.setattr(jnf, "mle_fit", jfit)
    monkeypatch.setattr(tnf, "mle_fit", tfit)
    seen = {"jax": [], "torch": []}
    kw = dict(stopat=3, tries=2, design_size=design_size)
    jres = jnf.noisefit_arrays(
        x, y, iter_callback=lambda it, v: seen["jax"].append((it, v)), **kw)
    tres = tnf.noisefit_arrays(
        x, y, iter_callback=lambda it, v: seen["torch"].append((it, v)),
        device="cpu", **kw)
    assert tfit.calls == jfit.calls and len(tfit.calls) == 7
    assert [it for it, _ in seen["torch"]] == [it for it, _ in seen["jax"]]
    for (_, tv), (_, jv) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_allclose(tv, jv, rtol=1e-10)
    np.testing.assert_allclose(tres.history, jres.history, rtol=1e-10)
    assert len(tres.history) == 2
    np.testing.assert_allclose(tres.noise_at_train, jres.noise_at_train,
                               rtol=1e-10)
    np.testing.assert_allclose(tres.y_log_noise, jres.y_log_noise,
                               rtol=1e-10)
    np.testing.assert_array_equal(tres.noise_x, jres.noise_x)
    assert tres.noise_x.shape == ((40, 1) if design_size else (120, 1))
    grid = np.linspace(0.0, 1.0, 17)[:, None]
    np.testing.assert_allclose(tnf.predict_noise(tres, grid),
                               jnf.predict_noise(jres, grid), rtol=1e-10)
    for name in ("sigma2", "nll", "beta"):
        np.testing.assert_allclose(
            getattr(tres.data_state, name).numpy(),
            np.asarray(getattr(jres.data_state, name)), rtol=1e-10,
            err_msg=name)


def test_data_fit_with_noise_diag_matches_jax_from_its_starts():
    x, y, sd = _hetero_data(n=80, seed=2)
    noise = sd ** 2 / 0.5                     # correlation units, sigma2 0.5
    cfg = jnf.MLEConfig(mode="gp4ml", tries=4, train_nugget=True,
                        nugget_bounds=(1e-8, 10.0), max_iters=15)
    spec = linear_basis(1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jh = jbasis(jx, spec)
    jparams, info = jnf.mle_fit(jax.random.key(1), jx, jy, jh, cfg,
                                noise_diag=jnp.asarray(noise))
    lo, hi = jlbfgs._default_bounds(cfg, 1)
    _, _, jfrom = jlbfgs._make_objective(jx, jy, jh, cfg, lo, hi)
    u0s = np.asarray(jax.vmap(jfrom)(info["starts_logspace"]))
    tcfg = tlbfgs.MLEConfig(**dataclasses.asdict(cfg))
    tx, ty = torch.tensor(x), torch.tensor(y)
    tobj, tto, _ = tlbfgs._make_objective(tx, ty, basis_matrix(tx, spec), tcfg,
                                          lo, hi, torch.tensor(noise))
    us, vs, iters = tlbfgs.run_restarts(tobj, torch.tensor(u0s),
                                        tcfg.max_iters, tcfg.tol)
    np.testing.assert_allclose(vs.numpy(), np.asarray(info["nlls"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(info["iters"]))
    best = int(info["best_index"])
    got = tlbfgs._unpack(tto(us[best]), tcfg, 1, torch.float64)
    for g, w in zip(got, jparams):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0.0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


# ----- tests/test_noise_fit.py's checks, on the port ------------------------------

def test_port_recovers_noise_ramp():
    x, y, _ = _hetero_data(n=120)
    res = tnf.noisefit_arrays(x, y, stopat=4, tries=3, device="cpu")
    # predicted noise sd increases from left to right
    grid = np.linspace(0.05, 0.95, 10)[:, None]
    sd_pred = np.sqrt(tnf.predict_noise(res, grid))
    assert sd_pred[-1] > 2.5 * sd_pred[0], sd_pred
    # and is the right order of magnitude at both ends
    assert 0.005 < sd_pred[0] < 0.15
    assert 0.15 < sd_pred[-1] < 1.0
    # the data GP still tracks the underlying signal
    tx = torch.tensor(x)
    gs = np.linspace(0, 1, 50)[:, None]
    tg = torch.tensor(gs)
    mean, _ = tgp.predict(res.data_state, tx, basis_matrix(tx, linear_basis(1)),
                          tg, basis_matrix(tg, linear_basis(1)))
    rmse = float(np.sqrt(np.mean((mean.numpy() - np.sin(2 * np.pi * gs[:, 0]))
                                 ** 2)))
    assert rmse < 0.15


def test_port_design_size_changes_behavior_and_still_recovers_ramp():
    x, y, _ = _hetero_data(n=120, seed=1)
    res_full = tnf.noisefit_arrays(x, y, stopat=2, tries=2, device="cpu")
    res_sub = tnf.noisefit_arrays(x, y, stopat=2, tries=2, design_size=40,
                                  device="cpu")
    assert not np.allclose(res_full.noise_at_train, res_sub.noise_at_train)
    grid = np.linspace(0.05, 0.95, 10)[:, None]
    sd_pred = np.sqrt(tnf.predict_noise(res_sub, grid))
    assert sd_pred[-1] > 2.0 * sd_pred[0], sd_pred


def _write_noisefit_files(tmp_path, n=80, seed=3):
    x, y, _ = _hetero_data(n=n, seed=seed)
    np.savetxt(tmp_path / "in", x)
    np.savetxt(tmp_path / "out", y)
    for name in ("data", "noise"):
        (tmp_path / f"{name}_beliefs").write_text(
            "active all\noutput 0\nbasis_str 1.0 x\nbasis_inf NA 0\n"
            "mucm F\nkernel gaussian()\ndelta 1.0\nsigma 1.0\n"
            "nugget 0.001\nfix_nugget F\n"
        )
        (tmp_path / f"{name}_config").write_text(
            f"beliefs {name}_beliefs\ninputs in\noutputs out\n"
            "tv_config 4 0 1\ntries 2\n"
        )


def test_port_file_driven_noisefit(tmp_path):
    _write_noisefit_files(tmp_path)
    res = tnf.noisefit(tmp_path / "data_config", tmp_path / "noise_config",
                       stopat=3, device="cpu")
    assert (tmp_path / "out-noise").exists()
    assert (tmp_path / "data_beliefs-f").exists()
    assert (tmp_path / "noise_beliefs-f").exists()
    for it in range(len(res.history) + 1):
        assert (tmp_path / f"out-noise-it{it}").exists()
    noise = np.loadtxt(tmp_path / "out-noise")
    assert noise.shape == (80,) and np.all(noise > 0)
    np.testing.assert_allclose(noise, res.noise_at_train, rtol=1e-11)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x, y, _ = _hetero_data(n=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnf.noisefit_arrays(x, y, stopat=1)


# ----- on the card (skips elsewhere) -----------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_orchestration_matches_the_cpu(monkeypatch, cuda_device):
    """The same fixed fits on the card and the CPU (fp64): the noise
    estimates, history and predict_noise within rtol 1e-10."""
    x, y, _ = _hetero_data(n=120, seed=1)
    out = []
    for dev in ("cpu", cuda_device):
        make = (lambda *v, d=dev: TParams(*(t.to(d) for t in _torch_params(*v))))
        monkeypatch.setattr(tnf, "mle_fit", _fixed_fit(make))
        res = tnf.noisefit_arrays(x, y, stopat=3, tries=2, design_size=40,
                                  device=dev)
        out.append((res, tnf.predict_noise(res, np.linspace(0, 1, 17)[:, None])))
    (cres, cpred), (gres, gpred) = out
    np.testing.assert_allclose(gres.noise_at_train, cres.noise_at_train,
                               rtol=1e-10)
    np.testing.assert_allclose(gres.history, cres.history, rtol=1e-10)
    np.testing.assert_allclose(gpred, cpred, rtol=1e-10)


# ----- readings behind chip_smoke.py's NF_BAND (a script, not a test) ------------

def end_decile_sds(which: str, n: int, seed: int = 0) -> dict:
    """noisefit_arrays on chip_smoke.py phase 7 (c)'s inputs at n rows (d =
    8, noise sd 0.1 + 0.4 x0, design 800, stopat 3, the JAX defaults
    otherwise), fp64 on the CPU, in the JAX package ("jax") or the port
    ("torch"), each with its own L-BFGS starts from `seed`: the mean
    recovered and true noise sd over the bottom and top deciles of x0.

        PYTHONPATH=. python tests/test_torch_noise_fit.py jax|torch N [SEED]

    from the repo root.

    It runs each package's L-BFGS, which is why no test calls it (n =
    512 took 41 min for the JAX package on the CPU)."""
    import chip_smoke

    x, y, sd = chip_smoke.nf_problem(n, chip_smoke.NF_D)
    kw = dict(stopat=chip_smoke.NF_STOPAT, design_size=chip_smoke.NF_DESIGN,
              seed=seed)
    res = (jnf.noisefit_arrays(x, y, **kw) if which == "jax"
           else tnf.noisefit_arrays(x, y, device="cpu", **kw))
    est = np.sqrt(np.asarray(res.noise_at_train))
    lo = x[:, 0] <= np.quantile(x[:, 0], 0.1)
    hi = x[:, 0] >= np.quantile(x[:, 0], 0.9)
    return {"which": which, "n": n, "seed": seed,
            "bottom": float(est[lo].mean()), "top": float(est[hi].mean()),
            "true_bottom": float(sd[lo].mean()),
            "true_top": float(sd[hi].mean())}


if __name__ == "__main__":
    import json
    import sys

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(2)
    print(json.dumps(end_decile_sds(sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]) if len(sys.argv) > 3
                                    else 0)))
