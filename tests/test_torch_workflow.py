"""The training path as a whole: config files to written beliefs.

`setup` -> `train` -> `final_build` on a copy of examples/toy-sim in both
packages, fp64 on the CPU. The starts differ (jax.random against
torch.Generator), so the packages are held where the likelihood decides:
each finds the same optimum, its best NLL within rtol 1e-6 of the other's,
and the emulators' predictions agree to 1e-4 of the output scale. Both
packages' fits are capped at 60 L-BFGS iterations (the toy problem has
converged by then; its gradient never reaches the 1e-8 stop, so uncapped
runs spend 200 iterations of 20-step linesearches at the optimum).
"""
import dataclasses
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import gp_emu_uqsa_tpu as jg
from gp_emu_uqsa_tpu.configs import Beliefs as JBeliefs

import gp_emu_uqsa_torch as tg
from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch.configs import Beliefs

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


MAX_ITERS = 60


def _capped(emul):
    emul.mle_config = dataclasses.replace(emul.mle_config,
                                          max_iters=MAX_ITERS)
    return emul


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both packages trained once on their own copy of toy-sim."""
    dirs = []
    for name in ("jax", "torch"):
        dst = tmp_path_factory.mktemp(name) / "toy-sim"
        shutil.copytree(EXAMPLES / "toy-sim", dst)
        dirs.append(dst)
    jdir, tdir = dirs
    jem = jg.train(_capped(jg.setup(jdir / "toy-sim_config")))
    tem = tg.train(_capped(tg.setup(tdir / "toy-sim_config", device="cpu")))
    return jdir, jem, tdir, tem


def test_setup_train_final_build_against_jax(trained):
    jdir, jem, tdir, tem = trained
    assert tem.n_folded == tem.splits.n_v_sets == 2
    # the written files parse, and carry the same scaling and basis
    for d in (jdir, tdir):
        for f in ("toy-sim_beliefs-f", "toy-sim_input-f", "toy-sim_output-f"):
            assert (d / f).exists()
    jb = JBeliefs.from_file(jdir / "toy-sim_beliefs-f")
    tb = Beliefs.from_file(tdir / "toy-sim_beliefs-f")
    assert tb.input_minmax == jb.input_minmax
    assert (tb.basis_str, tb.basis_inf, tb.mucm) == (jb.basis_str,
                                                     jb.basis_inf, jb.mucm)
    np.testing.assert_allclose(tb.delta, jb.delta, rtol=1e-3)
    np.testing.assert_allclose(tb.sigma, jb.sigma, rtol=1e-3)
    np.testing.assert_allclose(tb.beta, jb.beta, rtol=1e-3, atol=1e-6)
    assert tb.delta == [float(f"{v:.10g}") for v in
                        torch.exp(tem.params.log_delta).tolist()]
    # the reordered data files: the same rows in the same order
    for f in ("toy-sim_input-f", "toy-sim_output-f"):
        np.testing.assert_array_equal(np.loadtxt(tdir / f),
                                      np.loadtxt(jdir / f))
    # the final fit: same optimum of the likelihood on all 40 rows
    np.testing.assert_allclose(float(tem.state.nll), float(jem.state.nll),
                               rtol=1e-6)
    x_new = np.linspace(0.0, 1.0, 57)[:, None]
    jm, jv = jem.predict(x_new)
    tm, tv = tem.predict(x_new)
    scale = float(np.max(np.abs(np.asarray(jm))))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                               atol=1e-4 * scale)
    # variances between the points are near 0 (nugget 1e-10): held to the
    # prior scale sigma2 times kappa(A) eps64
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-6 * float(jem.state.sigma2))


def test_written_beliefs_resume_the_fit(trained):
    """A second setup from the written files (the reference's checkpoint)
    reproduces the scaling, and a fit at the written hyperparameters gives
    the final NLL again (the rows come in another order, so the factor of
    A, whose nugget is 1e-10, rounds otherwise: rtol 1e-5)."""
    _, _, tdir, tem = trained
    cfg = tg.Config.from_file(tdir / "toy-sim_config")
    cfg.beliefs = str(tdir / "toy-sim_beliefs-f")
    cfg.inputs = str(tdir / "toy-sim_input-f")
    cfg.outputs = str(tdir / "toy-sim_output-f")
    cfg.to_file(tdir / "resume_config")
    again = tg.setup(tdir / "resume_config", datashuffle=False,
                     scaleinputs=False, device="cpu")
    # the same scaled rows (the T/V layout is applied again, so in another
    # order)
    np.testing.assert_allclose(np.sort(again.splits.x_all[:, 0]),
                               np.sort(tem.splits.x_all[:, 0]),
                               rtol=1e-10, atol=1e-12)
    bel = again.beliefs
    params = tg.make_params(bel.delta, nugget=bel.nugget, device="cpu",
                            dtype=torch.float64)
    again.n_folded = again.splits.n_v_sets
    x, y, h = again.train_view()
    state = tgp.fit(params, x, y, h)
    np.testing.assert_allclose(float(state.nll), float(tem.state.nll),
                               rtol=1e-5)


def test_optimize_seeds_and_info(monkeypatch):
    """optimize draws its starts from torch.Generator(seed + n_folded), and
    without a card `setup`/`from_arrays` raise unless given device='cpu'."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(48, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
    emul = _capped(tg.Emulator.from_arrays(x, y, tv_config=(4, 0, 1),
                                           tries=3, device="cpu", seed=5))
    info = emul.optimize()
    want = tg.inference.lbfgs._lhc_starts(
        torch.Generator().manual_seed(5), 3,
        *tg.inference.lbfgs._default_bounds(emul.mle_config, 2),
        torch.float64)
    assert torch.equal(info["starts_logspace"], want)
    assert emul.state is not None and np.isfinite(float(emul.state.nll))
    assert float(emul.state.nll) == pytest.approx(float(info["best_nll"]),
                                                  rel=1e-9)
    emul.n_folded = 1
    info1 = emul.optimize()
    assert not torch.equal(info1["starts_logspace"], want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.setup(EXAMPLES / "toy-sim" / "toy-sim_config")
