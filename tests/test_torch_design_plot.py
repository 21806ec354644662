"""The port's optimized Latin hypercube and plots.

`optLatinHyperCube` draws its candidates from a CPU torch.Generator, so its
designs differ from the JAX package's; it is held to the properties
tests/test_design.py asks of the JAX one (Latin in every column, scaled to
minmax, written to the file, better than a random design) and to the
exact maximin score over its own candidates. The plotting functions return
Figures and write PNGs, as the JAX package's do.
"""
import numpy as np
import pytest
import torch

from gp_emu_uqsa_torch import gp, plot
from gp_emu_uqsa_torch.design_inputs import _candidate_lhc, optLatinHyperCube
from gp_emu_uqsa_torch.emulator import Emulator
from gp_emu_uqsa_torch.inference import MLEConfig
from gp_emu_uqsa_torch.kernels import make_params
from gp_emu_uqsa_torch.multi import MultiEmulator
import gp_emu_uqsa_torch.sensitivity as s


def _min_dist(x):
    d = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    return d.min()


def test_lhc_is_latin_scaled_and_written(tmp_path):
    mm = [[0.0, 2.0], [10.0, 20.0], [-1.0, 1.0]]
    x = optLatinHyperCube(3, 16, 40, mm, filename=str(tmp_path / "d"),
                          device="cpu")
    assert x.shape == (16, 3)
    for j, (lo, hi) in enumerate(mm):
        assert x[:, j].min() >= lo and x[:, j].max() <= hi
        strata = np.clip(np.floor((x[:, j] - lo) / (hi - lo) * 16).astype(int),
                         0, 15)
        assert len(set(strata.tolist())) == 16
    np.testing.assert_allclose(np.loadtxt(tmp_path / "d"), x, rtol=1e-10)


def test_lhc_is_the_maximin_candidate():
    """The design is the candidate with the largest smallest distance among
    the N drawn from torch.Generator(seed), scored here in NumPy."""
    dim, n, big_n, seed = 2, 20, 30, 4
    gen = torch.Generator().manual_seed(seed)
    cands = [_candidate_lhc(gen, dim, n).numpy() for _ in range(big_n)]
    best = int(np.argmax([_min_dist(c) for c in cands]))
    got = optLatinHyperCube(dim, n, big_n, [[0, 1]] * dim, seed=seed,
                            device="cpu")
    np.testing.assert_array_equal(got, cands[best])


def test_maximin_beats_random():
    mm = [[0, 1]] * 2
    best = optLatinHyperCube(2, 20, 200, mm, seed=1, device="cpu")
    single = optLatinHyperCube(2, 20, 1, mm, seed=2, device="cpu")
    assert _min_dist(best) > _min_dist(single)


def test_plots_return_figures_and_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(30, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    emul = Emulator.from_arrays(x, y, tv_config=(3, 0, 1), device="cpu")
    emul.params = make_params([0.5, 0.8], nugget=1e-6, device="cpu",
                              dtype=torch.float64)
    emul.state = gp.fit(emul.params, *emul.train_view())
    figs = {
        "plot1d": plot(emul, [0], [1], [0.3], "mean", points=20,
                       save=str(tmp_path / "plot1d.png")),
        "plot2d": plot(emul, [0, 1], mean_or_var="var", points=10,
                       save=str(tmp_path / "plot2d.png")),
    }
    sens = s.setup(emul, [0.5, 0.5], [0.02, 0.02])
    figs["main"] = s.plot_main_effects(sens, points=15,
                                       save=str(tmp_path / "main.png"))
    figs["inter"] = s.plot_interaction_effect(sens, 0, 1, points=6,
                                              save=str(tmp_path / "inter.png"))
    me = MultiEmulator.fit(None, x, np.stack([y, x[:, 0] * y], 1),
                           cfg=MLEConfig(tries=2, max_iters=10), device="cpu")
    figs["table"] = s.sense_table(me.sensitivities([0.5, 0.5], [0.02, 0.02]),
                                  ["a", "b"], ["y", "xy"],
                                  save=str(tmp_path / "table.png"))
    import matplotlib.figure
    for name, fig in figs.items():
        assert isinstance(fig, matplotlib.figure.Figure), name
        assert (tmp_path / f"{name}.png").stat().st_size > 0
    with pytest.raises(ValueError, match="1 or 2 entries"):
        plot(emul, [0, 1, 0], points=3)
