"""Sensitivity subpackage facade (port of `gp_emu_uqsa_tpu.sensitivity`).

    import gp_emu_uqsa_torch.sensitivity as s
    sens = s.setup(emul, m, v)       # Sensitivity for a trained Emulator
    sens.uncertainty(); sens.sensitivity(); sens.main_effect(0)
    s.sense_table([sens1, sens2], inputNames, outputNames)

`m`/`v` are the means/variances of the independent normal input
distributions in the emulator's (scaled) input space. The engine runs where
the emulator's fit state is, in its dtype. Matplotlib is imported inside the
plotting functions only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from gp_emu_uqsa_torch.emulator import Emulator
from gp_emu_uqsa_torch.sensitivity._core import Sensitivity

__all__ = ["Sensitivity", "setup", "marginalized", "plot_main_effects",
           "plot_interaction_effect", "sense_table"]


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def setup(emul: Emulator, m, v, *, raw_space: bool = False) -> Sensitivity:
    """Build the Sensitivity engine from a trained Emulator.

    m, v are the input-distribution means/variances. By default they are in
    the emulator's internal (min-max scaled) input space, like the
    reference; with raw_space=True they are given in ORIGINAL simulator
    units and transformed through the emulator's stored scaling
    (m' = (m-lo)/span, v' = v/span^2).
    """
    if emul.state is None:
        raise RuntimeError("emulator must be trained before sensitivity setup")
    if emul.mle_config.family != "gaussian":
        raise ValueError(
            "the analytic MUCM sensitivity integrals exist only for the "
            f"gaussian kernel family (emulator uses {emul.mle_config.family!r})"
        )
    m = np.asarray(m, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    if raw_space:
        if emul.splits.minmax is None:
            raise ValueError("raw_space=True needs a scaled emulator "
                             "(splits.minmax is None)")
        mm = np.asarray(emul.splits.minmax)
        span = np.where(mm[:, 1] > mm[:, 0], mm[:, 1] - mm[:, 0], 1.0)
        m = (m - mm[:, 0]) / span
        v = v / span**2
    x, _, _ = emul.train_view()
    return Sensitivity(emul.state, x, emul.spec, m, v, beta=emul.fixed_beta)


def marginalized(
    emul: Emulator,
    m,
    v,
    z_samples,
    *,
    max_draws: int = 16,
) -> dict:
    """UQSA marginalized over the hyperparameter posterior.

    z_samples: (chains, n, p) or (draws, p) posterior draws in the MLE
    flat-parameter layout (inference.lbfgs._unpack). For `max_draws` thinned
    draws the emulator is refit and the analytic indices recomputed; returns
    posterior mean and sd of every index plus the per-draw values.
    """
    from gp_emu_uqsa_torch import gp as gpmod
    from gp_emu_uqsa_torch.inference.lbfgs import _unpack

    x, y, h = emul.train_view()
    d = x.shape[1]
    z_all = _np(z_samples)
    flat = z_all.reshape(-1, z_all.shape[-1])
    stride = max(1, len(flat) // max_draws)
    draws = flat[::stride][:max_draws]
    s_i, s_ti, e_ey, e_var = [], [], [], []
    for z in draws:
        params = _unpack(torch.as_tensor(z, dtype=x.dtype, device=x.device),
                         emul.mle_config, d, x.dtype)
        state = gpmod.fit(params, x, y, h, mode=emul.mle_config.mode)
        sens = Sensitivity(state, x, emul.spec, m, v, beta=emul.fixed_beta)
        si = sens.sensitivity()
        ti = sens.totaleffectvariance()
        unc = sens.uncertainty()
        s_i.append(_np(si["S_i"]))
        s_ti.append(_np(ti["S_Ti"]))
        e_ey.append(float(unc["E_EY"]))
        e_var.append(float(unc["E_VarY"]))
    s_i = np.stack(s_i)
    s_ti = np.stack(s_ti)
    return {
        "S_i_mean": s_i.mean(0), "S_i_sd": s_i.std(0),
        "S_Ti_mean": s_ti.mean(0), "S_Ti_sd": s_ti.std(0),
        "E_EY_mean": float(np.mean(e_ey)), "E_EY_sd": float(np.std(e_ey)),
        "E_VarY_mean": float(np.mean(e_var)), "E_VarY_sd": float(np.std(e_var)),
        "per_draw_S_i": s_i,
        "n_draws": len(draws),
    }


def _pyplot():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plot_main_effects(
    sens: Sensitivity,
    dims=None,
    points: int = 100,
    save: Optional[str] = None,
):
    """Main-effect curves E[Y|x_i] with +-2 sd bands (reference
    `main_effect(plot=True)`). Returns the Figure."""
    plt = _pyplot()
    dims = list(dims) if dims is not None else list(range(sens.d))
    fig, ax = plt.subplots(figsize=(7, 5))
    for i in dims:
        grid, _, sd, dev = sens.main_effect(i, points=points)
        g, m_arr, s_arr = _np(grid), _np(dev), _np(sd)
        (line,) = ax.plot(g, m_arr, label=f"x[{i}]")
        ax.fill_between(g, m_arr - 2 * s_arr, m_arr + 2 * s_arr,
                        alpha=0.15, color=line.get_color())
    ax.set_xlabel("x_i")
    ax.set_ylabel("E[Y | x_i] - E[Y]")
    ax.set_title("Main effects (deviation form), ±2 sd")
    ax.legend()
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def plot_interaction_effect(
    sens: Sensitivity,
    i: int,
    j: int,
    points: int = 25,
    save: Optional[str] = None,
):
    """Interaction surface I_{ij}(x_i, x_j) as a filled contour plot.

    Reference `interaction_effect(i, j)`; the raw arrays come from
    `Sensitivity.interaction_effect`. Returns the Figure.
    """
    plt = _pyplot()
    gi, gj, surf = (_np(a) for a in sens.interaction_effect(i, j,
                                                            points=points))
    fig, ax = plt.subplots(figsize=(6, 5))
    # surf is indexed [i_idx, j_idx]; contourf expects Z[y, x] so transpose
    cf = ax.contourf(gi, gj, surf.T, levels=20)
    fig.colorbar(cf, ax=ax, label=f"$I_{{{i}{j}}}(x_{{{i}}}, x_{{{j}}})$")
    ax.set_xlabel(f"x[{i}]")
    ax.set_ylabel(f"x[{j}]")
    ax.set_title(f"Interaction effect of inputs {i} and {j}")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig


def sense_table(
    sens_list: Sequence[Sensitivity],
    input_names: Optional[Sequence[str]] = None,
    output_names: Optional[Sequence[str]] = None,
    save: Optional[str] = None,
    *,
    totals: bool = True,
):
    """Matplotlib table of sensitivity indices across emulators/outputs.

    Reference `sense_table(emuls, inputNames, outputNames)`. With
    `totals=True` (default) each input contributes two columns — the
    first-order index S_i and the total-effect index S_Ti; `totals=False`
    reproduces the S_i-only layout. Returns the Figure.
    """
    plt = _pyplot()
    d = sens_list[0].d
    input_names = list(input_names) if input_names else [f"x{i}" for i in range(d)]
    output_names = (
        list(output_names) if output_names else [f"y{k}" for k in range(len(sens_list))]
    )
    rows = []
    for sens in sens_list:
        si = _np(sens.sensitivity()["S_i"])
        if totals:
            sti = _np(sens.totaleffectvariance()["S_Ti"])
            rows.append([f"{a:.3f} / {b:.3f}" for a, b in zip(si, sti)])
        else:
            rows.append([f"{v:.3f}" for v in si])
    col_labels = (
        [f"{nm}\nS / S_T" for nm in input_names] if totals else input_names
    )
    fig, ax = plt.subplots(figsize=(1.5 + (1.6 if totals else 1.0) * d,
                                    1 + 0.5 * len(rows)))
    ax.axis("off")
    table = ax.table(
        cellText=rows,
        rowLabels=output_names,
        colLabels=col_labels,
        loc="center",
        cellLoc="center",
    )
    table.scale(1, 1.6 if totals else 1.4)
    ax.set_title(
        "Sensitivity indices $S_i$ / total-effect $S_{Ti}$"
        if totals else "First-order sensitivity indices $S_i$"
    )
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    return fig
