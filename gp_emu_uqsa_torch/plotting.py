"""Posterior plots (port of `gp_emu_uqsa_tpu.plotting`).

`plot(emul, plot_dims, fixed_dims, fixed_vals, mean_or_var, points)` draws
the posterior mean or variance over a 1D line / 2D grid in *scaled* input
space with the remaining dims pinned, plus the training points — the
reference's `g.plot` surface. Matplotlib is imported inside `plot` only,
with the Agg backend.
"""
from __future__ import annotations

import numpy as np
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.basis import basis_matrix
from gp_emu_uqsa_torch.emulator import Emulator


def _grid_predictions(emul: Emulator, plot_dims, fixed_dims, fixed_vals, points):
    d = emul.splits.x_all.shape[1]
    axes = [np.linspace(0.0, 1.0, points) for _ in plot_dims]
    mesh = np.meshgrid(*axes, indexing="ij")
    m = mesh[0].size
    xs = np.zeros((m, d))
    for k, dim in enumerate(plot_dims):
        xs[:, dim] = mesh[k].ravel()
    for dim, val in zip(fixed_dims, fixed_vals):
        xs[:, dim] = val
    x, _, h = emul.train_view()
    xst = torch.as_tensor(xs, dtype=emul.dtype, device=emul.device)
    hs = (
        torch.zeros((m, 0), dtype=emul.dtype, device=emul.device)
        if emul.fixed_beta is not None
        else basis_matrix(xst, emul.spec)
    )
    mean, var = gp.predict(emul.state, x, h, xst, hs,
                           family=emul.mle_config.family)
    mean = mean.cpu().double().numpy()
    if emul.fixed_beta is not None:
        mean = mean + (basis_matrix(torch.as_tensor(xs), emul.spec).numpy()
                       @ emul.fixed_beta)
    return axes, mesh, mean, var.cpu().double().numpy()


def plot(
    emul: Emulator,
    plot_dims,
    fixed_dims=(),
    fixed_vals=(),
    mean_or_var: str = "mean",
    points: int = 50,
    *,
    save: str | None = None,
    show: bool = False,
):
    """1D/2D posterior plot. Returns the matplotlib Figure."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if emul.state is None:
        raise RuntimeError("emulator not trained: call train()/optimize() first")
    plot_dims = list(np.atleast_1d(plot_dims))
    fixed_dims = list(np.atleast_1d(fixed_dims)) if len(np.atleast_1d(fixed_dims)) else []
    fixed_vals = list(np.atleast_1d(fixed_vals)) if len(np.atleast_1d(fixed_vals)) else []
    axes, mesh, mean, var = _grid_predictions(
        emul, plot_dims, fixed_dims, fixed_vals, points
    )
    field = mean if mean_or_var == "mean" else var
    xt = np.asarray(emul.splits.x_all[emul.splits.train_rows(emul.n_folded)])
    yt = np.asarray(emul.splits.y_all[emul.splits.train_rows(emul.n_folded)])

    fig, ax = plt.subplots(figsize=(7, 5))
    if len(plot_dims) == 1:
        g = axes[0]
        ax.plot(g, field, label=mean_or_var)
        if mean_or_var == "mean":
            sd = np.sqrt(var)
            ax.fill_between(g, field - 2 * sd, field + 2 * sd, alpha=0.25,
                            label="±2 sd")
            ax.plot(xt[:, plot_dims[0]], yt, "k.", ms=5, label="training")
        ax.set_xlabel(f"x[{plot_dims[0]}] (scaled)")
        ax.set_ylabel(mean_or_var)
        ax.legend()
    elif len(plot_dims) == 2:
        z = field.reshape(points, points)
        pc = ax.pcolormesh(mesh[0], mesh[1], z, shading="auto")
        fig.colorbar(pc, ax=ax, label=mean_or_var)
        ax.plot(xt[:, plot_dims[0]], xt[:, plot_dims[1]], "k.", ms=4)
        ax.set_xlabel(f"x[{plot_dims[0]}] (scaled)")
        ax.set_ylabel(f"x[{plot_dims[1]}] (scaled)")
    else:
        raise ValueError("plot_dims must have 1 or 2 entries")
    ax.set_title(f"posterior {mean_or_var}")
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
    if show:  # pragma: no cover
        plt.show()
    return fig
