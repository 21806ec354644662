"""Multi-output emulation: k GPs over shared inputs, trained as one batch.

Port of `gp_emu_uqsa_tpu.multi`. The reference trains one emulator per
output column, one after another, and compares them with `sense_table`.
Here the outputs are another batch axis: the (outputs x restarts) MLE grid
runs as one `inference.lbfgs.run_restarts` batch (each objective call one
batched Cholesky over the grid's running rows, y carried per row), all
outputs sharing the Latin-hypercube starts, as in the JAX package.

    me = MultiEmulator.fit(generator, x, Y, tries=8, device="cuda")  # Y: (n, k)
    means, variances = me.predict(xs)               # (k, m) each
    tables = me.sensitivities(m, v)                 # list of Sensitivity
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.basis import BasisSpec, basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference.lbfgs import (
    MLEConfig, _default_bounds, _lhc_starts, _make_objective, _unpack,
    run_restarts,
)
from gp_emu_uqsa_torch.kernels import GPParams
from gp_emu_uqsa_torch.sensitivity._core import Sensitivity


@dataclasses.dataclass
class MultiEmulator:
    """k independent GPs over shared inputs, batched on the device."""

    x: torch.Tensor               # (n, d) scaled inputs
    y: torch.Tensor               # (n, k)
    h: torch.Tensor               # (n, q)
    spec: BasisSpec
    cfg: MLEConfig
    params: GPParams              # leaves batched with leading k
    states: list                  # one gp.FitState an output
    info: dict

    @classmethod
    def fit(
        cls,
        generator: Optional[torch.Generator],
        x,
        y,
        *,
        basis: Optional[BasisSpec] = None,
        cfg: Optional[MLEConfig] = None,
        tries: int = 8,
        nugget: float = 1e-8,
        dtype=torch.float64,
        device=None,
        starts=None,
    ) -> "MultiEmulator":
        """Fit every output column of y (n, k) by multi-restart MLE.

        The `tries` log-space starts are drawn from `generator` (a CPU
        torch.Generator, seed 0 when None) as `mle_fit` draws them, or
        given as `starts` (tries, p), for example the JAX package's. The
        k x tries restarts run in one lockstep batch; each output keeps its
        best finite restart. `device=None` means the CUDA card.
        """
        dev = resolve_device(device)
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)
        y = torch.as_tensor(np.asarray(y), dtype=dtype, device=dev)
        if y.ndim == 1:
            y = y[:, None]
        d = x.shape[1]
        k = y.shape[1]
        spec = basis if basis is not None else linear_basis(d)
        h = basis_matrix(x, spec)
        cfg = cfg if cfg is not None else MLEConfig(tries=tries, nugget=nugget)
        lo, hi = _default_bounds(cfg, d)
        if starts is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            starts = _lhc_starts(generator, cfg.tries, lo, hi, dtype)
        z0s = torch.as_tensor(np.asarray(starts), dtype=dtype, device=dev)
        tries = z0s.shape[0]
        # row r of the grid: output r // tries from start r % tries
        y_rows = y.T.repeat_interleave(tries, dim=0)         # (k tries, n)
        objective, to_logspace, from_logspace = _make_objective(
            x, y_rows, h, cfg, lo, hi)
        u0s = from_logspace(z0s).repeat(k, 1)
        us, vs, iters = run_restarts(objective, u0s, cfg.max_iters, cfg.tol)
        us, vs, iters = (t.reshape(k, tries, *t.shape[1:])
                         for t in (us, vs, iters))
        finite = torch.where(torch.isfinite(vs), vs,
                             torch.full_like(vs, float("inf")))
        best = torch.argmin(finite, dim=1)
        u_best = us[torch.arange(k, device=dev), best]
        params = _unpack(to_logspace(u_best), cfg, d, dtype)
        states = [gp.fit(GPParams(*(t[i] for t in params)), x, y[:, i], h,
                         mode=cfg.mode)
                  for i in range(k)]
        info = {"nlls": vs, "best_index": best, "iters": iters,
                "starts_logspace": z0s}
        return cls(x, y, h, spec, cfg, params, states, info)

    @property
    def n_outputs(self) -> int:
        return self.y.shape[1]

    def predict(self, xstar, hstar=None):
        """Posterior mean/var for every output (`gp.predict`): (k, m) each."""
        xstar = torch.as_tensor(np.asarray(xstar) if not torch.is_tensor(xstar)
                                else xstar, dtype=self.x.dtype,
                                device=self.x.device)
        hstar = (torch.as_tensor(hstar, dtype=self.x.dtype,
                                 device=self.x.device)
                 if hstar is not None else basis_matrix(xstar, self.spec))
        out = [gp.predict(st, self.x, self.h, xstar, hstar)
               for st in self.states]
        return (torch.stack([m for m, _ in out]),
                torch.stack([v for _, v in out]))

    def state_for(self, k: int) -> gp.FitState:
        return self.states[k]

    def sensitivities(self, m, v) -> list[Sensitivity]:
        """Per-output Sensitivity engines (feed to sense_table)."""
        return [
            Sensitivity(self.state_for(k), self.x, self.spec, m, v)
            for k in range(self.n_outputs)
        ]

    def sense_matrix(self, m, v) -> np.ndarray:
        """(k, d) matrix of first-order indices S_i across outputs."""
        return np.stack(
            [s.sensitivity()["S_i"].cpu().numpy()
             for s in self.sensitivities(m, v)]
        )
