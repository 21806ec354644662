r"""Analytic MUCM variance-based sensitivity analysis (closed-form integrals).

Port of `gp_emu_uqsa_tpu.sensitivity._core`. For a trained GP emulator with
the Gaussian kernel, an (at most) linear mean basis and independent normal
inputs x_l ~ N(m_l, v_l), every UQ/SA quantity is a closed form in products
of 1D Gaussian integrals:

  per-dim primitives, with g(u,a) = exp(-(u-a)^2/delta^2), n = N(m, v):
    I0(a)   = \int g(u,a) n(u) du
            = (1+2v/d2)^(-1/2) exp(-(a-m)^2/(d2+2v)),        d2 = delta^2
    mu1(a)  = (m d2 + 2va)/(d2+2v),  w1 = v d2/(d2+2v)
    J0(a,b) = \int g(u,a) g(u,b) n(u) du
            = exp(-(a-b)^2/(2 d2)) (1+4v/d2)^(-1/2)
              exp(-((a+b)/2-m)^2/(d2/2+2v))
    K0      = \int\int g(u,u') n(u) n(u') du du' = (1+4v/d2)^(-1/2)

  emulator functionals (e = A^-1(y-H beta), P = A^-1 H, W = (H^T A^-1 H)^-1,
  T_j = prod_l I0_l(x_jl), rho_l[j,k] = J0_l/(I0_l I0_l)), and for a subset
  w of the inputs the differences from the empty subset, which telescope
  analytically (the literal forms subtract M_0^2 from E[M_w^2] and cancel):

  dU_w = T T^T (*) expm1( sum_{l in w} log rho_l )
  dS_w = rows: 0 for the constant; T (*) 2 v_i (x_i - m_i)/(d2_i + 2 v_i)
         for linear dim i in w; 0 otherwise
  dQ_w = diag( v_i for linear dims i in w )
  dCbar_w = - prod_{l not in w} K0_l * expm1( sum_{l in w} log K0_l )

  E*(V_w) = beta^T dQ beta + 2 beta^T dS e + e^T dU e
            + sigma2 [ dCbar - tr(A^-1 dU)
                       + tr(W (dQ - dS P - P^T dS^T + P^T dU P)) ]

  E*(Var Y) = E*(V_{all dims}),  E*(V_Tw) = E*(Var Y) - E*(V_{-w}).

Two departures from the JAX package, identical in exact arithmetic:
- a subset's log rho sums, one feature at a time into one n x n buffer,
  the squares of an exact sum and an exact difference of scaled inputs,
  with the rank-1 terms folded into their coefficients
  (`_log_rho_sum`); the JAX package expands its squares into Gram
  products, which cancel in fp32;
- the effect curves' variance takes the whitened |L^-1 t_w|^2 in place of
  t_w A^-1 t_w^T, as the serving path does.

Every product with an n x n operand runs in full fp32 or fp64 (TF32 off).
No (d, n, n) or (n, n, |w|) tensor is formed: a subset costs a few n x n
buffers on top of A^-1.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.basis import BasisSpec
from gp_emu_uqsa_torch.ops.cholesky import spd_inverse_from_chol, tri_solve
from gp_emu_uqsa_torch.ops.precision import fp32_exact


class Sensitivity:
    """Closed-form UQSA engine for one trained emulator.

    Args:
      state: gp.FitState of the trained emulator; the engine works on its
        device and in its dtype.
      x: (n, d) training inputs in the emulator's (scaled) input space.
      spec: the mean BasisSpec (constant + linear subset).
      m, v: per-dimension means/variances of the independent normal input
        distribution, in the same (scaled) input space — reference
        `s.setup(emul, m, v)` semantics.
      beta: overrides state.beta for a fixed (non-trained) mean; the
        beta-uncertainty W-corrections are dropped in that case, matching
        `fix_mean` semantics.
    """

    @fp32_exact
    def __init__(self, state: gp.FitState, x, spec: BasisSpec, m, v,
                 beta: Optional[np.ndarray] = None):
        if not spec.is_linear:
            raise ValueError(
                "the analytic MUCM sensitivity integrals require a mean "
                "basis that is at most linear; this emulator's basis has "
                f"monomial power terms {spec.power_terms} (emulation/"
                "prediction supports them, UQSA does not)"
            )
        self.state = state
        self.spec = spec
        dtype, dev = state.l.dtype, state.l.device

        def tensor(a):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                   else a, dtype=dtype, device=dev)

        self.x = tensor(x)
        self.m = tensor(m)
        self.v = tensor(v)
        n, d = self.x.shape
        self.n, self.d = n, d
        if self.m.shape != (d,) or self.v.shape != (d,):
            raise ValueError(f"m and v must have shape ({d},)")

        delta2 = torch.exp(2.0 * state.params.log_delta)        # (d,)
        vv = self.v
        self.delta2 = delta2
        # --- per-dim primitives -------------------------------------------
        self.s1 = 1.0 / torch.sqrt(1.0 + 2.0 * vv / delta2)      # (d,)
        self.s2 = 1.0 / torch.sqrt(1.0 + 4.0 * vv / delta2)      # (d,) == K0_l
        am = self.x - self.m                                     # (n, d)
        self.log_i0 = torch.log(self.s1) - am * am / (delta2 + 2 * vv)
        self.i0 = torch.exp(self.log_i0)
        self.mu1 = (self.m * delta2 + 2 * vv * self.x) / (delta2 + 2 * vv)
        self.w1 = vv * delta2 / (delta2 + 2 * vv)
        self.t_vec = torch.exp(torch.sum(self.log_i0, dim=1))    # (n,) E[t(x)]

        # --- emulator functionals -----------------------------------------
        self.sigma2 = state.sigma2
        self.e = state.e
        self.p_mat = state.ainv_h                                # (n, q_state)
        self.ainv = spd_inverse_from_chol(state.l)               # (n, n)
        q_state = state.ainv_h.shape[1]
        if q_state:
            lg_inv = tri_solve(state.lg, torch.eye(q_state, dtype=dtype,
                                                   device=dev))
            self.w_mat = lg_inv.T @ lg_inv                       # (q, q) = G^-1
        else:
            self.w_mat = torch.zeros((0, 0), dtype=dtype, device=dev)
        self.has_w = q_state > 0 and beta is None
        self.beta = tensor(beta) if beta is not None else state.beta
        # mean-basis bookkeeping: column -> input dim for linear terms
        self.lin = list(spec.linear_dims)
        cols = ([None] if spec.include_const else []) + self.lin
        self.rbar = torch.stack(
            [torch.ones((), dtype=dtype, device=dev) if c is None
             else self.m[c] for c in cols]) if cols else \
            torch.zeros(0, dtype=dtype, device=dev)              # E[h(x)]
        self._cols = cols
        # cache of the w = {} and w = all-dims quantities
        self._m0_v0: Optional[tuple] = None
        self._total: Optional[torch.Tensor] = None

    # --- subset machinery (cancellation-free delta forms) --------------------

    def _log_rho_sum(self, w: Sequence[int]) -> torch.Tensor:
        r"""sum_{l in w} log rho_l[j,k], one (n, n) buffer.

        Per dim, with a = x - m and D = d2_l,
          log rho_l = log K0_l - (x_jl-x_kl)^2/(2 D)
                      - c_l ((x_jl+x_kl)/2 - m_l)^2
                      - log I0_l(x_jl) - log I0_l(x_kl),   c_l = 1/(D/2 + 2 v_l)
                    = log1p(2v/D) - log1p(4v/D)/2
                      + p_l (a_jl + a_kl)^2 - r_l (a_jl - a_kl)^2,
          p_l = v/((D + 2v)(D + 4v)),  r_l = v/(D (D + 2v)).
        The first form adds terms of size a^2/D that cancel to a result of
        size v/D; the second has no such terms: its two squares are of an
        exact sum and an exact difference of scaled inputs, accumulated one
        feature at a time. The JAX package expands both squares of the
        first form into Gram products. fp32 against fp64 on the CPU at n =
        600, d = 8, delta 0.8, nugget 1e-4 (kappa(A) 4.6e4), v 0.02
        (`tools/uqsa_forms.py`): V_Ti 4.6e-3 from the Gram products, 9.4e-4
        from the first form over exact differences, 5.3e-5 from this one
        (relative to the largest V_Ti).
        """
        dtype, dev = self.t_vec.dtype, self.t_vec.device
        out = torch.zeros((self.n, self.n), dtype=dtype, device=dev)
        if not len(w):
            return out
        for l in w:
            dl, vl = self.delta2[l], self.v[l]
            a = self.x[:, l] - self.m[l]
            b = a * torch.sqrt(vl / ((dl + 2.0 * vl) * (dl + 4.0 * vl)))
            t = b[:, None] + b[None, :]
            out.addcmul_(t, t)
            b = a * torch.sqrt(vl / (dl * (dl + 2.0 * vl)))
            t = b[:, None] - b[None, :]
            out.addcmul_(t, t, value=-1.0)
        idx = list(w)
        dl, vl = self.delta2[idx], self.v[idx]
        return out.add_(torch.sum(torch.log1p(2.0 * vl / dl)
                                  - 0.5 * torch.log1p(4.0 * vl / dl)))

    def _delta_mats(self, w: Sequence[int]):
        """(dU, dS, dQ, dCbar) for subset w — exact w-minus-base differences."""
        w = [int(i) for i in w]
        dtype, dev = self.t_vec.dtype, self.t_vec.device
        du = self._log_rho_sum(w).expm1_()
        du.mul_(self.t_vec[:, None]).mul_(self.t_vec[None, :])
        wset = set(w)
        rows = []
        for c in self._cols:
            if c is not None and c in wset:
                dmu = 2.0 * self.v[c] * (self.x[:, c] - self.m[c]) / (
                    self.delta2[c] + 2.0 * self.v[c]
                )
                rows.append(self.t_vec * dmu)
            else:
                rows.append(torch.zeros(self.n, dtype=dtype, device=dev))
        ds = (torch.stack(rows) if rows
              else torch.zeros((0, self.n), dtype=dtype, device=dev))
        dq = torch.diag(torch.stack(
            [self.v[c] if (c is not None and c in wset)
             else torch.zeros((), dtype=dtype, device=dev)
             for c in self._cols])) if self._cols else \
            torch.zeros((0, 0), dtype=dtype, device=dev)
        log_s2 = torch.log(self.s2)
        in_w = torch.zeros(self.d, dtype=torch.bool, device=dev)
        in_w[w] = True
        zero = torch.zeros((), dtype=dtype, device=dev)
        cbar_rest = torch.exp(torch.sum(torch.where(in_w, zero, log_s2)))
        dcbar = -cbar_rest * torch.expm1(
            torch.sum(torch.where(in_w, log_s2, zero)))
        return du, ds, dq, dcbar

    def _cbar_w(self, w: Sequence[int]) -> torch.Tensor:
        """Cbar_w = prod_{l not in w} K0_l."""
        keep = [l for l in range(self.d) if l not in set(int(i) for i in w)]
        return torch.exp(torch.sum(torch.log(self.s2[keep])))

    # --- public API ----------------------------------------------------------

    @fp32_exact
    def _base(self):
        """(M_0, v_0*) for the empty subset, via stable whitened solves."""
        if self._m0_v0 is None:
            m0 = self.rbar @ self.beta + self.t_vec @ self.e
            linv_t = tri_solve(self.state.l, self.t_vec[:, None])[:, 0]
            tat = torch.sum(linv_t * linv_t)
            cbar0 = torch.exp(torch.sum(torch.log(self.s2)))
            v0 = cbar0 - tat
            if self.has_w:
                rt0 = self.rbar - self.t_vec @ self.p_mat
                v0 = v0 + rt0 @ self.w_mat @ rt0
            self._m0_v0 = (m0, self.sigma2 * v0)
        return self._m0_v0

    def uncertainty(self) -> dict:
        """Posterior UQ of E[Y]: E*[E(Y)], V*[E(Y)], and E*[Var(Y)].

        Reference `Sensitivity.uncertainty()`.
        """
        m0, v0 = self._base()
        return {
            "E_EY": m0,
            "V_EY": v0,
            "E_VarY": self.total_variance(),
        }

    def total_variance(self) -> torch.Tensor:
        """E*[Var(Y)] — the w = all-dims sensitivity variance."""
        if self._total is None:
            self._total = self.sensitivity_variance(tuple(range(self.d)))
        return self._total

    @fp32_exact
    def sensitivity_variance(self, w: Sequence[int]) -> torch.Tensor:
        """E*(V_w) = E*[Var(E[Y|x_w])] for an arbitrary subset w."""
        du, ds, dq, dcbar = self._delta_mats(w)
        du_e = du @ self.e
        val = (
            self.beta @ dq @ self.beta
            + 2.0 * (self.beta @ ds @ self.e)
            + self.e @ du_e
        )
        corr = dcbar - torch.sum(self.ainv * du)
        if self.has_w:
            m1 = ds @ self.p_mat
            inner = dq - m1 - m1.T + self.p_mat.T @ (du @ self.p_mat)
            corr = corr + torch.sum(self.w_mat * inner)
        return val + self.sigma2 * corr

    def sensitivity(self) -> dict:
        """First-order E*(V_i) and indices S_i = E*(V_i)/E*(Var Y)."""
        vis = torch.stack([self.sensitivity_variance((i,))
                           for i in range(self.d)])
        total = self.total_variance()
        return {"V_i": vis, "S_i": vis / total, "V_total": total}

    def totaleffectvariance(self) -> dict:
        """Total-effect variances E*(V_Ti) = E*(VarY) - E*(V_{-i})."""
        total = self.total_variance()
        vtis = []
        for i in range(self.d):
            comp = tuple(j for j in range(self.d) if j != i)
            vtis.append(total - self.sensitivity_variance(comp))
        vtis = torch.stack(vtis)
        return {"V_Ti": vtis, "S_Ti": vtis / total, "V_total": total}

    # --- effect curves -------------------------------------------------------

    def _t_w_grid(self, w: Sequence[int], grid: torch.Tensor) -> torch.Tensor:
        """T_w rows for grid points over dims w; grid (G, |w|) -> (G, n)."""
        w = list(w)
        rest = [l for l in range(self.d) if l not in set(w)]
        log_t_rest = torch.sum(self.log_i0[:, rest], dim=1)      # (n,)
        lg = torch.zeros((grid.shape[0], self.n), dtype=self.t_vec.dtype,
                         device=self.t_vec.device)
        for col, l in enumerate(w):
            diff = grid[:, col][:, None] - self.x[:, l][None, :]
            lg = lg - diff * diff / self.delta2[l]
        return torch.exp(lg + log_t_rest[None, :])

    def _r_w_grid(self, w: Sequence[int], grid: torch.Tensor) -> torch.Tensor:
        """R_w rows at grid points, (G, q_mean)."""
        wl = {int(l): c for c, l in enumerate(w)}
        cols = []
        g_n = grid.shape[0]
        one = torch.ones(g_n, dtype=self.t_vec.dtype, device=self.t_vec.device)
        for c in self._cols:
            if c is None:
                cols.append(one)
            elif c in wl:
                cols.append(grid[:, wl[c]])
            else:
                cols.append(one * self.m[c])
        return (torch.stack(cols, 1) if cols else
                torch.zeros((g_n, 0), dtype=self.t_vec.dtype,
                            device=self.t_vec.device))

    @fp32_exact
    def effect_curve(self, w: Sequence[int], grid):
        """Posterior mean and variance of E[Y | x_w] on grid points.

        grid: (G, |w|) values of x_w. Returns (mean (G,), var (G,)).
        """
        w = [int(i) for i in w]
        grid = torch.as_tensor(np.asarray(grid) if not torch.is_tensor(grid)
                               else grid, dtype=self.t_vec.dtype,
                               device=self.t_vec.device)
        grid = torch.atleast_2d(grid)
        if grid.shape[1] != len(w):
            grid = grid.reshape(-1, len(w))
        t_w = self._t_w_grid(w, grid)                            # (G, n)
        r_w = self._r_w_grid(w, grid)                            # (G, q)
        mean = r_w @ self.beta + t_w @ self.e
        cbar = self._cbar_w(w)
        white = tri_solve(self.state.l, t_w.T)                   # (n, G)
        var = cbar - torch.sum(white * white, dim=0)
        if self.has_w:
            rt = r_w - t_w @ self.p_mat                          # (G, q)
            var = var + torch.sum((rt @ self.w_mat) * rt, dim=1)
        return mean, self.sigma2 * torch.clamp(var, min=0.0)

    def _span_grid(self, i: int, points: int, span: float) -> torch.Tensor:
        sd_i = torch.sqrt(self.v[i])
        lo, hi = self.m[i] - span * sd_i, self.m[i] + span * sd_i
        steps = torch.linspace(0.0, 1.0, points, dtype=self.v.dtype,
                               device=self.v.device)
        return lo + (hi - lo) * steps

    def main_effect(self, i: int, points: int = 100, span: float = 2.5):
        """Main-effect curve E[Y|x_i] (mean, sd) over m_i +- span*sqrt(v_i).

        Returns (grid, mean, sd, deviation) with deviation = mean - E*[E Y]
        (the MUCM zero-mean main-effect convention).
        """
        grid = self._span_grid(i, points, span)
        mean, var = self.effect_curve((i,), grid[:, None])
        m0, _ = self._base()
        return grid, mean, torch.sqrt(var), mean - m0

    def interaction_effect(self, i: int, j: int, points: int = 25,
                           span: float = 2.5):
        """Interaction surface I_{ij} = E[Y|x_i,x_j] - M_i - M_j + E[Y].

        Returns (grid_i, grid_j, surface (points, points)).
        """
        gi = self._span_grid(i, points, span)
        gj = self._span_grid(j, points, span)
        gg = torch.stack(torch.meshgrid(gi, gj, indexing="ij"), -1).reshape(-1, 2)
        mij, _ = self.effect_curve((i, j), gg)
        mi, _ = self.effect_curve((i,), gi[:, None])
        mj, _ = self.effect_curve((j,), gj[:, None])
        m0, _ = self._base()
        surf = (
            mij.reshape(points, points)
            - mi[:, None] - mj[None, :] + m0
        )
        return gi, gj, surf

    # --- reporting -----------------------------------------------------------

    def to_file(self, path) -> None:
        """Write an indices table (reference `Sensitivity.to_file`)."""
        sens = self.sensitivity()
        tot = self.totaleffectvariance()
        unc = self.uncertainty()
        lines = [
            f"E*[E(Y)] {float(unc['E_EY']):.10g}",
            f"V*[E(Y)] {float(unc['V_EY']):.10g}",
            f"E*[Var(Y)] {float(unc['E_VarY']):.10g}",
            "input E*(V_i) S_i E*(V_Ti) S_Ti",
        ]
        for i in range(self.d):
            lines.append(
                f"{i} {float(sens['V_i'][i]):.10g} {float(sens['S_i'][i]):.10g} "
                f"{float(tot['V_Ti'][i]):.10g} {float(tot['S_Ti'][i]):.10g}"
            )
        Path(path).write_text("\n".join(lines) + "\n")
