"""fp32 against fp64 for three forms of UQSA's subset log rho.

    python -m gp_emu_uqsa_torch.tools.uqsa_forms [--n 600] [--delta 0.8]
        [--nugget 1e-4] [--device cpu]

The three forms are equal in exact arithmetic:
- "port": `sensitivity._core.Sensitivity._log_rho_sum`, the squares of an
  exact sum and an exact difference of scaled inputs a feature, the rank-1
  terms folded into their coefficients;
- "differences": the exact per-feature differences of the textbook form,
  -(x_jl - x_kl)^2/(2 d2) - c ((x_jl + x_kl)/2 - m)^2, with the rank-1
  terms -log I0 added after (`difference_log_rho_sum`);
- "gram": the JAX package's, both squares expanded into Gram products
  (`gram_log_rho_sum`).
For each form it prints the largest entrywise fp32 error of the all-dims
log rho and the errors of the indices (V_i, V_Ti relative to the largest
value, S_i, S_Ti absolute), fp32 against the port's fp64 at the same
hyperparameters. Data: x ~ U[0,1)^8 (seed 0), y = sin(3 x0) + x1 x2 + 0.1
sum(x), linear basis, m = 0.5, v = 0.02.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.kernels import make_params
from gp_emu_uqsa_torch.ops.precision import fp32_exact_matmul
from gp_emu_uqsa_torch.sensitivity import Sensitivity

DIM = 8


def gram_log_rho_sum(sens: Sensitivity, w) -> torch.Tensor:
    """The JAX package's `_log_rho_sum` (sensitivity/_core.py): both squares
    expanded into Gram products, in torch with TF32 off."""
    idx = list(w)
    xw = sens.x[:, idx]
    d2, vw, mw = sens.delta2[idx], sens.v[idx], sens.m[idx]
    with fp32_exact_matmul():
        xa = xw * torch.sqrt(1.0 / (2.0 * d2))
        sq_a = torch.sum(xa * xa, dim=1)
        term_a = -(sq_a[:, None] + sq_a[None, :] - 2.0 * (xa @ xa.T))
        yb = 0.5 * (xw - mw) * torch.sqrt(1.0 / (0.5 * d2 + 2.0 * vw))
        sq_b = torch.sum(yb * yb, dim=1)
        term_b = -(sq_b[:, None] + sq_b[None, :] + 2.0 * (yb @ yb.T))
    li = torch.sum(sens.log_i0[:, idx], dim=1)
    const = torch.sum(torch.log(sens.s2[idx]))
    return const + term_a + term_b - li[:, None] - li[None, :]


def difference_log_rho_sum(sens: Sensitivity, w) -> torch.Tensor:
    """The textbook form over exact per-feature differences and sums, the
    rank-1 terms -log I0(x_j) - log I0(x_k) added after."""
    out = torch.zeros((sens.n, sens.n), dtype=sens.x.dtype,
                      device=sens.x.device)
    for l in w:
        d2, vl, ml = sens.delta2[l], sens.v[l], sens.m[l]
        xa = sens.x[:, l] * torch.sqrt(1.0 / (2.0 * d2))
        t = xa[:, None] - xa[None, :]
        out.sub_(t * t)
        yb = 0.5 * (sens.x[:, l] - ml) * torch.sqrt(1.0 / (0.5 * d2
                                                           + 2.0 * vl))
        t = yb[:, None] + yb[None, :]
        out.sub_(t * t)
    idx = list(w)
    li = torch.sum(sens.log_i0[:, idx], dim=1)
    return out - li[:, None] - li[None, :] + torch.sum(torch.log(sens.s2[idx]))


FORMS = {"port": None, "differences": difference_log_rho_sum,
         "gram": gram_log_rho_sum}


def run(n: int, delta: float, nugget: float, device) -> dict:
    """{(dtype, form): (log rho of all dims, indices)} at one fit."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(n, DIM))
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x.sum(1)
    spec = linear_basis(DIM)
    m, v = np.full(DIM, 0.5), np.full(DIM, 0.02)
    out = {}
    for dtype in (torch.float64, torch.float32):
        tx = torch.as_tensor(x, dtype=dtype, device=device)
        params = make_params(np.full(DIM, delta), nugget=nugget,
                             device=device, dtype=dtype)
        state = gp.fit(params, tx, torch.as_tensor(y, dtype=dtype,
                                                   device=device),
                       basis_matrix(tx, spec))
        for name, form in FORMS.items():
            sens = Sensitivity(state, tx, spec, m, v)
            if form is not None:
                sens._log_rho_sum = form.__get__(sens)
            res = {**sens.sensitivity(), **sens.totaleffectvariance()}
            out[dtype, name] = (sens._log_rho_sum(tuple(range(DIM))).double(),
                                {k: t.double() for k, t in res.items()})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--delta", type=float, default=0.8)
    ap.add_argument("--nugget", type=float, default=1e-4)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    out = run(args.n, args.delta, args.nugget, torch.device(args.device))
    lr64, ref = out[torch.float64, "port"]
    print(f"n={args.n}, d={DIM}, delta {args.delta}, nugget {args.nugget}, "
          f"{args.device}: fp32 against fp64 (max |log rho| "
          f"{float(lr64.abs().max()):.4g})")
    for name in FORMS:
        lr, res = out[torch.float32, name]
        errs = {q: float((res[q] - ref[q]).abs().max()) for q in
                ("V_i", "V_Ti", "S_i", "S_Ti")}
        for q in ("V_i", "V_Ti"):
            errs[q] /= float(ref[q].abs().max())
        print(f"  {name}: log rho {float((lr - lr64).abs().max()):.3e}; "
              + ", ".join(f"{q} {e:.3e}" for q, e in errs.items()))


if __name__ == "__main__":
    main()
