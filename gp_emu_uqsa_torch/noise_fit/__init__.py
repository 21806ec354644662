"""Heteroscedastic noise fitting (Goldberg-style alternating scheme).

Port of `gp_emu_uqsa_tpu.noise_fit`. Reference parity:
`gp_emu_uqsa/noise_fit/noisefit(data_conf, noise_conf, stopat, olhcmult)`
(SURVEY.md S3 "Noise fit", S4.5 call stack): alternately (1) fit a GP to
the data under the current pointwise noise estimates, (2) estimate the
pointwise residual variance, (3) fit a second GP to the log-noise surface;
iterate until `stopat` or convergence, writing intermediate files each
round.

Implementation notes:
  * residual variances are estimated from leave-one-out residuals of the
    data GP (closed-form LOO from one factorization, gp.loo_diagnostics),
    the reference's repeated-posterior-draw estimator with the MC noise
    removed;
  * the noise GP is fit to log squared LOO residuals, which are
    log(total LOO variance) + log chi^2_1 noise; two bias corrections make
    the estimator consistent: (a) the chi^2_1 log-moment offset
    E[log chi^2_1] = psi(1/2) + log 2 ~= -1.27036 is added back, and
    (b) the epistemic (latent) share of the LOO variance is subtracted in
    variance space, leaving the pointwise NOISE variance;
  * the data GP is refit in gp4ml mode with `noise_diag` = smoothed noise /
    sigma2 (correlation units), per point.

Both GPs train with the batched multi-restart L-BFGS of `inference.mle_fit`
(imported here by name). The JAX package casts to float64 under its x64
convention, and so does the port: on the card the fits run in fp64, which
takes cuSOLVER, cuBLAS and the plain fp64 build, and no kernel. The
entry points take `device=` (None: the card) and a CPU `generator`
(default `torch.Generator().manual_seed(seed)`), from which the data,
noise and export fits draw their starts in the order of the JAX package's
key splits. The starts differ from `jax.random`'s.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from scipy import special

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.configs import Beliefs, Config
from gp_emu_uqsa_torch.dataio import load_matrix, minmax_scale, save_matrix
from gp_emu_uqsa_torch.inference import MLEConfig, mle_fit


@dataclasses.dataclass
class NoiseFitResult:
    data_params: object          # GPParams of the data GP
    data_state: gp.FitState
    noise_params: object         # GPParams of the noise GP
    noise_state: gp.FitState
    noise_at_train: np.ndarray   # pointwise noise VARIANCE estimates (y units)
    history: list                # per-iteration mean log-noise change
    x: np.ndarray
    y: np.ndarray
    y_log_noise: np.ndarray
    # training inputs of the exported noise GP: the design subset when
    # design_size/olhcmult sized one, else all of x (predict_noise queries
    # noise_state against THESE, not x)
    noise_x: Optional[np.ndarray] = None


def _maximin_subset(x: np.ndarray, k: int) -> np.ndarray:
    """Indices of a k-point farthest-point (maximin) subset of the rows of x.

    The noise-estimation design: a space-filling subset of the TRAINING
    inputs (noise targets only exist at observed points, so a free-standing
    Latin hypercube cannot carry them; farthest-point sampling is the
    maximin design restricted to the observed set). Greedy 2-approximation
    of the maximin design, O(n k), deterministic (starts nearest the
    centroid). NumPy, as in the JAX package.
    """
    n = x.shape[0]
    if k >= n:
        return np.arange(n)
    centroid = x.mean(axis=0)
    first = int(np.argmin(((x - centroid) ** 2).sum(axis=1)))
    chosen = [first]
    min_d2 = ((x - x[first]) ** 2).sum(axis=1)
    for _ in range(k - 1):
        nxt = int(np.argmax(min_d2))
        chosen.append(nxt)
        min_d2 = np.minimum(min_d2, ((x - x[nxt]) ** 2).sum(axis=1))
    return np.asarray(sorted(chosen))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def noisefit_arrays(
    x,
    y,
    *,
    stopat: int = 10,
    tol: float = 1e-3,
    tries: int = 4,
    seed: int = 0,
    message: bool = False,
    design_size: Optional[int] = None,
    iter_callback=None,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> NoiseFitResult:
    """Alternating heteroscedastic fit on arrays (scaled-input space).

    design_size: number of points in the noise-estimation design (the
    reference's `olhcmult` semantics: it sizes the design the noise GP is
    trained on, SURVEY.md S3 noise-fit row). None or >= n uses every
    training point; smaller values train the noise GP on a maximin
    (farthest-point) subset and predict the smoothed noise back onto the
    full set, cutting the noise-GP cost from O(n^3) to O(design_size^3).

    iter_callback: optional `f(iteration, noise_variance_per_point)` hook
    invoked after every alternating step; the file-driven `noisefit` uses
    it to write per-iteration intermediate files.

    device: where the fits run (None: the card), in fp64. generator: the
    CPU generator the L-BFGS starts come from (None: seeded from `seed`).
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y, dtype=np.float64).ravel()
    n, d = x.shape
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    spec = linear_basis(d)
    xj = torch.as_tensor(x, device=dev)
    h = basis_matrix(xj, spec)
    if design_size is not None and design_size < n:
        sub = torch.as_tensor(_maximin_subset(x, int(design_size)),
                              device=dev)
        xj_sub = xj[sub]
        h_sub = basis_matrix(xj_sub, spec)
    else:
        sub = None
        xj_sub, h_sub = xj, h

    # initial homoscedastic noise estimate: residual var of a first GP fit
    data_cfg = MLEConfig(mode="gp4ml", tries=tries, train_nugget=True,
                         nugget_bounds=(1e-8, 10.0))
    noise_cfg = MLEConfig(mode="gp4ml", tries=tries, train_nugget=True,
                          nugget_bounds=(1e-6, 10.0))
    log_r = None  # log noise variance per point
    history = []
    data_params = data_state = noise_params = noise_state = None
    yj = torch.as_tensor(y, device=dev)
    # chi^2_1 log-moment correction: E[log r^2] = log total + psi(1/2) + log 2
    chi2_offset = float(special.digamma(0.5) + np.log(2.0))   # ~ -1.27036

    for it in range(stopat):
        if log_r is None:
            noise_diag = None
        else:
            # per-point noise in correlation units: var_i / sigma2
            sigma2 = float(data_state.sigma2)
            noise_diag = torch.as_tensor(np.exp(log_r) / sigma2, device=dev)
        data_params, _ = mle_fit(generator, xj, yj, h, data_cfg,
                                 noise_diag=noise_diag)
        data_state = gp.fit(data_params, xj, yj, h, mode="gp4ml",
                            noise_diag=noise_diag)
        # LOO residual variance estimates: E[r_i^2] = loo_var_i (TOTAL
        # held-out variance: latent + noise, y units)
        loo_mean, loo_var = gp.loo_diagnostics(data_state, xj, h, yj)
        sq_resid = np.maximum(_np((yj - loo_mean) ** 2), 1e-12)
        z = torch.as_tensor(np.log(sq_resid) - chi2_offset, device=dev)
        # the noise GP smooths log TOTAL variance over x, trained on the
        # noise-estimation design (all points, or the olhcmult-sized
        # maximin subset) and predicted back onto the full training set
        z_sub = z[sub] if sub is not None else z
        noise_params, _ = mle_fit(generator, xj_sub, z_sub, h_sub, noise_cfg)
        noise_state = gp.fit(noise_params, xj_sub, z_sub, h_sub, mode="gp4ml")
        z_mean, z_var = gp.predict(noise_state, xj_sub, h_sub, xj, h)
        est_total = np.exp(_np(z_mean + 0.5 * z_var))   # lognormal corr.
        # subtract the epistemic (latent) share of the LOO variance: what is
        # left is the pointwise noise. Current-model noise in y units:
        sigma2 = float(data_state.sigma2)
        nug = float(torch.exp(data_params.log_nugget))
        cur_noise = sigma2 * (nug + (_np(noise_diag)
                                     if noise_diag is not None else 0.0))
        latent = np.maximum(_np(loo_var) - cur_noise, 0.0)
        new_log_r = np.log(np.maximum(est_total - latent, 1e-12))
        if iter_callback is not None:
            iter_callback(it, np.exp(new_log_r))
        if log_r is not None:
            delta = float(np.mean(np.abs(new_log_r - log_r)))
            history.append(delta)
            if message:
                print(f"[noisefit iter {it}] mean |d log noise| = {delta:.4g}")
            if delta < tol:
                log_r = new_log_r
                break
        log_r = new_log_r

    # export GP over log NOISE (the in-loop noise GP smooths log TOTAL
    # variance); predict_noise() queries this one. Trained on the same
    # noise-estimation design as the in-loop GP, so design_size/olhcmult
    # caps EVERY O(k^3) noise-GP cost, not just the in-loop ones.
    lr = torch.as_tensor(log_r, device=dev)
    lr_sub = lr[sub] if sub is not None else lr
    noise_params, _ = mle_fit(generator, xj_sub, lr_sub, h_sub, noise_cfg)
    noise_state = gp.fit(noise_params, xj_sub, lr_sub, h_sub, mode="gp4ml")

    return NoiseFitResult(
        data_params, data_state, noise_params, noise_state,
        np.exp(log_r), history, x, y, log_r,
        noise_x=(x[_np(sub)] if sub is not None else x),
    )


def predict_noise(result: NoiseFitResult, x_new) -> np.ndarray:
    """Predicted pointwise noise VARIANCE at new (scaled) inputs, computed
    on the device of the fitted noise GP."""
    x_new = np.asarray(x_new, dtype=np.float64)
    if x_new.ndim == 1:
        x_new = x_new[:, None]
    x_train = result.noise_x if result.noise_x is not None else result.x
    dev = result.noise_state.e.device
    spec = linear_basis(x_train.shape[1])
    xj = torch.as_tensor(x_train, device=dev)
    h = basis_matrix(xj, spec)
    xs = torch.as_tensor(x_new, device=dev)
    hs = basis_matrix(xs, spec)
    z_mean, z_var = gp.predict(result.noise_state, xj, h, xs, hs)
    return np.exp(_np(z_mean + 0.5 * z_var))


def noisefit(
    data_conf,
    noise_conf,
    stopat: int = 20,
    olhcmult: int = 100,
    *,
    message: bool = False,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> NoiseFitResult:
    """Reference file-driven entry point.

    Reads the data config (inputs/outputs), runs the alternating fit, and
    writes outputs next to the originals: per-iteration intermediate noise
    estimates (`<outputs>-noise-it<k>`), the final smoothed noise estimates
    (`<outputs>-noise`), and the updated beliefs files for both GPs
    (`<beliefs>-f` of each config).

    `olhcmult` sizes the noise-estimation design as olhcmult * d points
    (reference semantics: "olhcmult sizes the design for noise-estimation
    points"): the per-iteration noise GP is trained on a maximin subset of
    that size (see `_maximin_subset`) when it is smaller than the training
    set, otherwise on all points. device and generator: see
    `noisefit_arrays`.
    """
    dc = Config.from_file(data_conf)
    nc = Config.from_file(noise_conf)
    db = Beliefs.from_file(dc.beliefs)
    x_raw = load_matrix(dc.inputs)
    y_raw = load_matrix(dc.outputs)
    y = y_raw[:, db.output] if y_raw.ndim == 2 and y_raw.shape[1] > 1 else y_raw.ravel()
    x_scaled, minmax = minmax_scale(x_raw if db.active is None else x_raw[:, db.active])

    d_active = x_scaled.shape[1] if x_scaled.ndim == 2 else 1
    out_path = Path(dc.outputs)

    def write_iteration(it, noise_var):
        save_matrix(out_path.with_name(out_path.name + f"-noise-it{it}"),
                    noise_var)

    result = noisefit_arrays(
        x_scaled, y, stopat=stopat, tries=max(dc.tries, 2), message=message,
        design_size=int(olhcmult) * d_active, iter_callback=write_iteration,
        device=device, generator=generator,
    )

    save_matrix(out_path.with_name(out_path.name + "-noise"), result.noise_at_train)
    for conf, params, state in (
        (dc, result.data_params, result.data_state),
        (nc, result.noise_params, result.noise_state),
    ):
        bel = Beliefs.from_file(conf.beliefs)
        bel.delta = [float(v) for v in _np(torch.exp(params.log_delta))]
        bel.sigma = float(np.sqrt(float(state.sigma2)))
        bel.nugget = float(torch.exp(params.log_nugget))
        bel.input_minmax = minmax
        bp = Path(conf.beliefs)
        bel.to_file(bp.with_name(bp.name + "-f"))
    return result
