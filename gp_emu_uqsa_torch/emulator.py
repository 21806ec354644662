"""Emulator facade: setup / train / final_build and serving (port of
`gp_emu_uqsa_tpu.emulator`).

    emul = setup("toy-sim_config", device="cuda", dtype=torch.float32)
    train(emul)                  # optimize -> validate -> fold -> final_build
    mean, var = emul.predict(x_new)

or, without files, `Emulator.from_arrays(x, y, ...).train_full()`; a
trained emulator also loads from a checkpoint (`utils.checkpoint`).

`train` reproduces the reference workflow: multi-restart MLE on the T set
(`optimize`, `inference.mle_fit`), validation against each V set, fold the
V set into T and retrain, then `final_build` on all data, which writes the
updated beliefs and the reordered inputs/outputs ("-f" suffix) beside the
files it read. The Bayesian half samples the hyperparameters instead:
`train_bayes` (MLE for the centre, then NUTS or HMC chains on the device,
`inference.nuts` / `inference.hmc`) and `predict_bayes` (the predictive
marginalized over the draws, `inference.hmc.predict_marginalized`).

Serving tiers (`predict(serve=...)`), named after what they run:

  "fused"  the hand-written CUDA kernels K3 + K4 (`ops.serve`); JAX's
           "pallas". On the CPU it runs their plain versions: the port's
           counterpart of interpret mode and its CPU equivalence hook.
  "gemm"   the cached Predictor through K2 and plain products
           (`gp.predict_batched`); JAX's "xla".
  "auto"   "fused" on a CUDA device for fp32 emulators with m >= 1024,
           else "gemm".
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.basis import (
    BasisSpec, basis_matrix, basis_strings, linear_basis, parse_basis_strings,
)
from gp_emu_uqsa_torch.configs import Beliefs, Config
from gp_emu_uqsa_torch.dataio import (
    DataSplits, load_matrix, make_splits, save_matrix,
)
from gp_emu_uqsa_torch.inference import MLEConfig, mle_fit
from gp_emu_uqsa_torch.kernels import GPParams
from gp_emu_uqsa_torch.ops.kernel_matrix import MAX_D
from gp_emu_uqsa_torch.ops.serve import serve_meanvar_batched

_MIN_NUGGET = 1e-10
_FUSED_AUTO_MIN_M = 1024   # smaller query batches stay on the gemm tier
_FUSED_BATCH = 131072      # query chunk of the fused tier
SERVE_TIERS = ("auto", "fused", "gemm")


def _bounds_pair(bounds_list, d):
    """Reference per-dim [(lo,hi),...] bounds -> (lo_vec, hi_vec) arrays."""
    if bounds_list is None:
        return None
    arr = np.asarray(bounds_list, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[None, :]
    if len(arr) == 1:
        arr = np.repeat(arr, d, axis=0)
    return arr[:, 0], arr[:, 1]


@dataclasses.dataclass
class Emulator:
    """A (possibly trained) GP emulator plus its provenance.

    `device=None` means the CUDA card (raises without one); pass
    device="cpu" for the plain PyTorch path. `dtype` is the working dtype
    (float64 by default, as in the JAX package); float32 on a CUDA device
    is the configuration that takes the kernels.
    """

    splits: DataSplits
    spec: BasisSpec
    active: Optional[list[int]]            # active input columns (None = all)
    mle_config: MLEConfig
    beliefs: Optional[Beliefs] = None
    config: Optional[Config] = None
    params: Optional[GPParams] = None
    state: Optional[gp.FitState] = None
    n_folded: int = 0                      # V sets folded into training so far
    fixed_beta: Optional[np.ndarray] = None  # set when beliefs.fix_mean
    dtype: torch.dtype = torch.float64
    seed: int = 0
    device: Optional[torch.device] = None
    # hyperparameter draws of train_bayes: (chains, n_samples, p) log space
    hyper_samples: Optional[torch.Tensor] = None
    # serving cache: (FitState, Predictor), rebuilt when the state changes
    _serve_cache: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)
    # training-view cache: key -> (x, y, h) on the device
    _tv_cache: Optional[tuple] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ----- construction ---------------------------------------------------

    @classmethod
    def from_arrays(
        cls,
        x,
        y,
        *,
        basis: Optional[BasisSpec] = None,
        tv_config=(10, 0, 2),
        shuffle=True,
        scale_inputs=True,
        mode="mucm",
        kernel="gaussian",
        tries=8,
        nugget=_MIN_NUGGET,
        train_nugget=False,
        delta_bounds=None,
        sigma_bounds=None,
        nugget_bounds=None,
        dtype=torch.float64,
        device=None,
        seed=0,
    ) -> "Emulator":
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        d = x.shape[1]
        splits = make_splits(
            x, y, tv_config, shuffle=shuffle, scale_inputs=scale_inputs, seed=seed
        )
        spec = basis if basis is not None else linear_basis(d)
        mle = MLEConfig(
            mode=mode,
            family=kernel,
            tries=tries,
            nugget=max(nugget, _MIN_NUGGET),
            train_nugget=train_nugget,
            delta_bounds=delta_bounds,
            sigma_bounds=sigma_bounds,
            nugget_bounds=nugget_bounds,
        )
        return cls(splits, spec, None, mle, dtype=dtype, seed=seed,
                   device=device)

    # ----- data views -----------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _xy(self, rows):
        x = self._tensor(self.splits.x_all[rows])
        y = np.asarray(self.splits.y_all[rows])
        if self.fixed_beta is not None:
            hfull = basis_matrix(torch.as_tensor(self.splits.x_all[rows]),
                                 self.spec).numpy()
            y = y - hfull @ self.fixed_beta
            h = torch.zeros((len(y), 0), dtype=self.dtype, device=self.device)
        else:
            h = basis_matrix(x, self.spec)
        return x, self._tensor(y), h

    def train_view(self):
        """(x, y, h) of the training rows, cached on the device."""
        key = (self.n_folded, self.splits, self.fixed_beta, self.spec,
               self.dtype, self.device)
        cached = self._tv_cache
        if cached is None or not (
            cached[0][0] == key[0] and cached[0][1] is key[1]
            and cached[0][2] is key[2] and cached[0][3] == key[3]
            and cached[0][4] == key[4] and cached[0][5] == key[5]
        ):
            self._tv_cache = (key,
                              self._xy(self.splits.train_rows(self.n_folded)))
        return self._tv_cache[1]

    def valid_view(self, k):
        return self._xy(self.splits.v_rows(k))

    # ----- fitting --------------------------------------------------------

    def optimize(self, generator: Optional[torch.Generator] = None,
                 message=False):
        """Multi-restart MLE on the current training set, then `gp.fit`.

        The LHC starts come from `generator`, by default a CPU
        torch.Generator seeded with seed + n_folded (the JAX package seeds
        its key the same way; the draws differ). Returns mle_fit's info.
        """
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed + self.n_folded)
        x, y, h = self.train_view()
        self.params, info = mle_fit(generator, x, y, h, self.mle_config)
        self.state = gp.fit(self.params, x, y, h, mode=self.mle_config.mode,
                            family=self.mle_config.family)
        if message:
            nlls = info["nlls"].cpu().numpy()
            print(
                f"[optimize] n={len(y)} restarts={self.mle_config.tries} "
                f"best NLL={float(info['best_nll']):.6g} "
                f"(finite restarts: {np.isfinite(nlls).sum()}/{len(nlls)}) "
                f"delta={torch.exp(self.params.log_delta).cpu().numpy()}"
            )
        return info

    def train_full(self, message: bool = False) -> "Emulator":
        """Idiomatic one-call training on all data (== final_build)."""
        return final_build(self, message=message)

    # ----- validation -----------------------------------------------------

    def validate_against(self, k, message=True):
        """Reference V-set diagnostics for validation set k."""
        x, y, h = self.train_view()
        xv, yv, hv = self.valid_view(k)
        diag = gp.validate(self.state, x, h, xv, hv, yv,
                           family=self.mle_config.family)
        if message:
            se = diag["std_err"].cpu().numpy()
            print(
                f"[validate set {k}] n_V={len(yv)} "
                f"|std err|>2: {(np.abs(se) > 2).sum()}/{len(se)}  "
                f"Mahalanobis={float(diag['mahalanobis']):.4g} "
                f"(expect {float(diag['mahalanobis_mean']):.4g} "
                f"+- {float(diag['mahalanobis_sd']):.4g})"
            )
        return diag

    # ----- prediction -----------------------------------------------------

    def _prepare_inputs(self, x_new):
        """Raw-space inputs -> scaled active-dim tensor + basis matrix.

        Cast to the working dtype first: an integer query array would
        otherwise truncate the min-max scaling.
        """
        x_new = self._tensor(x_new)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        if self.active is not None:
            x_new = x_new[:, list(self.active)]
        if self.splits.minmax is not None:
            mm = np.asarray(self.splits.minmax, dtype=np.float64)
            lo = self._tensor(mm[:, 0])
            span = self._tensor(np.where(mm[:, 1] > mm[:, 0],
                                         mm[:, 1] - mm[:, 0], 1.0))
            x_new = (x_new - lo) / span
        if self.fixed_beta is not None:
            hs = torch.zeros((len(x_new), 0), dtype=self.dtype,
                             device=self.device)
        else:
            hs = basis_matrix(x_new, self.spec)
        return x_new, hs

    def _serving(self) -> gp.Predictor:
        """The serving Predictor (W = L^-1), built once per fit state."""
        if self._serve_cache is None or self._serve_cache[0] is not self.state:
            self._serve_cache = (self.state, gp.predictor(self.state))
        return self._serve_cache[1]

    def _use_fused_serve(self, serve: str, m: int, d: int) -> bool:
        """Dispatch gate for the fused K3 + K4 tier (JAX `_use_pallas_serve`).

        Needs the gaussian family and d <= 20. "fused" forces it (plain
        versions on the CPU); "auto" takes it on a CUDA device for fp32
        emulators with m >= 1024 (an fp64 emulator stays on the exact fp64
        gemm tier, which the card runs natively).
        """
        if serve not in SERVE_TIERS:
            raise ValueError(f"unknown serve tier {serve!r}; one of {SERVE_TIERS}")
        if serve == "gemm" or self.mle_config.family != "gaussian":
            return False
        if d > MAX_D:
            return False
        if serve == "fused":
            return True
        return (self.device.type == "cuda" and self.dtype == torch.float32
                and m >= _FUSED_AUTO_MIN_M)

    def predict(self, x_new, *, full_cov=False, include_nugget=False,
                serve: str = "auto", quad_precision: str = "high"):
        """Posterior mean and variance at raw-space inputs x_new.

        The diagonal-variance path takes the fused tier (K3 + K4) or the
        gemm tier as `_use_fused_serve` decides; full_cov=True takes the
        exact factor-based path (`gp.predict`), the only one that builds the
        (m, m) covariance. quad_precision names the fused tier's K4 body on
        the card: "high" (default) is 3xTF32 on the tensor cores, within
        4.7e-5 absolute on the quadratic; "highest" is exact fp32. On the
        CPU both run the fp32 plain version.
        """
        if self.state is None:
            raise RuntimeError("emulator not trained: load a checkpoint or "
                               "fit a state first")
        x, y, h = self.train_view()
        xs, hs = self._prepare_inputs(x_new)
        m, d = xs.shape
        if full_cov:
            mean, var = gp.predict(
                self.state, x, h, xs, hs, full_cov=True,
                include_nugget=include_nugget, family=self.mle_config.family,
            )
        elif self._use_fused_serve(serve, m, d):
            mean, var = serve_meanvar_batched(
                self._serving(), x, xs, hs, batch=_FUSED_BATCH,
                quad_precision=quad_precision, include_nugget=include_nugget,
            )
            mean = mean.to(self.dtype)
            var = var.to(self.dtype)
        else:
            mean, var = gp.predict_batched(
                self._serving(), x, xs, hs, include_nugget=include_nugget,
                family=self.mle_config.family)
        if self.fixed_beta is not None:
            hraw = basis_matrix(xs, self.spec)
            mean = mean + hraw @ self._tensor(self.fixed_beta)
        return mean, var

    def train_bayes(
        self,
        *,
        sampler: str = "nuts",
        n_chains: int = 8,
        n_warmup: int = 500,
        n_samples: int = 500,
        max_depth: int = 8,
        generator: Optional[torch.Generator] = None,
        group=None,
    ):
        """Full-Bayes hyperparameter inference on all data.

        Runs MLE first when there are no params (for initialization), then
        NUTS or HMC chains started 0.1 (in log space) around the MLE
        centre. Stores the draws (chains, n_samples, p) in
        self.hyper_samples; predict_bayes() marginalizes. Returns the
        sampler stats dict.

        `generator` defaults to a torch.Generator on the emulator's device
        seeded with seed + 1000 (the JAX package seeds its key the same
        way; the draws differ). sampler="nuts" is the JAX package's
        measured default (docs/samplers.md).

        `group` (a process group, or a (DeviceMesh, axis name) pair) runs
        n_chains on each rank with the adaptation shared over the ranks
        and each rank's draws from its own generator (`inference.hmc`);
        self.hyper_samples then holds this rank's chains.
        """
        from gp_emu_uqsa_torch.inference.hmc import (
            HMCConfig, hmc_sample, make_gp_logdensity,
        )
        from gp_emu_uqsa_torch.inference.nuts import nuts_sample

        if sampler not in ("nuts", "hmc"):
            raise ValueError(f"unknown sampler {sampler!r}; 'nuts' or 'hmc'")
        self.n_folded = self.splits.n_v_sets
        if self.params is None:
            self.optimize()
        x, y, h = self.train_view()
        logdensity = make_gp_logdensity(x, y, h, self.mle_config)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed + 1000)
        # start chains jittered around the MLE, in the order of the
        # sampled vector: log delta, then log sigma2 (gp4ml), log nugget
        d = x.shape[1]
        parts = [self.params.log_delta.reshape(d)]
        if self.mle_config.mode == "gp4ml":
            parts.append(self.params.log_sigma2.reshape(1))
        if self.mle_config.train_nugget:
            parts.append(self.params.log_nugget.reshape(1))
        center = torch.cat(parts).to(self.dtype)
        z0 = center + 0.1 * torch.randn((n_chains, center.shape[0]),
                                        generator=generator, dtype=self.dtype,
                                        device=self.device)
        cfg = HMCConfig(n_warmup=n_warmup, n_samples=n_samples)
        if sampler == "nuts":
            samples, stats = nuts_sample(generator, logdensity, z0, cfg,
                                         max_depth=max_depth, group=group)
        else:
            samples, stats = hmc_sample(generator, logdensity, z0, cfg,
                                        group=group)
        self.hyper_samples = samples
        return stats

    def predict_bayes(self, x_new, *, max_draws: int = 32):
        """Posterior-predictive mean/var marginalized over train_bayes draws."""
        from gp_emu_uqsa_torch.inference.hmc import predict_marginalized

        if self.hyper_samples is None:
            raise RuntimeError("call train_bayes() first")
        x, y, h = self.train_view()
        xs, hs = self._prepare_inputs(x_new)
        mean, var = predict_marginalized(
            self.hyper_samples, x, y, h, xs, hs, self.mle_config,
            max_draws=max_draws,
        )
        if self.fixed_beta is not None:
            hraw = basis_matrix(xs, self.spec)
            mean = mean + hraw @ self._tensor(self.fixed_beta)
        return mean, var

    # ----- checkpoint export ----------------------------------------------

    def updated_beliefs(self) -> Beliefs:
        """Beliefs object carrying the trained hyperparameters."""
        b = self.beliefs if self.beliefs is not None else Beliefs()
        out = dataclasses.replace(b) if dataclasses.is_dataclass(b) else Beliefs()
        if self.params is not None:
            out.delta = [float(v) for v in
                         torch.exp(self.params.log_delta).cpu().numpy()]
            out.nugget = float(torch.exp(self.params.log_nugget))
            if self.state is not None:
                out.sigma = float(np.sqrt(float(self.state.sigma2)))
                if self.fixed_beta is None:
                    out.beta = [float(v) for v in self.state.beta.cpu().numpy()]
        out.mucm = self.mle_config.mode == "mucm"
        out.fix_nugget = not self.mle_config.train_nugget
        out.input_minmax = self.splits.minmax
        out.basis_str, out.basis_inf = basis_strings(self.spec)
        out.kernel = f"{self.mle_config.family}()"
        return out


def setup(
    config_file,
    datashuffle: bool = True,
    scaleinputs: bool = True,
    *,
    dtype=torch.float64,
    device=None,
    seed: int = 0,
) -> Emulator:
    """Build an Emulator from a reference-format config file.

    Mirrors `g.setup(config_file, datashuffle=..., scaleinputs=...)`.
    `device=None` means the CUDA card (raises without one); dtype
    float32 on the card is the configuration that takes the kernels.
    """
    cfg = Config.from_file(config_file)
    bel = Beliefs.from_file(cfg.beliefs)
    x_raw = load_matrix(cfg.inputs)
    y_raw = load_matrix(cfg.outputs)
    y = (y_raw[:, bel.output] if y_raw.ndim == 2 and y_raw.shape[1] > 1
         else y_raw.ravel())
    active = bel.active
    x = x_raw if active is None else x_raw[:, active]
    d = x.shape[1]

    spec = parse_basis_strings(bel.basis_str, bel.basis_inf)
    if (not spec.linear_dims and bel.basis_str == ["1.0"]
            and len(bel.beta) == d + 1):
        # beliefs wrote only the default; fall back to the reference's
        # default basis
        spec = linear_basis(d)

    splits = make_splits(x, y, cfg.tv_config, shuffle=datashuffle,
                         scale_inputs=scaleinputs, minmax=bel.input_minmax,
                         seed=seed)
    mle = MLEConfig(
        mode="mucm" if bel.mucm else "gp4ml",
        family=bel.kernel_family(),
        tries=cfg.tries,
        nugget=max(bel.nugget, _MIN_NUGGET),
        train_nugget=not bel.fix_nugget,
        delta_bounds=_bounds_pair(cfg.delta_bounds, d),
        sigma_bounds=_bounds_pair(cfg.sigma_bounds, 1),
        nugget_bounds=_bounds_pair(cfg.nugget_bounds, 1),
        constraints="none" if cfg.constraints == "none" else "bounds",
    )
    emul = Emulator(splits, spec, active, mle, beliefs=bel, config=cfg,
                    dtype=dtype, seed=seed, device=device)
    if bel.fix_mean:
        emul.fixed_beta = np.asarray(bel.beta, dtype=np.float64)
    return emul


def train(emul: Emulator, auto: bool = True, message: bool = False) -> Emulator:
    """Reference training workflow: optimize -> validate -> fold -> retrain.

    Mirrors `g.train(emul, auto=True, message=False)`: with auto=False the
    fold-in step asks interactively, as the reference does. Ends with
    `final_build` on all data and the beliefs/inputs/outputs write-back.
    """
    n_v = emul.splits.n_v_sets
    emul.optimize(message=message)
    for k in range(n_v):
        emul.validate_against(k, message=True)
        if not auto:
            ans = input(f"include validation set {k} into training and "
                        "retrain? [y/n] ")
            if not ans.strip().lower().startswith("y"):
                break
        emul.n_folded = k + 1
        if emul.n_folded < n_v:   # the last fold is re-optimized by final_build
            emul.optimize(message=message)
    return final_build(emul, message=message)


def final_build(emul: Emulator, message: bool = False) -> Emulator:
    """Train on ALL data and write updated beliefs + reordered data files."""
    emul.n_folded = emul.splits.n_v_sets
    emul.optimize(message=message)
    if emul.config is not None:
        suffix = "-f"
        bel_path = Path(emul.beliefs.path or emul.config.beliefs)
        out_bel = bel_path.with_name(bel_path.name + suffix)
        emul.updated_beliefs().to_file(out_bel)
        x_raw = load_matrix(emul.config.inputs)[emul.splits.order]
        y_raw = load_matrix(emul.config.outputs)[emul.splits.order]
        ip = Path(emul.config.inputs)
        op = Path(emul.config.outputs)
        save_matrix(ip.with_name(ip.name + suffix), x_raw)
        save_matrix(op.with_name(op.name + suffix), y_raw)
        if message:
            print(f"[final_build] wrote {out_bel}, {ip.name}{suffix}, "
                  f"{op.name}{suffix}")
    return emul
