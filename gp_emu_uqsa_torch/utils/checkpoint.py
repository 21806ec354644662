"""Checkpoints of emulators and of HMC/NUTS chain state (port of
`gp_emu_uqsa_tpu.utils.checkpoint`).

Format, shared with the JAX package: a `.npz` of arrays plus a `.json`
sidecar of metadata. An emulator checkpoint written by either package
loads in the other; loading refits the posterior state at the stored
hyperparameters, as the JAX loader does. A chain checkpoint holds the
positions z, the step size, the inverse mass and the random state: the
port stores `torch.Generator.get_state()` (uint8) under "key" and the
generator's device in the metadata, so a segment rerun from it
(`inference.hmc.mcmc_continue`) gives the same draws bit for bit.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from gp_emu_uqsa_torch._device import resolve_device
from gp_emu_uqsa_torch.kernels import params_from_numpy


def save_emulator(path, emul, *, extra: dict | None = None) -> None:
    """Checkpoint an Emulator's trained state + data provenance."""
    path = Path(path)
    arrays = {
        "x_all": np.asarray(emul.splits.x_all),
        "y_all": np.asarray(emul.splits.y_all),
        "order": np.asarray(emul.splits.order),
    }
    if emul.params is not None:
        arrays["log_delta"] = emul.params.log_delta.detach().cpu().numpy()
        arrays["log_sigma2"] = emul.params.log_sigma2.detach().cpu().numpy()
        arrays["log_nugget"] = emul.params.log_nugget.detach().cpu().numpy()
    meta = {
        "tv_config": list(emul.splits.tv_config),
        "v_ranges": [list(r) for r in emul.splits.v_ranges],
        "minmax": emul.splits.minmax,
        "n_folded": emul.n_folded,
        "mode": emul.mle_config.mode,
        "family": emul.mle_config.family,
        "nugget": emul.mle_config.nugget,
        "train_nugget": emul.mle_config.train_nugget,
        "include_const": emul.spec.include_const,
        "linear_dims": list(emul.spec.linear_dims),
        "power_terms": [list(t) for t in emul.spec.power_terms],
        "active": emul.active,
        "extra": extra or {},
    }
    np.savez(path.with_suffix(".npz"), **arrays)
    path.with_suffix(".json").write_text(json.dumps(meta, indent=1))


def load_emulator(path, *, device=None, dtype=torch.float64):
    """Restore an Emulator checkpoint and refit its posterior state.

    `device=None` means the CUDA card (raises without one); `dtype` is the
    emulator's working dtype. The refit is `gp.fit` at the stored
    hyperparameters: the training build (kernel K1 for fp32 on a card),
    the Cholesky and its jitter ladder.
    """
    from gp_emu_uqsa_torch import gp
    from gp_emu_uqsa_torch.basis import BasisSpec
    from gp_emu_uqsa_torch.dataio import DataSplits
    from gp_emu_uqsa_torch.emulator import Emulator
    from gp_emu_uqsa_torch.inference import MLEConfig

    path = Path(path)
    meta = json.loads(path.with_suffix(".json").read_text())
    with np.load(path.with_suffix(".npz")) as npz:
        arrays = dict(npz)
    splits = DataSplits(
        arrays["x_all"], arrays["y_all"], arrays["order"],
        meta["minmax"], tuple(meta["tv_config"]),
        [tuple(r) for r in meta["v_ranges"]],
    )
    spec = BasisSpec(
        meta["include_const"], tuple(meta["linear_dims"]),
        tuple(tuple(t) for t in meta.get("power_terms", [])),
    )
    family = meta.get("family", "gaussian")
    emul = Emulator(
        splits, spec, meta["active"],
        MLEConfig(
            mode=meta["mode"], family=family,
            nugget=meta.get("nugget", 1e-8),
            train_nugget=meta.get("train_nugget", False),
        ),
        n_folded=meta["n_folded"], dtype=dtype, device=device,
    )
    if "log_delta" in arrays:
        emul.params = params_from_numpy(
            arrays["log_delta"], arrays["log_sigma2"], arrays["log_nugget"],
            device=emul.device, dtype=dtype)
        x, y, h = emul.train_view()
        emul.state = gp.fit(emul.params, x, y, h, mode=meta["mode"],
                            family=family)
    return emul


_GENERATOR_DEVICE = "generator_device"


def save_hmc_state(path, z, step_size, inv_mass, generator, *,
                   meta=None) -> None:
    """Checkpoint chain state for preemption-safe resume: z (chains, dim),
    the step size, the inverse mass and `generator`'s state."""
    path = Path(path)
    host = lambda t: torch.as_tensor(t).detach().cpu().numpy()
    np.savez(
        path.with_suffix(".npz"),
        z=host(z),
        step_size=host(step_size),
        inv_mass=host(inv_mass),
        key=generator.get_state().numpy(),
    )
    meta = dict(meta or {})
    meta[_GENERATOR_DEVICE] = str(generator.device)
    path.with_suffix(".json").write_text(json.dumps(meta))


def load_hmc_state(path, *, device=None):
    """(z, step_size, inv_mass, generator, meta) from `save_hmc_state`.

    The tensors come back on `device` (None means the CUDA card) in their
    saved dtype, the generator on its saved device with its saved state.
    A file written by the JAX package's save_hmc_state loads z, step_size,
    inv_mass and meta; its threefry key cannot seed a torch.Generator, so
    the generator comes back as None.
    """
    path = Path(path)
    dev = resolve_device(device)
    with np.load(path.with_suffix(".npz")) as npz:
        arrays = dict(npz)
    meta = json.loads(path.with_suffix(".json").read_text())
    gen_device = meta.pop(_GENERATOR_DEVICE, None)
    generator = None
    if gen_device is not None and arrays["key"].dtype == np.uint8:
        generator = torch.Generator(device=gen_device)
        generator.set_state(torch.from_numpy(arrays["key"]))
    out = [torch.as_tensor(arrays[k], device=dev)
           for k in ("z", "step_size", "inv_mass")]
    return (*out, generator, meta)
