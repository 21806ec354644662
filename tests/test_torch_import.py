"""The PyTorch port stands alone: no JAX, no reference package, CUDA by default."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gp_emu_uqsa_torch
from gp_emu_uqsa_torch import Emulator, load_emulator, make_params, params_from_numpy, save_emulator
from gp_emu_uqsa_torch.ops import kernel_matrix, serve

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "gp_emu_uqsa_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "gp_emu_uqsa_tpu")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        gp_emu_uqsa_torch.__path__, "gp_emu_uqsa_torch."))


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, sys\n"
        f"for name in ['gp_emu_uqsa_torch'] + {_all_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_import_leaves_matplotlib_out_of_sys_modules():
    """The card's machine has no matplotlib: the plotting functions import
    it when called, never a module at import time."""
    code = (
        "import importlib, sys\n"
        f"for name in ['gp_emu_uqsa_torch'] + {_all_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.startswith('matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_source_scan_finds_no_forbidden_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            hits += [(path.name, n) for n in names
                     if n.split(".")[0] in FORBIDDEN]
    assert hits == []


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(40, 2))
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_params([0.5, 0.5])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(np.zeros(2), 0.0, -9.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Emulator.from_arrays(x, y, tv_config=(4, 0, 1))
    emul = Emulator.from_arrays(x, y, tv_config=(4, 0, 1), device="cpu")
    emul.params = params_from_numpy(np.log([0.5, 0.5]), 0.0, np.log(1e-4),
                                    device="cpu")
    save_emulator(tmp_path / "emu", emul)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_emulator(tmp_path / "emu")
    assert load_emulator(tmp_path / "emu", device="cpu").state is not None


@pytest.mark.parametrize("fn, args", [
    (kernel_matrix.gaussian_corr_self_fused, ("x", "delta", 1e-4)),
    (kernel_matrix.gaussian_corr_fused, ("x", "x", "delta")),
    (serve.corr_matvec, ("x", "x", "delta", "rhs")),
    (serve.corr_quad, ("x", "x", "delta", "w")),
])
def test_wrappers_take_the_plain_version_only_on_the_cpu(fn, args):
    """On the CPU the wrapper runs the plain version and counts no launch;
    a tensor on any other non-CUDA device raises instead of falling back."""
    n, d = 16, 3
    vals = {"x": torch.rand(n, d), "delta": torch.full((d,), 0.7),
            "rhs": torch.rand(n, 2), "w": torch.tril(torch.rand(n, n))}
    before = fn.launches
    out = fn(*[vals.get(a, a) if isinstance(a, str) else a for a in args])
    assert torch.isfinite(out).all() and fn.launches == before
    meta = {k: v.to("meta") for k, v in vals.items()}
    with pytest.raises(ValueError, match="CUDA device"):
        fn(*[meta.get(a, a) if isinstance(a, str) else a for a in args])
    assert fn.launches == before


def test_the_scans_cover_the_multi_device_path():
    """The import and source scans above walk every module of the package,
    the multi-device path's included."""
    names = {m.removeprefix("gp_emu_uqsa_torch.") for m in _all_modules()}
    files = {p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py")}
    for mod in ("parallel", "parallel.runtime", "parallel.mesh",
                "parallel.predict", "parallel.sharded_gp",
                "parallel.large_fit", "parallel.ring",
                "ops.distributed_cholesky", "ops.block_cyclic",
                "tools.multi_gpu_run"):
        assert mod in names
        path = mod.replace(".", "/")
        assert f"{path}.py" in files or f"{path}/__init__.py" in files
