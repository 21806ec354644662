"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source in `csrc/` becomes a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <name>.so csrc/<name>.cu

The libraries go into `gp_emu_uqsa_torch/_build/<hash>/`, keyed by a hash
of the sources and flags, and are built at first use: one nvcc process per
source, all started together. Nothing is imported or compiled when this
module is imported. A failed build raises; there is no fallback.

Every C entry point takes its pointers and the CUDA stream as `void*` and
returns `cudaGetLastError()` right after its launch; `check` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("corr_build.cu", "corr_matvec.cu", "corr_quad.cu")
_HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# nvcc's output (ptxas register and shared-memory report) per source,
# filled by the build that produced the libraries in this process
build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every source whose library is missing; returns all paths."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    targets = {s: out_dir / (Path(s).stem + ".so") for s in SOURCES}
    todo = {s: t for s, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    procs = {}
    for src, target in todo.items():
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    failed = []
    for src, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_log[src] = log
        if proc.returncode == 0:
            os.replace(tmp, targets[src])
        else:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


def entry(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of a loaded library, returning int."""
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def kernel(source: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of `source`'s library, built if needed;
    fetched once per process."""
    fn = _entries.get((source, symbol))
    if fn is None:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(build()[source]))
        fn = _entries[(source, symbol)] = entry(_libs[source], symbol, argtypes)
    return fn


def check(err: int, source: str, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        lib = _libs[source]
        lib.gp_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gp_cuda_error_string.restype = ctypes.c_char_p
        msg = lib.gp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on `t`'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream
