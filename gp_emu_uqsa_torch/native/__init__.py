"""The C text-matrix loader (`fastload.c`), built with `cc` at first use.

`np.loadtxt` tokenizes in Python and takes tens of seconds on the 1M-row
prediction designs of BASELINE config 5; the C parser does one strtod pass
over an in-memory buffer with loadtxt's semantics. It is a host file
parser, not a device kernel.

The library is built into `gp_emu_uqsa_torch/_build/` (ignored by git),
keyed by a hash of the source, the first time a matrix is read; nothing is
compiled when this module is imported. Without a C compiler
`load_matrix_native` returns None and `dataio.load_matrix` reads the file
with `np.loadtxt`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastload.c"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"

_lib = None
_lib_failed = False

_ERRORS = {
    -1: "cannot open or read file",
    -2: "inconsistent number of columns",
    -3: "non-numeric token",
    -4: "out of memory",
}


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_ROOT / f"fastload-{digest}.so"


def _compile(target: Path) -> Optional[Path]:
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    # build into a temporary file, then rename: test workers may race
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(target.parent))
    os.close(fd)
    try:
        subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return target
    except (subprocess.SubprocessError, OSError):
        Path(tmp).unlink(missing_ok=True)
        return None


def _get_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    so = _library_path()
    if not so.exists():
        so = _compile(so)
    try:
        lib = ctypes.CDLL(str(so)) if so is not None else None
    except OSError:
        lib = None
    if lib is None:
        _lib_failed = True
        return None
    lib.fastload.restype = ctypes.c_longlong
    lib.fastload.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.fastload_free.restype = None
    lib.fastload_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the C loader built and loaded on this host."""
    return _get_lib() is not None


def load_matrix_native(path) -> Optional[np.ndarray]:
    """Parse a whitespace-separated numeric matrix with the C loader.

    Returns a (rows, cols) float64 array, or None when the library is not
    available (the caller falls back to np.loadtxt). Raises
    FileNotFoundError or ValueError on unreadable or malformed files, as
    np.loadtxt does.
    """
    lib = _get_lib()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_longlong()
    cols = ctypes.c_longlong()
    rc = lib.fastload(str(path).encode(), ctypes.byref(data),
                      ctypes.byref(rows), ctypes.byref(cols))
    if rc == -1:
        raise FileNotFoundError(f"{path}: {_ERRORS[-1]}")
    if rc != 0:
        raise ValueError(f"{path}: {_ERRORS.get(int(rc), f'error {rc}')}")
    try:
        if rows.value * cols.value == 0:
            return np.empty((rows.value, max(cols.value, 0)), np.float64)
        # copy out of the C allocation so numpy owns its memory
        return np.ctypeslib.as_array(data, shape=(rows.value, cols.value)).copy()
    finally:
        if data:
            lib.fastload_free(data)
