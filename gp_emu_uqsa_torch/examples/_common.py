"""What the example workflows share: their source trees and work
directories, the command line, and timing that waits for the card."""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from pathlib import Path

import torch

# the repo's examples/ beside the package (absent from an installed copy:
# pass src=)
EXAMPLES = Path(__file__).resolve().parents[2] / "examples"


def work_tree(name: str, workdir=None, src=None) -> Path:
    """A copy of the example tree `src` (default: examples/<name>) at
    workdir/<name>, where the workflow runs and writes; workdir None is a
    new temporary directory, which is kept."""
    src = EXAMPLES / name if src is None else Path(src)
    if not src.is_dir():
        raise FileNotFoundError(f"no example tree at {src}: pass src=")
    root = (Path(tempfile.mkdtemp(prefix=f"{name}-")) if workdir is None
            else Path(workdir))
    dst = root / name
    shutil.copytree(src, dst, dirs_exist_ok=True)
    return dst


def seconds_since(t0: float, device) -> float:
    """Host seconds since t0 (time.perf_counter) once `device` is idle."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def parser(doc: str) -> argparse.ArgumentParser:
    """A command line with the options every example takes."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: the CUDA card)")
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"),
                    help="the working dtype (default: the script's)")
    ap.add_argument("--workdir", default=None,
                    help="where a file-driven workflow copies its tree and "
                         "writes (default: a new temporary directory)")
    return ap


def common_kwargs(args) -> dict:
    """device, dtype and workdir from `parser`'s arguments (the dtype only
    where given, so that each main keeps its own default)."""
    out = {"device": args.device, "workdir": args.workdir}
    if args.dtype is not None:
        out["dtype"] = getattr(torch, args.dtype)
    return out
