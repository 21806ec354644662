"""Structured logging and profiling helpers (port of
`gp_emu_uqsa_tpu.utils.logging`).

Every stage can emit structured JSONL events (timings, NLLs, diagnostics,
throughput) with the JAX package's keys, and wrap hot regions in a
`torch.profiler` trace that TensorBoard and chrome://tracing read.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Optional

import torch

_LOG_PATH: Optional[Path] = None


def set_log_path(path) -> None:
    """Enable JSONL event logging to `path` (None disables)."""
    global _LOG_PATH
    _LOG_PATH = Path(path) if path else None


def log_event(event: str, **fields) -> None:
    """Append one structured event; silently a no-op when disabled."""
    if _LOG_PATH is None:
        return
    rec = {"event": event, "time": time.time(), **fields}
    with _LOG_PATH.open("a") as f:
        f.write(json.dumps(rec) + "\n")


def _sync_card() -> None:
    # the card's queued work belongs to whichever side of the block it was
    # queued on; without a card, or before CUDA is used, there is none
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(event: str, **fields):
    """Context manager: logs the wall-clock seconds of the block as `event`,
    with the card synchronized at both ends when it is in use."""
    _sync_card()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync_card()
        log_event(event, seconds=time.perf_counter() - t0, **fields)


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """torch.profiler trace of the block written into `logdir` (the CPU,
    and the card when there is one); no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield
