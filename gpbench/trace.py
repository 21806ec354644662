"""Reduce a torch.profiler trace of the measured window to what the
per-layer metrics read.

`collect` lists every operation that ran on the device (kernels, copies,
fills; not the benchmark's spans mirrored there) as (name, start s, end
s). From them:

  busy_s      the union of their intervals (an operation is counted once
              however many overlap it)
  kernel_s    seconds by name, summed over calls
  idle gaps   the intervals between busy spans, each named by what the
              host was doing at its middle: the innermost host operation
              or benchmark span open then on the thread that drives the
              window
"""
from __future__ import annotations

import bisect
import collections


def _device_type_name(event) -> str:
    return str(event.device_type()).rsplit(".", 1)[-1].upper()


def _annotation_on_device(event) -> bool:
    """A record_function span mirrored on the device's timeline: a label
    over kernels, not an operation."""
    flag = getattr(event, "is_user_annotation", None)
    kind = getattr(event, "activity_type", None)
    return bool(flag and flag()) or "annotation" in str(
        kind() if kind else "").lower()


def collect(prof):
    """(device operations, host events of the driving thread) from a
    finished torch.profiler.profile, each (name, start s, end s), sorted by
    start."""
    device, host = [], []
    host_tids = collections.Counter()
    raw = prof.profiler.kineto_results.events()
    for ev in raw:
        kind = _device_type_name(ev)
        if kind == "CUDA" and _annotation_on_device(ev):
            continue
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        if kind == "CUDA":
            device.append((ev.name(), start, end))
        elif kind == "CPU":
            host.append((ev.name(), start, end, ev.start_thread_id()))
            host_tids[ev.start_thread_id()] += 1
    main = host_tids.most_common(1)[0][0] if host_tids else None
    host = [(n, s, e) for n, s, e, t in host if t == main]
    device.sort(key=lambda v: v[1])
    host.sort(key=lambda v: (v[1], -v[2]))
    return device, host


def busy_intervals(device):
    merged = []
    for _, s, e in device:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def kernel_seconds(device) -> dict:
    out = collections.defaultdict(float)
    for name, s, e in device:
        out[name] += e - s
    return dict(out)


def idle_gaps(merged, host, t0: float, t1: float):
    """[(label, seconds)] of the idle time inside [t0, t1], summed by label."""
    gaps = []
    edge = t0
    for s, e in merged:
        if s > edge:
            gaps.append((edge, min(s, t1)))
        edge = max(edge, e)
        if edge >= t1:
            break
    if edge < t1:
        gaps.append((edge, t1))
    starts = [h[1] for h in host]
    out = collections.defaultdict(float)
    stack = []
    i = 0
    for gs, ge in sorted(gaps):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        j = bisect.bisect_right(starts, mid)
        while i < j:
            name, s, e = host[i]
            while stack and stack[-1][2] <= s:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        out[stack[-1][0] if stack else "(no host span)"] += ge - gs
    return sorted(out.items(), key=lambda kv: -kv[1])


def reduce(prof, span: str) -> dict:
    """The reduced trace of the window: the interval of the host span
    `span` (a record_function around the measured loop)."""
    device, host = collect(prof)
    windows = [(s, e) for n, s, e in host if n == span]
    if not windows:
        raise RuntimeError(f"the trace holds no span {span!r}")
    t0, t1 = windows[0]
    device = [(n, max(s, t0), min(e, t1)) for n, s, e in device
              if e > t0 and s < t1]
    merged = busy_intervals(device)
    busy = sum(e - s for s, e in merged)
    by_name = kernel_seconds(device)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": t1 - t0,
        "busy_s": busy,
        "kernel_s": by_name,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": [[n, s] for n, s in idle_gaps(merged, host, t0, t1)[:10]],
    }


def idle_pct(reduced):
    """The share of the window with no operation on the device, in %."""
    if reduced is None or reduced["busy_s"] <= 0 or reduced["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - reduced["busy_s"] / reduced["window_s"])


def seconds_of(reduced, names) -> float:
    """Device seconds of the kernels whose names hold one of `names`; 0
    without a trace."""
    if reduced is None:
        return 0.0
    return sum(s for kernel, s in reduced["kernel_s"].items()
               if any(n in kernel for n in names))
