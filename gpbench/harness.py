"""The benchmark's harness: find a cell's files by name, run it once, and
reduce the run to the result line.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own under this folder, found by the names that
`BENCHMARK.json` gives:

  configs/<config>.json      the configuration as it is run (the file
                             that its entry names)
  traffic/<traffic>.json     the mix's parameters; its "driver" names
  drivers/<driver>.py        the general generator that builds the
                             system under test, drives the window and
                             compares what it served with the reference
  limits/<workload>.json     the limit of each number the comparison gives
  metrics/<metric>.py        read(run) -> float | None, one metric each

A driver module has setup(ctx) -> state, window(state, ctx) -> record,
layer_timings(state, record, ctx) -> dict (traced runs), release(state,
record, ctx) -> outputs, and check(outputs, ctx, control=False) -> {number:
value}. With control=True, check gives the numbers of the control: the
reference in lower precision in the program's place.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
import types
from pathlib import Path

import torch
import torch.distributed as dist

from gpbench import peaks as peak_table
from gpbench import trace as trace_mod

WINDOW_SPAN = "gpbench.window"
FORBIDDEN = ("jax", "jaxlib", "flax", "gp_emu_uqsa_tpu")


def load_module(path: Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    name = "gpbench_file_" + "_".join(path.with_suffix("").parts[-2:]).replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Benchmark:
    """BENCHMARK.json at `root` and the files it names under `root/gpbench`."""

    def __init__(self, root):
        self.root = Path(root)
        self.home = self.root / "gpbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, workload: str) -> dict:
        return self._entry("workloads", workload)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._entry("configs", name)["file"])
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.home / "limits" / f"{workload}.json").read_text())

    def driver(self, traffic: dict):
        return load_module(self.home / "drivers" / f"{traffic['driver']}.py")

    def metrics_for(self, workload: str, trace: bool) -> list:
        """The cell's end-to-end metrics (trace off) or per-layer ones (on)."""
        e2e = [m for m in self.spec["end_to_end"]
               if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def metric_reader(self, name: str):
        return load_module(self.home / "metrics" / f"{name}.py")


def seed_words(seed: int, stream: int) -> list:
    """Entropy for numpy's SeedSequence: the run's seed and a stream id."""
    return [seed % 2 ** 64, stream]


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, device, reps: int = 5):
    """Median milliseconds of fn() over `reps` calls after one warm-up,
    between CUDA events on the card; None off the card."""
    if device.type != "cuda":
        return None
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(sorted(times)[len(times) // 2])


def card_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in sys.modules}
                  & set(FORBIDDEN))


def make_context(bench: Benchmark, workload: str, seed: int, seconds: float,
                 trace: bool, device) -> types.SimpleNamespace:
    cell = bench.cell(workload)
    traffic = bench.traffic(cell["traffic"])
    world = cell["chips"]
    return types.SimpleNamespace(
        workload=workload, config=bench.config(cell["config"]),
        traffic=traffic, seed=int(seed), seconds=float(seconds),
        trace=bool(trace), device=torch.device(device), world=world,
        rank=dist.get_rank() if world > 1 else 0,
        span=(torch.profiler.record_function if trace
              else lambda name: contextlib.nullcontext()))


@contextlib.contextmanager
def process_group(chips: int, device):
    """The cell's process group: torchrun's (one rank a card, NCCL) when
    the cell takes more than one card and no group exists yet; a group
    that exists already is used as it is and left open."""
    if chips == 1 or dist.is_initialized():
        yield
        return
    device = torch.device(device)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", device_id=device)
    try:
        yield
    finally:
        dist.destroy_process_group()


def over_ranks(value: float, op: str, ctx) -> float:
    """A number of this rank reduced over the cell's ranks: "max" or
    "mean"."""
    if ctx.world == 1:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64,
                     device=ctx.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    return float(t) / (ctx.world if op == "mean" else 1)


def compare(numbers: dict, limits: dict) -> tuple:
    """(all within their limits, {number: {value, limit}}): a number that is
    not finite, or has no limit, fails; so does a limit with no number."""
    checks, ok = {}, set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, math.nan)
        limit = limits.get(name, math.nan)
        ok = ok and math.isfinite(value) and value <= limit
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def run_cell(bench: Benchmark, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float):
    """Run one cell once. Returns (the result line as a dict, the checks'
    lines for standard error); on ranks other than 0 of a cell over several
    cards, (None, [])."""
    with process_group(bench.cell(workload)["chips"], device):
        return _run_cell(bench, workload, seed, seconds, trace, device,
                         t_start)


def _run_cell(bench, workload, seed, seconds, trace, device, t_start):
    ctx = make_context(bench, workload, seed, seconds, trace, device)
    dev = ctx.device
    driver = bench.driver(ctx.traffic)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)   # the allocator, before its peak is reset
        torch.cuda.reset_peak_memory_stats(dev)
    state = driver.setup(ctx)
    synchronize(dev)
    setup_s = over_ranks(time.perf_counter() - t_start, "max", ctx)
    reduced = None
    layer = {}
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                record = driver.window(state, ctx)
        reduced = trace_mod.reduce(prof, WINDOW_SPAN)
        del prof
        reduced["busy_s"] = over_ranks(reduced["busy_s"], "mean", ctx)
        reduced["window_s"] = over_ranks(reduced["window_s"], "mean", ctx)
        layer = driver.layer_timings(state, record, ctx)
    else:
        record = driver.window(state, ctx)
    memory_peak = int(over_ranks(torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0, "max", ctx))
    outputs = driver.release(state, record, ctx)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.rank != 0:
        return None, []
    numbers = driver.check(outputs, ctx)
    ok, checks = compare(numbers, bench.limits(workload))
    correct = ok and record["failed"] == 0
    card = card_name(dev)
    run = types.SimpleNamespace(
        workload=workload, config=ctx.config, traffic=ctx.traffic,
        setup_s=setup_s, record=record, trace=reduced, layer=layer,
        peaks=peak_table.for_card(card), chips=ctx.world)
    metrics = {}
    for entry in bench.metrics_for(workload, trace):
        value = bench.metric_reader(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {
        "correct": bool(correct),
        "attempted": record["attempted"],
        "failed": record["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": card, "count": ctx.world,
                   "memory_peak_bytes": memory_peak},
    }
    if reduced is not None:
        result["device"]["busy_s"] = reduced["busy_s"]
        result["device"]["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    lines = [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
             for name, c in checks.items()]
    lines.append(f"correct: {correct} ({record['failed']} of "
                 f"{record['attempted']} failed)")
    return result, lines
