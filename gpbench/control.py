"""Read the numbers that decide `correct` for the program and for its
control on the card, seed by seed, at the cell's own size.

    python3 -m gpbench.control --workload <cell> --seeds 1 2 3 [--seconds 3]

For each seed: the cell's set-up and a window of `seconds`, then the
cell's numbers for what the program served and for the control, the
reference in the program's place in the nearest lower precision (float32
with TF32 products). One JSON line a seed. A cell over several cards runs
under torchrun, as `gpbench.run` does; rank 0 prints. The benchmark's own runs never
run the control; the limits in limits/<cell>.json are set from these
readings (PERF.md gives them).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

from gpbench import harness
from gpbench.run import ROOT, under_torchrun


def read_seed(bench, workload: str, seed: int, seconds: float, device):
    ctx = harness.make_context(bench, workload, seed, seconds, False, device)
    driver = bench.driver(ctx.traffic)
    state = driver.setup(ctx)
    record = driver.window(state, ctx)
    outputs = driver.release(state, record, ctx)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if ctx.rank != 0:
        return None
    program = driver.check(outputs, ctx)
    control = driver.check(outputs, ctx, control=True)
    return {"seed": seed, "attempted": record["attempted"],
            "failed": record["failed"], "program": program, "control": control}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench = harness.Benchmark(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("the control is read on the cards: not enough CUDA cards here",
              file=sys.stderr)
        return 2
    if chips > 1 and "LOCAL_RANK" not in os.environ:
        return under_torchrun("gpbench.control", argv, chips)
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    with harness.process_group(chips, device):
        for seed in args.seeds:
            line = read_seed(bench, args.workload, seed, args.seconds, device)
            if line is not None:
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
