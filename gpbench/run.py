"""Run one cell of BENCHMARK.json once on this machine's cards.

    python3 -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error. Without the cards
the cell asks for it prints no result and exits with 2; if the process
holds JAX or the JAX package once the window has closed, with 3. A cell
over several cards starts itself again under torchrun, one rank a card;
rank 0 prints the result, its set-up counted from this process's start.
"""
import time

T_START = time.perf_counter()
T_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
START_ENV = "GPBENCH_START_TIME"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def under_torchrun(module: str, argv, chips: int) -> int:
    """`python -m module argv` again, one rank a card, under torchrun on
    this host."""
    env = dict(os.environ, **{START_ENV: repr(T_WALL)})
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={chips}", "-m", module, *argv]
    return subprocess.run(cmd, env=env, cwd=ROOT).returncode


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    import torch

    from gpbench import harness

    bench = harness.Benchmark(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": nothing measured", file=sys.stderr)
        return 2
    if chips > 1 and "LOCAL_RANK" not in os.environ:
        return under_torchrun("gpbench.run", argv, chips)
    t_start = T_START
    if START_ENV in os.environ:
        t_start -= T_WALL - float(os.environ[START_ENV])
    result, lines = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))), t_start)
    if result is None:
        return 0
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found} after the window: no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
