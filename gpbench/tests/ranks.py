"""A rank of a cell over several ranks, run on the CPU by the tests through
`gp_emu_uqsa_torch.parallel.spawn_ranks` (a gloo group; a function that a
spawned process imports by name)."""
import time

import torch

from gpbench import harness


def run_rank(rank, root, workload, seed, seconds, fault=None):
    torch.set_num_threads(1)
    if fault == "no_exchange":
        from gp_emu_uqsa_torch.parallel import mesh
        mesh.shift = lambda t, group: t
        import gp_emu_uqsa_torch.parallel.ring as ring
        ring.shift = mesh.shift
    bench = harness.Benchmark(root)
    return harness.run_cell(bench, workload, seed, seconds, False, "cpu",
                            time.perf_counter())[0]
