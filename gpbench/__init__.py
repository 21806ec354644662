"""gpbench: the benchmark of gp_emu_uqsa_torch on NVIDIA H100 cards.

    python3 -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once and prints its result as the last
line of standard output (`harness.py` says where each piece lives).
"""
