"""The control of each one-card cell on the card, at the cell's own size:
the program's numbers fall within the cell's limits and the control's
(the reference in float32 with TF32 products, in the program's place)
break at least one. Skips without a card.

    python3 -m pytest gpbench/tests/test_gpbench_card.py -m cuda
"""
import pytest
import torch

from gpbench import control, harness
from gpbench.run import ROOT

SEED = 2 ** 31 + 17


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["cfg5.serve_fused", "cfg4.nuts64"])
def test_control_breaks_a_limit(card, workload):
    bench = harness.Benchmark(ROOT)
    line = control.read_seed(bench, workload, SEED, 3.0, card)
    limits = bench.limits(workload)
    program_ok, _ = harness.compare(line["program"], limits)
    control_ok, _ = harness.compare(line["control"], limits)
    assert program_ok, line
    assert not control_ok, line
