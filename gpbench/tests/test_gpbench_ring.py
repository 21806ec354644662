"""The cell over four cards, rehearsed on the CPU in four gloo ranks at a
tiny size: it runs and is correct, and with the exchange between ranks
left out it comes out not correct."""
import pytest

from gp_emu_uqsa_torch.parallel import spawn_ranks

SEED = 2 ** 31 + 13


def run(tiny, fault=None):
    tiny.add("cfg5.ring_4card", "tiny_ring", {"n": 256},
             {"m": 4096, "chunk": 256, "block": 32, "sample_points": 64})
    results = spawn_ranks(
        _entry(), 4, (str(tiny.root), "tiny_ring", SEED, 1.0, fault),
        device_type="cpu")
    assert results[1:] == [None, None, None]
    return results[0]


def _entry():
    from gpbench.tests.ranks import run_rank
    return run_rank


def test_ring_cell_runs(tiny):
    result = run(tiny)
    assert result["correct"], result["checks"]
    assert result["device"]["count"] == 4
    assert result["metrics"]["points_per_s"]["value"] > 0


def test_ring_without_exchange_is_not_correct(tiny):
    result = run(tiny, "no_exchange")
    assert not result["correct"], result["checks"]
