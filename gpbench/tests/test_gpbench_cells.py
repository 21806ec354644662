"""A cell added as new files only is found and run, on the CPU at a tiny
size; and a run whose timed path is broken underneath comes out not
correct, once for each fault its cell can have."""
import time

import pytest
import torch

from gpbench import harness

SEED = 2 ** 31 + 11
CELLS = {
    "serve": ("cfg5.serve_fused", {"n": 256},
              {"m_min": 64, "m_max": 1024, "pool": 8192, "warm": [64, 1024],
               "sample_points": 64}, None),
    "nuts": ("cfg4.nuts64", {"n": 96, "d": 3},
             {"chains": 8, "warmup": 10, "max_depth": 5, "step_size": 0.8,
              "inv_mass": [0.01, 0.02, 0.013]}, None),
}


def run(tiny, kind, trace=False, seconds=1.0):
    base, config, traffic, limits = CELLS[kind]
    tiny.add(base, f"tiny_{kind}", config, traffic, limits)
    bench = harness.Benchmark(tiny.root)
    return harness.run_cell(bench, f"tiny_{kind}", SEED, seconds, trace,
                            "cpu", time.perf_counter())[0]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_added_cell_runs(tiny, kind):
    result = run(tiny, kind)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    wanted = harness.Benchmark(tiny.root).metrics_for(f"tiny_{kind}", False)
    assert set(result["metrics"]) == {m["name"] for m in wanted}
    assert "setup_s" in result["metrics"]


def test_added_metric_is_read_in_a_traced_run(tiny):
    (tiny.root / "gpbench" / "metrics" / "requests_seen.py").write_text(
        "def read(run):\n    return float(len(run.record['latencies_s']))\n")
    tiny.spec["per_layer"].append({
        "name": "requests_seen", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "facade", "moves": "points_per_s",
        "workloads": ["tiny_serve"]})
    tiny.write()
    result = run(tiny, "serve", trace=True)
    assert result["correct"]
    assert result["metrics"]["requests_seen"]["value"] >= 1
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _half_batch(fn):
    """The first half of the rows computed, the rest given their mean."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, tuple):
            return tuple(_half_mean(o) for o in out)
        return _half_mean(out)
    return broken


def _half_mean(v):
    if v.ndim == 0 or v.shape[0] < 2:
        return v
    half = v.shape[0] // 2
    return torch.cat([v[:half], v[:half].mean(0, keepdim=True).expand_as(v[half:])])


def _predict_altered(fn):
    def broken(self, *args, **kwargs):
        mean, var = fn(self, *args, **kwargs)
        return mean + 1e-2 * mean.abs().max(), var
    return broken


def _nuts_unchanged(fn):
    def broken(gen, ld, z, *args, **kwargs):
        draws, stats, gen = fn(gen, ld, z, *args, **kwargs)
        return z[:, None, :].expand_as(draws).clone(), stats, gen
    return broken


def _half_chains_unchanged(fn):
    """A transition that leaves the first half of the chains where they
    were."""
    def broken(ld_grad, z0, *args, **kwargs):
        z_prop, accept, diverged = fn(ld_grad, z0, *args, **kwargs)
        half = z0.shape[0] // 2
        return torch.cat([z0[:half], z_prop[half:]]), accept, diverged
    return broken


def _nuts_altered(fn):
    def broken(*args, **kwargs):
        draws, stats, gen = fn(*args, **kwargs)
        return draws + 0.05, stats, gen
    return broken


FAULTS = {
    ("serve", "answer_altered"): ("gp_emu_uqsa_torch.emulator.Emulator.predict",
                                  _predict_altered),
    ("serve", "half_batch"): ("gp_emu_uqsa_torch.emulator.Emulator.predict",
                              _half_batch),
    ("nuts", "state_unchanged"): ("gp_emu_uqsa_torch.inference.nuts.nuts_continue",
                                  _nuts_unchanged),
    ("nuts", "answer_altered"): ("gp_emu_uqsa_torch.inference.nuts.nuts_continue",
                                 _nuts_altered),
    ("nuts", "half_batch"): ("gp_emu_uqsa_torch.gp.nll", _half_batch),
    ("nuts", "half_chains_unchanged"): (
        "gp_emu_uqsa_torch.inference.nuts._nuts_transition",
        _half_chains_unchanged),
}


@pytest.mark.parametrize("kind,fault", sorted(FAULTS),
                         ids=[f"{k}-{f}" for k, f in sorted(FAULTS)])
def test_fault_comes_out_not_correct(tiny, monkeypatch, kind, fault):
    target, breaker = FAULTS[(kind, fault)]
    module_name, _, attr = target.rpartition(".")
    owner_name, _, cls = module_name.rpartition(".")
    import importlib
    try:
        owner = getattr(importlib.import_module(owner_name), cls)
        original = getattr(owner, attr)
    except (ImportError, AttributeError):
        owner = importlib.import_module(module_name)
        original = getattr(owner, attr)
    monkeypatch.setattr(owner, attr, breaker(original))
    result = run(tiny, kind)
    assert not result["correct"], result["checks"]
