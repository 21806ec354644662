"""The cells of the Matern 5/2 emulator and of small requests, on the CPU
at a tiny size: they run and come out correct, a fault in the served
answers or the family comes out not correct, and the Matern counts and
readers agree with values worked by hand."""
import time
import types
from pathlib import Path

import pytest
import torch

from gpbench import harness
from gpbench.counts import serve, serve_matern52 as m52

SEED = 2 ** 31 + 11
HOME = Path(__file__).resolve().parent.parent
CELLS = {
    "m52": ("cfg5m52.serve_fused", {"n": 256},
            {"m_min": 64, "m_max": 1024, "pool": 8192, "warm": [64, 1024],
             "sample_points": 64}),
    "small": ("cfg5.serve_small", {"n": 256},
              {"m_min": 16, "m_max": 255, "pool": 8192, "warm": [16, 255],
               "sample_points": 64}),
}


def run(tiny, kind, trace=False):
    base, config, traffic = CELLS[kind]
    tiny.add(base, f"tiny_{kind}", config, traffic)
    bench = harness.Benchmark(tiny.root)
    return harness.run_cell(bench, f"tiny_{kind}", SEED, 1.0, trace, "cpu",
                            time.perf_counter())[0]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_runs_correct(tiny, kind):
    result = run(tiny, kind)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    wanted = harness.Benchmark(tiny.root).metrics_for(f"tiny_{kind}", False)
    assert set(result["metrics"]) == {m["name"] for m in wanted}


def test_matern_window_records_launches(tiny, capsys):
    base, config, traffic = CELLS["m52"]
    tiny.add(base, "tiny_m52", config, traffic)
    bench = harness.Benchmark(tiny.root)
    ctx = harness.make_context(bench, "tiny_m52", SEED, 0.3, False, "cpu")
    driver = bench.driver(ctx.traffic)
    record = driver.window(driver.setup(ctx), ctx)
    # the plain versions on the CPU launch nothing
    assert record["launches"]["corr_quad.family_launches"] == {
        "gaussian": 0, "matern52": 0}
    assert "launches in the window" in capsys.readouterr().err


def _wrong_family(fn):
    """The fit's correlation served as the Gaussian."""
    def broken(self, *args, **kwargs):
        import dataclasses
        saved = self.mle_config
        self.mle_config = dataclasses.replace(saved, family="gaussian")
        try:
            return fn(self, *args, **kwargs)
        finally:
            self.mle_config = saved
    return broken


def _var_altered(fn):
    def broken(self, *args, **kwargs):
        mean, var = fn(self, *args, **kwargs)
        return mean, var * 1.01
    return broken


@pytest.mark.parametrize("kind, breaker", [("m52", _wrong_family),
                                           ("m52", _var_altered),
                                           ("small", _var_altered)])
def test_fault_comes_out_not_correct(tiny, monkeypatch, kind, breaker):
    from gp_emu_uqsa_torch.emulator import Emulator
    monkeypatch.setattr(Emulator, "predict", breaker(Emulator.predict))
    result = run(tiny, kind)
    assert not result["correct"], result["checks"]


def test_matern_counts_by_hand():
    # m = 2, n = 3, d = 1: 3 d + 8 = 11 a pair; K3 at r = 2 adds 4 a pair
    assert m52.k3(2, 3, 1, 2) == (90.0, serve.k3(2, 3, 1, 2)[1])
    assert m52.k4_high(2, 3, 1) == (66.0, 72.0, 52.0)
    # K3 at r = 3: 6 x 17; the rebuild 66; the triangle once 24; R-term 32
    assert m52.request_useful_flops(2, 3, 1, 2) == 102 + 66 + 24 + 32


@pytest.mark.parametrize("name, body, shared", [
    ("k4_high_m52_roofline_pct", "corr_quad_tf32x3_kernel", "tf32_split_kernel"),
    ("k3_m52_roofline_pct", "corr_matvec_kernel<10, ", "matvec_combine_kernel"),
])
def test_family_readers(name, body, shared):
    reader = harness.load_module(HOME / "metrics" / f"{name}.py")
    p = {"fp32": 1e9, "tf32": 1e10, "bytes": 1e9}
    rec = {"sizes": [32, 96], "n": 64, "d": 8, "q": 9}
    trace = {"kernel_s": {f"void {body}gpemu::Matern52>(int)": 2.0,
                          f"void {body}gpemu::Gaussian>(int)": 7.0,
                          f"void {shared}(int)": 1.0, "other": 5.0}}
    run = types.SimpleNamespace(peaks=p, record=rec, trace=trace)
    if name.startswith("k4"):
        least = sum(m52.least_seconds(*m52.k4_high(m, 64, 8), p) for m in (32, 96))
    else:
        least = sum(m52.least_seconds(m52.k3(m, 64, 8, 10)[0], 0.0,
                                      m52.k3(m, 64, 8, 10)[1], p)
                    for m in (32, 96))
    assert reader.read(run) == pytest.approx(100 * least / 3.0)
    # a program with no Matern instance (the Gaussian alone) reads nothing
    del trace["kernel_s"][f"void {body}gpemu::Matern52>(int)"]
    assert reader.read(run) is None
    run.trace = None
    assert reader.read(run) is None


def test_matern_mfu_reader():
    reader = harness.load_module(HOME / "metrics" / "serve_m52_mfu_pct.py")
    rec = {"sizes": [32, 96], "n": 64, "d": 8, "q": 9, "window_s": 2.0}
    run = types.SimpleNamespace(peaks={"tf32": 1e10}, record=rec, chips=1)
    ops = sum(m52.request_useful_flops(m, 64, 8, 9) for m in (32, 96))
    assert reader.read(run) == pytest.approx(100 * ops / 2e10)
    assert torch.isfinite(torch.tensor(reader.read(run)))
