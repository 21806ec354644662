"""The operation and byte counts against values worked by hand at small
shapes."""
import types

import pytest

from gpbench import peaks
from gpbench.counts import mucm, serve


def test_k3_by_hand():
    # m = 2, n = 3, d = 1, r = 2: 6 pairs x (3 + 1 + 4) operations;
    # bytes 4 (2 + 3 + 6 + 4)
    assert serve.k3(2, 3, 1, 2) == (48.0, 60)


def test_k4_high_by_hand():
    # m = 2, n = 3, d = 1: rebuild 6 x 4 = 24; triangle 2 x 3 x 4 = 24,
    # three passes 72; bytes 4 (2 + 3 + 6 + 2)
    assert serve.k4_high(2, 3, 1) == (24.0, 72.0, 52.0)


def test_request_useful_flops_by_hand():
    # m = 2, n = 3, d = 1, q = 2: K3 at r = 3 gives 6 x 10 = 60, the
    # rebuild 24, the triangle once 24, the R-term 2 (8 + 8) = 32
    assert serve.request_useful_flops(2, 3, 1, 2) == 140.0


def test_mucm_by_hand():
    # n = 2, d = 1, q = 1: build 3 x 4 = 12, Cholesky 8/3, solves 4 x 2 = 8,
    # G/beta 4 + 8, back-solve 4, L^-1 and A^-1 16/3, A^-1 H 4, W 4 x 6 = 24,
    # the contraction 4 x 3 = 12
    want = 12 + 8 / 3 + 8 + 12 + 4 + 16 / 3 + 4 + 24 + 12
    assert mucm.value_and_grad_flops(2, 1, 1) == pytest.approx(want)


def test_least_seconds_takes_the_binding_roof():
    p = {"fp32": 1.0, "tf32": 10.0, "bytes": 100.0}
    assert serve.least_seconds(2.0, 0.0, 0.0, p) == 2.0
    assert serve.least_seconds(0.0, 50.0, 0.0, p) == 5.0
    assert serve.least_seconds(1.0, 10.0, 1000.0, p) == 10.0


def test_mfu_from_evaluations():
    rec = {"counts": {"evaluations": 5}, "chains": 2, "n": 2, "d": 1,
           "q": 1, "window_s": 2.0}
    ops = 5 * 2 * mucm.value_and_grad_flops(2, 1, 1)
    p = {"tf32": 5.0}
    assert mucm.mfu_pct(rec, p, 1) == pytest.approx(100 * ops / 10.0)
    assert mucm.mfu_pct(dict(rec, counts={"evaluations": 0}), p, 1) is None


def test_peaks_match_the_card_name():
    assert peaks.for_card("NVIDIA H100 80GB HBM3")["tf32"] == 495e12
    assert peaks.for_card("NVIDIA H100 PCIe")["bytes"] == 2.0e12
    assert peaks.for_card("NVIDIA A100-SXM4-80GB") is None


@pytest.mark.parametrize("name,kernel,cost", [
    ("k4_high_roofline_pct", "corr_quad_tf32x3_kernel",
     lambda m: serve.k4_high(m, 64, 8)),
    ("k3_roofline_pct", "corr_matvec_kernel<10>",
     lambda m: (serve.k3(m, 64, 8, 10)[0], 0.0, serve.k3(m, 64, 8, 10)[1])),
])
def test_roofline_readers(name, kernel, cost):
    from pathlib import Path

    from gpbench.harness import load_module
    reader = load_module(Path(__file__).resolve().parent.parent / "metrics"
                         / f"{name}.py")
    p = {"fp32": 1e9, "tf32": 1e10, "bytes": 1e9}
    run = types.SimpleNamespace(
        peaks=p, record={"sizes": [32, 96], "n": 64, "d": 8, "q": 9},
        trace={"kernel_s": {f"void {kernel}(int)": 2.0, "other": 5.0}})
    least = sum(serve.least_seconds(*cost(m), p) for m in (32, 96))
    assert reader.read(run) == pytest.approx(100 * least / 2.0)
    run.trace = None
    assert reader.read(run) is None
