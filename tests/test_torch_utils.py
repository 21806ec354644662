"""The port's single-device utilities against the JAX package's.

utils/sanitize.py: the first failing stage of `checked_fit` named with the
JAX package's message, on tests/test_sanitize.py's inputs (fp64, CPU), and
the clean fit's NLL at rtol 1e-12 of gp.fit's; `debug_nans` raising
FloatingPointError. utils/logging.py: the JSONL records carry the JAX
package's keys. utils/timing.py: the adaptive reps, with
tests/test_utils.py's bounds. utils/roofline.py: the H100 roofs by card
name.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis, linear_basis
from gp_emu_uqsa_tpu.kernels import GPParams as JParams
from gp_emu_uqsa_tpu.kernels import make_params as jparams
from gp_emu_uqsa_tpu.utils import logging as jlog
from gp_emu_uqsa_tpu.utils import sanitize as jsan

from gp_emu_uqsa_torch import gp as tgp
from gp_emu_uqsa_torch.basis import basis_matrix as tbasis
from gp_emu_uqsa_torch.kernels import GPParams as TParams
from gp_emu_uqsa_torch.kernels import make_params as tparams
from gp_emu_uqsa_torch.utils import logging as tlog
from gp_emu_uqsa_torch.utils import roofline, sanitize as tsan, timing

torch.set_num_threads(1)


def _problem(n=30, d=2, seed=0):
    """tests/test_sanitize.py's data in both packages."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(3 * x[:, 0]) + x[:, 1]
    jx, tx = jnp.asarray(x), torch.tensor(x)
    return ((jx, jnp.asarray(y), jbasis(jx, linear_basis(d))),
            (tx, torch.tensor(y), tbasis(tx, linear_basis(d))))


def _params(log_delta0=None):
    jp = jparams([0.6, 1.0], nugget=1e-6, dtype=jnp.float64)
    tp = tparams([0.6, 1.0], nugget=1e-6, dtype=torch.float64, device="cpu")
    if log_delta0 is not None:
        jp = JParams(jp.log_delta.at[0].set(log_delta0), jp.log_sigma2,
                     jp.log_nugget)
        ld = tp.log_delta.clone()
        ld[0] = log_delta0
        tp = TParams(ld, tp.log_sigma2, tp.log_nugget)
    return jp, tp


def _cases():
    (jx, jy, jh), (tx, ty, th) = _problem()
    xbad = np.asarray(jx).copy()
    xbad[3, 1] = np.nan
    ybad = np.asarray(jy).copy()
    ybad[0] = np.inf
    return {
        "clean": ((jx, jy, jh), (tx, ty, th), None, {}),
        "nonfinite_x": ((jnp.asarray(xbad), jy, jh),
                        (torch.tensor(xbad), ty, th), None, {}),
        "nonfinite_y": ((jx, jnp.asarray(ybad), jh),
                        (tx, torch.tensor(ybad), th), None, {}),
        "nan_log_delta": ((jx, jy, jh), (tx, ty, th), np.nan, {}),
        "constant_y": ((jx, jnp.ones_like(jy) * 2.5, jh),
                       (tx, torch.full_like(ty, 2.5), th), None, {}),
        "negative_noise": ((jx, jy, jh), (tx, ty, th), None,
                           {"noise_diag": np.full(30, -5.0)}),
    }


def _message(jerr):
    """checkify's message without the suffix it appends."""
    msg = jerr.get()
    return None if msg is None else msg.removesuffix(" (`check` failed)")


@pytest.mark.parametrize("case", list(_cases()))
def test_checked_fit_names_the_same_first_stage_as_jax(case):
    jargs, targs, bad_delta, kw = _cases()[case]
    jp, tp = _params(bad_delta)
    jerr, jstate = jsan.checked_fit(jp, *jargs, **kw)
    terr, tstate = tsan.checked_fit(tp, *targs, **kw)
    assert terr.get() == _message(jerr)
    if case == "clean":
        assert terr.get() is None
        terr.throw()                                   # no-op
        np.testing.assert_allclose(float(tstate.nll),
                                   float(tgp.fit(tp, *targs).nll), rtol=1e-12)
        np.testing.assert_allclose(float(tstate.nll), float(jstate.nll),
                                   rtol=1e-10)
    else:
        assert terr.get() is not None
        with pytest.raises(RuntimeError, match=terr.get()[:20]):
            terr.throw()
    if case == "nan_log_delta":
        assert "kernel matrix" in terr.get()
        # the production convention is unchanged: inf, never NaN
        assert not np.isnan(float(tgp.nll(tp, *targs)))
    jnll_err, jnll = jsan.checked_nll(jp, *jargs)
    tnll_err, tnll = tsan.checked_nll(tp, *targs)
    if not kw:
        assert tnll_err.get() == _message(jnll_err)


def test_debug_nans_raises_floating_point_error():
    with tsan.debug_nans():
        ok = torch.log(torch.ones(3)) * 1.0            # finite: no raise
        with pytest.raises(FloatingPointError):
            torch.log(-torch.ones(3)) * 1.0
        with pytest.raises(FloatingPointError):
            (-torch.ones(3)) ** 0.5
    assert torch.isnan(torch.log(-torch.ones(3))).all()   # off again
    with tsan.debug_nans(enable=False):
        torch.log(-torch.ones(3))
    assert ok.tolist() == [0.0, 0.0, 0.0]


def test_structured_logging_records_have_jax_keys(tmp_path):
    records = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        log = tmp_path / f"{name}.jsonl"
        mod.set_log_path(log)
        mod.log_event("fit", nll=1.23, n=100)
        with mod.timed("predict", n_points=10):
            pass
        mod.set_log_path(None)
        mod.log_event("dropped", n=1)                  # disabled: no-op
        records[name] = [json.loads(line) for line in log.read_text()
                         .splitlines()]
    assert [sorted(r) for r in records["torch"]] == [
        sorted(r) for r in records["jax"]]
    assert records["torch"][0]["event"] == "fit"
    assert records["torch"][0]["nll"] == 1.23
    assert records["torch"][1]["event"] == "predict"
    assert records["torch"][1]["seconds"] >= 0.0


def test_profiler_trace_writes_a_trace(tmp_path):
    with tlog.profiler_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert list(tmp_path.glob("*.pt.trace.json"))
    with tlog.profiler_trace(None):
        pass


def test_adaptive_timed_scales_reps():
    """tests/test_utils.py's check: a fixed per-sync cost is amortized by
    scaling the reps, and the estimate lands within 2x of the op's time."""
    import time as _time

    op_s = 2e-4
    sync_s = 5e-3
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        _time.sleep(op_s)
        return object()

    def sync(_):
        _time.sleep(sync_s)

    est = timing.timed(fn, sync, min_total_s=0.05, max_reps=4096)
    assert 0.5 * op_s < est < 2.0 * op_s, est
    assert calls["n"] > 64


def test_roofline_peaks_by_card_name():
    assert roofline._peak("NVIDIA H100 80GB HBM3") == {"fp32": 67e12,
                                                       "tf32": 495e12}
    assert roofline._peak("NVIDIA H100 PCIe")["fp32"] == 51e12
    assert roofline._peak_bw("NVIDIA H100 NVL") == 3.9e12
    assert roofline._peak_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline._peak("Tesla V100-SXM2-16GB") is None
    assert roofline._peak_bw("cpu") is None


def test_roofline_measurements_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for fn in (roofline.measure, roofline.measure_hmc, roofline.measure_nuts):
        with pytest.raises((RuntimeError, ValueError)):
            fn(device="cpu" if fn is roofline.measure else None)


# ----- on the card (skips elsewhere) -----------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_timed_and_measure(cuda_device):
    """timing.timed on the card (CUDA events) and roofline.measure at a
    small size report positive times and the card's name."""
    a = torch.randn((512, 512), device=cuda_device)
    est = timing.timed(lambda: a @ a, lambda o: torch.cuda.synchronize(),
                       min_total_s=0.01)
    assert est > 0.0
    res = roofline.measure(n=512, m=512, device=cuda_device)
    assert res["device"] == torch.cuda.get_device_name(cuda_device)
    assert res["kernel_build_k1"]["seconds"] > 0.0
