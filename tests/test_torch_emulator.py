"""The serving slice as a whole: a JAX checkpoint served by the port.

The JAX `save_emulator` writes a checkpoint; the port's `load_emulator`
reads it, refits at the stored hyperparameters and serves. fp64 ("gemm"
tier, full_cov, validate_against) is held to rtol 1e-8: the same algorithm
through different LAPACK builds on a mildly conditioned problem. fp32
serve="fused" (the kernels' plain versions) is held against JAX
serve="pallas" (interpret mode) to tests/test_serve_facade.py:35-38.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gp_emu_uqsa_tpu import gp as jgp
from gp_emu_uqsa_tpu.emulator import Emulator as JEmulator
from gp_emu_uqsa_tpu.kernels import make_params as jparams
from gp_emu_uqsa_tpu.utils.checkpoint import (
    load_emulator as jload, save_emulator as jsave,
)

from gp_emu_uqsa_torch.utils.checkpoint import (
    load_emulator as tload, save_emulator as tsave,
)

torch.set_num_threads(1)


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _jax_checkpoint(path, dtype, d=3, n=96, nugget=1e-4):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 2.0, size=(n, d))
    y = np.sin(3.0 * x[:, 0]) + x[:, 1] * x[:, 2]
    emul = JEmulator.from_arrays(x, y, tv_config=(4, 0, 1), dtype=dtype, seed=0)
    emul.params = jparams(np.array([0.9, 1.4, 2.1][:d]) * 3.0, nugget=nugget,
                          dtype=dtype)
    xt, yt, ht = emul.train_view()
    emul.state = jgp.fit(emul.params, xt, yt, ht)
    jsave(path, emul)
    return emul


@pytest.fixture(scope="module")
def fp64_pair(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt64") / "emu"
    _jax_checkpoint(path, jnp.float64)
    return jload(path), tload(path, device="cpu", dtype=torch.float64)


def _queries(m, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 2.0, size=(m, 3))


def test_checkpoint_refit_matches(fp64_pair):
    jemul, temul = fp64_pair
    assert temul.splits.tv_config == jemul.splits.tv_config
    np.testing.assert_array_equal(temul.splits.order, jemul.splits.order)
    for a, b in zip(temul.params, jemul.params):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for field in ("beta", "sigma2", "nll", "jitter"):
        np.testing.assert_allclose(_np(getattr(temul.state, field)),
                                   np.asarray(getattr(jemul.state, field)),
                                   rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("include_nugget", [False, True])
def test_gemm_tier_matches_jax_xla(fp64_pair, include_nugget):
    jemul, temul = fp64_pair
    xq = _queries(40)
    jm, jv = jemul.predict(xq, serve="xla", include_nugget=include_nugget)
    tm, tv = temul.predict(xq, serve="gemm", include_nugget=include_nugget)
    s2 = float(jemul.state.sigma2)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-6,
                               atol=1e-10 * s2)


def test_full_cov_and_validate_against_match(fp64_pair):
    jemul, temul = fp64_pair
    xq = _queries(25, seed=2)
    jm, jc = jemul.predict(xq, full_cov=True)
    tm, tc = temul.predict(xq, full_cov=True)
    s2 = float(jemul.state.sigma2)
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-6,
                               atol=1e-10 * s2)
    jd = jemul.validate_against(0, message=False)
    td = temul.validate_against(0, message=False)
    for k in jd:
        np.testing.assert_allclose(_np(td[k]), np.asarray(jd[k]), rtol=1e-7,
                                   atol=1e-10)


def test_updated_beliefs_match(fp64_pair):
    jemul, temul = fp64_pair
    jb, tb = jemul.updated_beliefs(), temul.updated_beliefs()
    for field in ("basis_str", "basis_inf", "mucm", "fix_nugget", "kernel",
                  "input_minmax"):
        assert getattr(tb, field) == getattr(jb, field)
    for field in ("delta", "nugget", "sigma", "beta"):
        np.testing.assert_allclose(getattr(tb, field), getattr(jb, field),
                                   rtol=1e-8)


@pytest.mark.parametrize("include_nugget", [False, True])
def test_fused_tier_fp32_matches_jax_pallas(tmp_path, include_nugget):
    path = tmp_path / "emu32"
    jemul = _jax_checkpoint(path, jnp.float32)
    temul = tload(path, device="cpu", dtype=torch.float32)
    assert temul.state.l.dtype == torch.float32
    xq = _queries(40, seed=3)
    jm, jv = jemul.predict(xq, serve="pallas", quad_precision="highest",
                           include_nugget=include_nugget)
    for tier in ("highest", "high"):
        tm, tv = temul.predict(xq, serve="fused", quad_precision=tier,
                               include_nugget=include_nugget)
        s2 = float(jemul.state.sigma2)
        np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-4,
                                   atol=1e-4 * max(1.0, s2))
        np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=2e-3,
                                   atol=1e-4 * s2)


def test_port_checkpoint_loads_in_jax(tmp_path, fp64_pair):
    _, temul = fp64_pair
    tsave(tmp_path / "back", temul)
    back = jload(tmp_path / "back")
    xq = _queries(10, seed=4)
    jm, _ = back.predict(xq, serve="xla")
    tm, _ = temul.predict(xq, serve="gemm")
    np.testing.assert_allclose(_np(tm), np.asarray(jm), rtol=1e-8, atol=1e-10)


def test_serve_gate(fp64_pair):
    _, temul = fp64_pair
    # on the CPU "auto" stays on the gemm tier; "fused" forces the plain
    # versions of K3/K4 (the port's interpret mode)
    assert not temul._use_fused_serve("auto", m=4096, d=3)
    assert temul._use_fused_serve("fused", m=16, d=3)
    assert not temul._use_fused_serve("gemm", m=1 << 20, d=3)
    assert not temul._use_fused_serve("fused", m=1 << 20, d=21)
    matern = dataclasses.replace(temul.mle_config, family="matern52")
    assert not dataclasses.replace(temul, mle_config=matern)._use_fused_serve(
        "fused", m=1 << 20, d=3)
    with pytest.raises(ValueError, match="serve tier"):
        temul._use_fused_serve("pallas", m=16, d=3)
