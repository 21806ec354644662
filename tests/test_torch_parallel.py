"""The port's multi-device path on four gloo ranks, held against JAX.

The ranks are spawned once for the module (`_ranks`); each runs every
case of `_cases` in turn, in fp64 unless a case says otherwise, and
returns numpy arrays. The tests compare them with the JAX package's
functions on a 4-device CPU mesh and with the port's single-device path,
at tests/test_parallel.py's sizes and tolerances. JAX is imported inside
the tests only, so the spawned ranks never load it.
"""
import os
import time
import traceback

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference import MLEConfig, mle_fit
from gp_emu_uqsa_torch.kernels import corr_self, make_params
from gp_emu_uqsa_torch.ops.distributed_cholesky import (
    distributed_cholesky, distributed_cholesky_recursive,
    distributed_tri_solve, pad_identity, recursive_block,
)
from gp_emu_uqsa_torch.parallel import (
    build_corr_sharded, fit_large, init_multihost, make_mesh,
    predict_sharded, predictor_large, ring_predict, spawn_ranks,
)
from gp_emu_uqsa_torch.parallel.mesh import (
    gather_rows, padded_rows, shard_rows, traffic,
)

torch.set_num_threads(1)

WORLD = 4
F64 = torch.float64
# L-BFGS iterations of the mle_fit case, on both sides (the default 200
# stops on the cap too: the 1e-8 gradient tolerance is rarely met)
MLE_ITERS = 20
# (n, block): the rows are dealt in blocks of the panel width, so 512/128
# is the JAX package's contiguous layout and the others are block-cyclic
PANEL_CASES = [(300, 64), (512, 128), (300, 16)]
# the solves' steps at n = 300: 128 pads to 512, one block a rank (the
# contiguous layout); 32 pads to 384, three blocks a rank
SOLVE_BLOCKS = [128, 32]


def _spd(n, seed):
    m = np.random.default_rng(seed).standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


def _fit_problem(n, d, seed, delta, nugget, m=None, dtype=np.float64):
    """x, y, h (numpy), delta, nugget, and queries xs, hs if m."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(dtype)
    y = (np.sin(3 * x[:, 0]) + x[:, 1] - 0.5 * x[:, 2]).astype(dtype)
    xs = rng.uniform(size=(m, d)).astype(dtype) if m else None
    return x, y, xs, delta, nugget


def _refine_problem():
    """tests/test_parallel.py::test_fit_large_refine_fp32_compensated's
    clustered fp32 system."""
    rng = np.random.default_rng(9)
    n, d = 512, 3
    base = rng.uniform(size=(n // 2, d))
    xx = np.vstack([base, base + 1e-3 * rng.standard_normal((n // 2, d))])
    return (xx.astype(np.float32),
            (np.sin(3 * xx[:, 0]) + xx[:, 1]).astype(np.float32))


def _mle_problem():
    import oracle
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(60, 2))
    a = oracle.corr_self(x, np.array([0.4, 0.8]), 1e-8)
    return x, np.linalg.cholesky(a) @ rng.standard_normal(60)


def _bad_problem():
    """fp32, delta 1, nugget 1e-12: A is not positive definite in fp32."""
    x = np.random.default_rng(21).uniform(size=(120, 2)).astype(np.float32)
    return x, (np.sin(3 * x[:, 0]) + x[:, 1]).astype(np.float32)


def _torch_fit_inputs(x, y, delta, nugget, dtype=F64):
    xt = torch.as_tensor(x, dtype=dtype)
    yt = torch.as_tensor(y, dtype=dtype)
    h = basis_matrix(xt, linear_basis(x.shape[1]))
    p = make_params(np.full(x.shape[1], delta), nugget=nugget, dtype=dtype,
                    device="cpu")
    return xt, yt, h, p


def _np(t):
    return t.detach().cpu().numpy()


def _state_np(st):
    return {"nll": float(st.nll), "beta": _np(st.beta),
            "sigma2": float(st.sigma2), "e": _np(st.e),
            "ainv_h": _np(st.ainv_h)}


# ----- the ranks' side --------------------------------------------------


def _case_build(mesh):
    x = np.random.default_rng(5).uniform(size=(250, 3))
    xt, _, _, p = _torch_fit_inputs(x, x[:, 0], 0.6, 1e-3)
    out = {}
    for name, block in (("contiguous", None), ("cyclic", 16)):
        a, n = build_corr_sharded(xt, p, mesh, block=block)
        out[name] = (_np(gather_rows(a, mesh, "mr", block)), n)
    return out


def _case_panel(mesh):
    out = {}
    for n, blk in PANEL_CASES:
        a = torch.as_tensor(_spd(n, 4))
        a_rows = shard_rows(pad_identity(a, padded_rows(n, WORLD, blk)),
                            mesh, "mr", blk)
        traffic.reset()
        l = distributed_cholesky(a_rows, mesh, block=blk)
        sent = traffic.bytes
        out[(n, blk)] = (_np(gather_rows(l, mesh, "mr", blk)[:n, :n]), sent)
    return out


def _case_recursive(mesh):
    out = {}
    for n, leaf in ((300, 64), (1024, 128)):
        a = torch.as_tensor(_spd(n, 7))
        blk = recursive_block(leaf, WORLD)
        a_rows = shard_rows(pad_identity(a, padded_rows(n, WORLD, blk)),
                            mesh, "mr", blk)
        traffic.reset()
        l = distributed_cholesky_recursive(a_rows, mesh, leaf=leaf)
        sent = traffic.bytes
        out[(n, leaf)] = (_np(gather_rows(l, mesh, "mr", blk)[:n, :n]), sent,
                          _np(distributed_cholesky_recursive(a, None,
                                                             leaf=leaf)))
    return out


def _case_tri_solve(mesh):
    n = 300
    l = torch.linalg.cholesky(torch.as_tensor(_spd(n, 2)))
    b = torch.as_tensor(np.random.default_rng(3).standard_normal((n, 3)))
    out = {}
    for blk in SOLVE_BLOCKS:
        n_pad = padded_rows(n, WORLD, blk)
        l_rows = shard_rows(pad_identity(l, n_pad), mesh, "mr", blk)
        b_rows = shard_rows(torch.cat([b, b.new_zeros((n_pad - n, 3))]),
                            mesh, "mr", blk)
        for trans in (False, True):
            x = distributed_tri_solve(l_rows, b_rows, mesh, block=blk,
                                      trans=trans)
            out[(blk, trans)] = _np(gather_rows(x, mesh, "mr", blk)[:n])
    out["vector"] = _np(distributed_tri_solve(l, b[:, 0], None, block=64))
    return out


def _case_fit_large(mesh):
    x, y, _, delta, nugget = _fit_problem(220, 3, 6, 0.7, 1e-4)
    xt, yt, h, p = _torch_fit_inputs(x, y, delta, nugget)
    out = {"local": _state_np(gp.fit(p, xt, yt, h))}
    for fac in ("recursive", "panel"):
        out[fac] = _state_np(fit_large(p, xt, yt, h, mesh, block=64,
                                       factorization=fac, leaf=64))
    out["none"] = _state_np(fit_large(p, xt, yt, h, None, block=64))
    return out


def _case_refine(mesh):
    x, y = _refine_problem()
    xt, yt, h, p = _torch_fit_inputs(x, y, 1.2, 2.2e-3, torch.float32)
    st0 = fit_large(p, xt, yt, h, mesh, block=64)
    st1 = fit_large(p, xt, yt, h, mesh, block=64, refine=1)
    return {"e0": _np(st0.e), "e1": _np(st1.e), "beta": _np(st1.beta),
            "a32": _np(corr_self(xt, p))}


def _case_serving(mesh):
    out = {}
    for name, n, seed, delta, blk, m in (("aligned", 256, 12, 0.7, 64, 53),
                                         ("unaligned", 150, 13, 0.8, 32, 21)):
        x, y, xs, _, nugget = _fit_problem(n, 3, seed, delta, 1e-4, m=m)
        xt, yt, h, p = _torch_fit_inputs(x, y, delta, nugget)
        xs_t = torch.as_tensor(xs)
        hs = basis_matrix(xs_t, linear_basis(3))
        st = fit_large(p, xt, yt, h, mesh, block=blk)
        pred = predictor_large(st, mesh, block=blk)
        mesh_data = make_mesh({"data": WORLD}, device_type="cpu")
        mean, var = ring_predict(pred, xt, xs_t, hs, mesh_data)
        pred_l = gp.predictor(gp.fit(p, xt, yt, h))
        mean_w, var_w = ring_predict(pred_l, xt, xs_t, hs, mesh_data)
        out[name] = {"w": _np(gather_rows(pred.linv, mesh, "mr", blk)),
                     "mean": _np(mean), "var": _np(var),
                     "mean_whole": _np(mean_w), "var_whole": _np(var_w)}
    x, y, xs, delta, nugget = _fit_problem(40, 3, 0, 0.7, 1e-6, m=101)
    xt, yt, h, p = _torch_fit_inputs(x, y, delta, nugget)
    xs_t = torch.as_tensor(xs)
    hs = basis_matrix(xs_t, linear_basis(3))
    mean, var = predict_sharded(gp.fit(p, xt, yt, h), xt, h, xs_t, hs,
                                make_mesh({"data": WORLD}, device_type="cpu"))
    out["predict_sharded"] = {"mean": _np(mean), "var": _np(var)}
    return out


def _case_mle(mesh):
    x, y = _mle_problem()
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    h = basis_matrix(xt, linear_basis(2))
    cfg = MLEConfig(tries=8, max_iters=MLE_ITERS)
    mesh_chains = make_mesh({"chains": WORLD}, device_type="cpu")
    _, info = mle_fit(torch.Generator().manual_seed(0), xt, yt, h, cfg,
                      mesh=mesh_chains)
    return {"nlls": _np(info["nlls"]), "best": float(info["best_nll"]),
            "iters": _np(info["iters"])}


def _case_bad(mesh):
    x, y = _bad_problem()
    xt, yt, h, p = _torch_fit_inputs(x, y, 1.0, 0.0, torch.float32)
    out = {fac: float(fit_large(p, xt, yt, h, mesh, block=32,
                                factorization=fac).nll)
           for fac in ("recursive", "panel")}
    out["gp.nll"] = float(gp.nll(p, xt, yt, h, ladder=False))
    a = torch.as_tensor(_spd(128, 1)) - 200.0 * torch.eye(128)
    l = distributed_cholesky(shard_rows(a, mesh, "mr", 32), mesh, block=32)
    out["panel_rows_nan"] = bool(torch.isnan(l).all())
    return out


def _cases(rank):
    os.nice(10)        # below the other test workers: their timing tests
    out = {"init_multihost": init_multihost()}
    mesh = make_mesh({"mr": WORLD}, device_type="cpu")
    cases = {"build": _case_build, "panel": _case_panel,
             "recursive": _case_recursive, "tri_solve": _case_tri_solve,
             "fit_large": _case_fit_large, "refine": _case_refine,
             "serving": _case_serving,
             "mle": _case_mle, "bad": _case_bad}
    out["seconds"] = {}
    for name, case in cases.items():
        t0 = time.perf_counter()
        try:
            out[name] = case(mesh)
        except Exception:  # noqa: BLE001 - reported by the test of the case
            out[name] = RuntimeError(traceback.format_exc())
        out["seconds"][name] = time.perf_counter() - t0
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_cases, WORLD, device_type="cpu", timeout=300)


def _case(ranks, name, rank=0):
    got = ranks[rank][name]
    if isinstance(got, Exception):
        pytest.fail(f"case {name} failed on rank {rank}:\n{got}")
    return got


def _jax_mesh(shape):
    import jax
    from gp_emu_uqsa_tpu.parallel import make_mesh as jmake_mesh
    return jmake_mesh(shape, devices=jax.devices()[:WORLD])


def _jax_fit_inputs(x, y, delta, nugget, dtype=np.float64):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis
    from gp_emu_uqsa_tpu.basis import linear_basis as jlinear
    from gp_emu_uqsa_tpu.kernels import make_params as jmake
    xj = jnp.asarray(x)
    h = jbasis(xj, jlinear(x.shape[1]))
    p = jmake(np.full(x.shape[1], delta), nugget=nugget,
              dtype=jnp.float64 if dtype == np.float64 else jnp.float32)
    return xj, jnp.asarray(y), h, p


# ----- the tests ----------------------------------------------------------


def test_ranks_are_a_process_group(ranks):
    """The spawned ranks joined one gloo group; init_multihost inside it
    returns the JAX package's summary keys."""
    print("seconds a case on rank 0:", {k: round(v, 2) for k, v in
                                        ranks[0]["seconds"].items()})
    for r, out in enumerate(ranks):
        info = out["init_multihost"]
        assert info["process_index"] == r
        assert info["process_count"] == WORLD == info["global_devices"]
        assert info["initialized_distributed"]


def test_init_multihost_is_a_no_op_in_a_plain_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    info = init_multihost()
    assert info["process_count"] == 1 and not info["initialized_distributed"]


def test_cuda_ranks_and_meshes_raise_without_a_card(monkeypatch):
    """The device policy: CUDA unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_multihost()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"mr": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(_cases, 1, device_type="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(_cases, 1)


def _die_unreported(rank):
    os._exit(3)


def test_spawn_ranks_raises_when_a_rank_dies_without_a_result():
    """A rank that exits before it can report (at start-up, say) fails the
    call at once, not at the timeout. One rank: with two, the other could
    see the store's host go and report that error instead."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="exited without a result"):
        spawn_ranks(_die_unreported, 1, device_type="cpu", timeout=120)
    assert time.perf_counter() - t0 < 60


def test_build_corr_sharded_matches_jax_with_identity_tail(ranks):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.kernels import gaussian_corr_self, make_params as jm
    from gp_emu_uqsa_tpu.parallel.sharded_gp import (
        build_corr_sharded as jbuild,
    )
    got = _case(ranks, "build")
    x = np.random.default_rng(5).uniform(size=(250, 3))
    p = jm(np.full(3, 0.6), nugget=1e-3, dtype=jnp.float64)
    a_ref = np.asarray(gaussian_corr_self(jnp.asarray(x), p))
    a_jax, _ = jbuild(x, p, _jax_mesh({"mr": WORLD}))
    a_jax = np.asarray(a_jax)
    for name in ("contiguous", "cyclic"):
        a, n = got[name]
        assert n == 250
        np.testing.assert_allclose(a[:n, :n], a_ref, atol=1e-12)
        tail = a[n:, n:]
        np.testing.assert_array_equal(tail, np.eye(tail.shape[0]))
        assert not a[:n, n:].any() and not a[n:, :n].any()
    np.testing.assert_allclose(got["contiguous"][0], a_jax, atol=1e-12)


@pytest.mark.parametrize("n,blk", PANEL_CASES)
def test_panel_cholesky_matches_lapack_and_jax(ranks, n, blk):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.ops.distributed_cholesky import (
        distributed_cholesky as jchol,
    )
    l, sent = _case(ranks, "panel")[(n, blk)]
    a = _spd(n, 4)
    np.testing.assert_allclose(l, np.linalg.cholesky(a), rtol=1e-9,
                               atol=1e-9)
    assert np.allclose(np.triu(l, 1), 0.0)
    l_jax = np.asarray(jchol(jnp.asarray(a), _jax_mesh({"mr": WORLD}),
                             block=blk))
    np.testing.assert_allclose(l, l_jax, rtol=1e-9, atol=1e-9)
    # one (n_pad, B) all-gather a step: each rank sends its rows to the 3
    # others; 6 bytes for the failure flag
    n_pad = padded_rows(n, WORLD, blk)
    assert sent == (n_pad // blk) * 3 * (n_pad // WORLD) * blk * 8 + 6


@pytest.mark.parametrize("n,leaf", [(300, 64), (1024, 128)])
def test_recursive_cholesky_matches_lapack_and_jax(ranks, n, leaf):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.ops.distributed_cholesky import (
        distributed_cholesky_recursive as jrec,
    )
    l, sent, l_one = _case(ranks, "recursive")[(n, leaf)]
    a = _spd(n, 7)
    l_ref = np.linalg.cholesky(a)
    np.testing.assert_allclose(l, l_ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(l_one, l_ref, rtol=1e-9, atol=1e-9)
    assert np.allclose(np.triu(l, 1), 0.0)
    l_jax = np.asarray(jrec(jnp.asarray(a), _jax_mesh({"mr": WORLD}),
                            leaf=leaf))
    np.testing.assert_allclose(l, l_jax, rtol=1e-9, atol=1e-9)
    # the gathers: L11 and L21 a node, each leaf's square; each rank sends
    # 3/4 of every gathered word, and 6 bytes for the failure flag
    n_pad = padded_rows(n, WORLD, recursive_block(leaf, WORLD))
    words = _recursion_words(0, n_pad, leaf,
                             WORLD * recursive_block(leaf, WORLD))
    print(f"recursive n={n}: {sent} bytes sent a rank, "
          f"{words / n_pad ** 2:.2f} n_pad^2 words gathered")
    assert sent == 8 * words * (WORLD - 1) // WORLD + 6


def _recursion_words(s, e, leaf, span):
    """Words that `distributed_cholesky_recursive` gathers on [s, e)."""
    half = -(-(e - s) // (2 * span)) * span
    if e - s <= leaf or half >= e - s:
        return (e - s) ** 2
    h = s + half
    return (_recursion_words(s, h, leaf, span) + half * half
            + (e - h) * half + _recursion_words(h, e, leaf, span))


@pytest.mark.parametrize("blk", SOLVE_BLOCKS)
@pytest.mark.parametrize("trans", [False, True])
def test_distributed_tri_solve_matches_scipy_and_jax(ranks, blk, trans):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.ops.distributed_cholesky import (
        distributed_tri_solve as jsolve,
    )
    got = _case(ranks, "tri_solve")
    n = 300
    l = np.linalg.cholesky(_spd(n, 2))
    b = np.random.default_rng(3).standard_normal((n, 3))
    ref = sla.solve_triangular(l, b, lower=True, trans=1 if trans else 0)
    np.testing.assert_allclose(got[(blk, trans)], ref, rtol=1e-9,
                               atol=1e-12)
    x_jax = np.asarray(jsolve(jnp.asarray(l), jnp.asarray(b),
                              _jax_mesh({"mr": WORLD}), block=64,
                              trans=trans))
    np.testing.assert_allclose(got[(blk, trans)], x_jax, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got["vector"],
                               sla.solve_triangular(l, b[:, 0], lower=True),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("fac", ["recursive", "panel", "none"])
def test_fit_large_matches_jax_and_gp_fit(ranks, fac):
    from gp_emu_uqsa_tpu.parallel.large_fit import fit_large as jfit
    got = _case(ranks, "fit_large")
    st, loc = got[fac], got["local"]
    np.testing.assert_allclose(st["nll"], loc["nll"], rtol=1e-10)
    np.testing.assert_allclose(st["beta"], loc["beta"], rtol=1e-8)
    np.testing.assert_allclose(st["sigma2"], loc["sigma2"], rtol=1e-9)
    np.testing.assert_allclose(st["e"], loc["e"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(st["ainv_h"], loc["ainv_h"], rtol=1e-6,
                               atol=1e-8)
    if fac == "none":          # the one-device run: JAX's is its recursive
        return
    x, y, _, delta, nugget = _fit_problem(220, 3, 6, 0.7, 1e-4)
    xj, yj, hj, pj = _jax_fit_inputs(x, y, delta, nugget)
    jst = jfit(pj, xj, yj, hj, _jax_mesh({"mr": WORLD}), block=64,
               factorization=fac)
    np.testing.assert_allclose(st["nll"], float(jst.nll), rtol=1e-10)
    np.testing.assert_allclose(st["beta"], np.asarray(jst.beta), rtol=1e-8)
    np.testing.assert_allclose(st["e"], np.asarray(jst.e), rtol=1e-6,
                               atol=1e-8)


def test_fit_large_refine_fp32_within_the_jax_bounds(ranks):
    """tests/test_parallel.py::test_fit_large_refine_fp32_compensated's
    bounds: one sweep with the fp64 residual of each rank's rows and the
    fp32 distributed factor, against the fp64 solve of the same fp32 A."""
    got = _case(ranks, "refine")
    x, y = _refine_problem()
    h = np.asarray(basis_matrix(torch.as_tensor(x), linear_basis(3)),
                   np.float64)
    a64 = got["a32"].astype(np.float64)
    rhs = y.astype(np.float64) - h @ got["beta"].astype(np.float64)
    e64 = sla.cho_solve(sla.cho_factor(a64, lower=True), rhs)
    enorm = np.linalg.norm(e64)
    err0 = np.linalg.norm(got["e0"].astype(np.float64) - e64) / enorm
    err1 = np.linalg.norm(got["e1"].astype(np.float64) - e64) / enorm
    print(f"refine=1, fp32: {err0:.3e} -> {err1:.3e}")
    assert err1 < 1.5e-3
    assert err1 < err0 / 3


@pytest.mark.parametrize("name", ["aligned", "unaligned"])
def test_predictor_large_and_ring_predict_match_jax(ranks, name):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu import gp as jgp
    from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis
    from gp_emu_uqsa_tpu.basis import linear_basis as jlinear
    from gp_emu_uqsa_tpu.parallel.ring import ring_predict as jring
    got = _case(ranks, "serving")[name]
    n, seed, delta, m = {"aligned": (256, 12, 0.7, 53),
                         "unaligned": (150, 13, 0.8, 21)}[name]
    x, y, xs, _, nugget = _fit_problem(n, 3, seed, delta, 1e-4, m=m)
    xj, yj, hj, pj = _jax_fit_inputs(x, y, delta, nugget)
    pred_j = jgp.predictor(jgp.fit(pj, xj, yj, hj))
    w = got["w"][:n, :n]
    np.testing.assert_allclose(w, np.asarray(pred_j.linv), rtol=1e-6,
                               atol=1e-8)
    assert not got["w"][:n, n:].any()
    hs = jbasis(jnp.asarray(xs), jlinear(3))
    refs = [jgp.predict_fast(pred_j, xj, jnp.asarray(xs), hs)]
    if name == "aligned":      # JAX's own test holds its ring to predict_fast
        refs.append(jring(pred_j, xj, jnp.asarray(xs), hs,
                          _jax_mesh({"data": WORLD})))
    for mean, var in ((got["mean"], got["var"]),
                      (got["mean_whole"], got["var_whole"])):
        for mean_j, var_j in refs:
            np.testing.assert_allclose(mean, np.asarray(mean_j), rtol=1e-9)
            np.testing.assert_allclose(var, np.asarray(var_j), rtol=1e-7,
                                       atol=1e-12)


def test_predict_sharded_matches_jax_and_gp_predict(ranks):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu import gp as jgp
    from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis
    from gp_emu_uqsa_tpu.basis import linear_basis as jlinear
    from gp_emu_uqsa_tpu.parallel import predict_sharded as jps
    got = _case(ranks, "serving")["predict_sharded"]
    x, y, xs, delta, nugget = _fit_problem(40, 3, 0, 0.7, 1e-6, m=101)
    xt, yt, h, p = _torch_fit_inputs(x, y, delta, nugget)
    xs_t = torch.as_tensor(xs)
    mean_l, var_l = gp.predict(gp.fit(p, xt, yt, h), xt, h, xs_t,
                               basis_matrix(xs_t, linear_basis(3)))
    np.testing.assert_allclose(got["mean"], _np(mean_l), rtol=1e-12)
    np.testing.assert_allclose(got["var"], _np(var_l), rtol=1e-10,
                               atol=1e-14)
    xj, yj, hj, pj = _jax_fit_inputs(x, y, delta, nugget)
    hs = jbasis(jnp.asarray(xs), jlinear(3))
    mean_j, var_j = jps(jgp.fit(pj, xj, yj, hj), xj, hj, jnp.asarray(xs),
                        hs, _jax_mesh({"data": WORLD}))
    np.testing.assert_allclose(got["mean"], np.asarray(mean_j), rtol=1e-10)
    np.testing.assert_allclose(got["var"], np.asarray(var_j), rtol=1e-8,
                               atol=1e-12)


def test_mle_fit_restarts_over_ranks_match_jax(ranks):
    """Every rank gathers the same restarts and chooses the same best, and
    the best NLL is JAX's (each from its own LHC starts; the JAX package's
    own test holds its mesh fit to its one-device fit)."""
    import jax
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis
    from gp_emu_uqsa_tpu.basis import linear_basis as jlinear
    from gp_emu_uqsa_tpu.inference import MLEConfig as JCfg
    from gp_emu_uqsa_tpu.inference import mle_fit as jmle
    got = [_case(ranks, "mle", r) for r in range(WORLD)]
    for other in got[1:]:
        np.testing.assert_array_equal(other["nlls"], got[0]["nlls"])
        np.testing.assert_array_equal(other["iters"], got[0]["iters"])
        assert other["best"] == got[0]["best"] == got[0]["nlls"].min()
    x, y = _mle_problem()
    _, info = jmle(jax.random.key(0), x, y, jbasis(jnp.asarray(x),
                                                   jlinear(2)),
                   JCfg(tries=8, max_iters=MLE_ITERS))
    np.testing.assert_allclose(got[0]["best"], float(info["best_nll"]),
                               rtol=1e-8)


def test_a_failed_factor_gives_a_non_finite_nll_on_every_rank(ranks):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.parallel.large_fit import fit_large as jfit
    for r in range(WORLD):
        got = _case(ranks, "bad", r)
        assert got["gp.nll"] == np.inf
        assert got["recursive"] == np.inf and got["panel"] == np.inf
        assert got["panel_rows_nan"]
    x, y = _bad_problem()
    xj, yj, hj, pj = _jax_fit_inputs(x, y, 1.0, 0.0, np.float32)
    jst = jfit(pj, xj.astype(jnp.float32), yj.astype(jnp.float32),
               hj.astype(jnp.float32), _jax_mesh({"mr": WORLD}), block=32)
    assert not np.isfinite(float(jst.nll))
