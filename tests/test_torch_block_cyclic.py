"""The 2-D block-cyclic Cholesky on four gloo ranks, held against JAX.

The ranks are spawned once for the module; each runs every case and
returns numpy arrays (fp64 unless a case says otherwise). The meshes are
the 2 x 2, 4 x 1 and 1 x 4 shapes of four ranks, at
tests/test_block_cyclic.py's sizes and tolerances. JAX is imported inside
the tests only.
"""
import os
import traceback

import numpy as np
import pytest
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.kernels import make_params
from gp_emu_uqsa_torch.ops.block_cyclic import (
    block_cyclic_cholesky, block_cyclic_rows, padded_size, to_block_cyclic,
)
from gp_emu_uqsa_torch.parallel import fit_large, make_mesh, spawn_ranks
from gp_emu_uqsa_torch.parallel.mesh import gather_rows, traffic

WORLD = 4
BLOCK = 32
SHAPES = [(256, (2, 2)), (200, (4, 1)), (96, (1, 4))]


def _spd(n, seed=0):
    m = np.random.default_rng(seed).standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


def _fit_problem(dtype=np.float64, n=72, seed=1):
    x = np.random.default_rng(seed).uniform(size=(n, 2)).astype(dtype)
    return x, (np.sin(3 * x[:, 0]) + x[:, 1]).astype(dtype)


def _torch_inputs(x, y, delta, nugget, dtype):
    xt, yt = torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype)
    h = basis_matrix(xt, linear_basis(2))
    p = make_params(np.full(2, delta), nugget=nugget, dtype=dtype,
                    device="cpu")
    return xt, yt, h, p


def _case_factor(n, shape):
    mesh = make_mesh({"mr": shape[0], "mc": shape[1]}, device_type="cpu")
    a = torch.as_tensor(_spd(n))
    blocks = to_block_cyclic(a, mesh, block=BLOCK)
    traffic.reset()
    l = block_cyclic_cholesky(blocks, mesh, block=BLOCK)
    sent = traffic.bytes
    rows = block_cyclic_rows(l, mesh)
    return {"l": gather_rows(rows, mesh, "mr", BLOCK)[:n, :n].numpy(),
            "sent": sent, "local": tuple(blocks.shape)}


def _case_fit(_):
    mesh = make_mesh({"mr": 2, "mc": 2}, device_type="cpu")
    x, y = _fit_problem()
    xt, yt, h, p = _torch_inputs(x, y, 0.6, 1e-4, torch.float64)
    st = fit_large(p, xt, yt, h, mesh, block=16, factorization="block2d")
    loc = gp.fit(p, xt, yt, h)
    xb, yb = _fit_problem(np.float32, n=120, seed=21)
    bad = _torch_inputs(xb, yb, 1.0, 0.0, torch.float32)
    return {"nll": float(st.nll), "beta": st.beta.numpy(),
            "sigma2": float(st.sigma2), "e": st.e.numpy(),
            "local": (float(loc.nll), loc.beta.numpy(), float(loc.sigma2),
                      loc.e.numpy()),
            "bad": float(fit_large(*bad[3:], *bad[:3], mesh, block=32,
                                   factorization="block2d").nll)}


def _cases(rank):
    os.nice(10)        # below the other test workers: their timing tests
    out = {}
    cases = {(n, shape): (lambda a=(n, shape): _case_factor(*a))
             for n, shape in SHAPES}
    cases["fit"] = lambda: _case_fit(rank)
    for name, case in cases.items():
        try:
            out[name] = case()
        except Exception:  # noqa: BLE001 - reported by the test of the case
            out[name] = RuntimeError(traceback.format_exc())
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


@pytest.mark.parametrize("n,shape", SHAPES)
def test_block_cyclic_matches_lapack_and_jax(ranks, n, shape):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.ops.block_cyclic import block_cyclic_cholesky as jbc
    got = [_case(ranks, (n, shape), r) for r in range(WORLD)]
    a = _spd(n)
    ref = np.linalg.cholesky(a)
    for g in got:
        np.testing.assert_allclose(g["l"], ref, rtol=1e-12, atol=1e-12)
    l_jax = np.asarray(jbc(jnp.asarray(a), _jax_mesh({"mr": shape[0],
                                                      "mc": shape[1]}),
                           block=BLOCK))
    np.testing.assert_allclose(got[0]["l"], l_jax, rtol=1e-12, atol=1e-12)
    # per-rank memory n_pad^2 / P: the local stack of blocks
    p_r, p_c = shape
    g = padded_size(n, BLOCK, p_r, p_c) // BLOCK
    assert got[0]["local"] == (g // p_r, g // p_c, BLOCK, BLOCK)


def test_block_cyclic_traffic_sends_only_the_gj_blocks_along_mr(ranks):
    """On 2 x 2, step k moves the diagonal block (B^2 words, one or two
    broadcasts), the panel along mc (G/P_r B^2 words from the owner
    column) and the gj blocks along mr (G/P_c B^2 words, all-reduced):
    summed over the ranks, no full (G, B, B) panel along mr."""
    g = 256 // BLOCK
    b2 = BLOCK * BLOCK * 8
    total = sum(_case(ranks, (256, (2, 2)), r)["sent"] for r in range(WORLD))
    diag = g * 3 * b2        # one source along mr, then one a row along mc
    panel = g * 2 * (g // 2) * b2                 # each row's owner column
    gj = g * WORLD * (g // 2) * b2                # all-reduce, 2(p-1)/p = 1
    flags = 2 * WORLD * 4                         # the failure flag
    print(f"2 x 2, n=256: {total} bytes sent by the 4 ranks")
    assert total == diag + panel + gj + flags


def test_fit_large_block2d_matches_gp_fit_and_jax(ranks):
    import jax.numpy as jnp
    from gp_emu_uqsa_tpu.basis import basis_matrix as jbasis
    from gp_emu_uqsa_tpu.basis import linear_basis as jlinear
    from gp_emu_uqsa_tpu.kernels import make_params as jmake
    from gp_emu_uqsa_tpu.parallel.large_fit import fit_large as jfit
    got = _case(ranks, "fit")
    nll, beta, sigma2, e = got["local"]
    np.testing.assert_allclose(got["beta"], beta, rtol=1e-9)
    np.testing.assert_allclose(got["sigma2"], sigma2, rtol=1e-9)
    np.testing.assert_allclose(got["nll"], nll, rtol=1e-9)
    np.testing.assert_allclose(got["e"], e, rtol=1e-6, atol=1e-8)
    x, y = _fit_problem()
    xj = jnp.asarray(x)
    st = jfit(jmake(np.full(2, 0.6), nugget=1e-4, dtype=jnp.float64), xj,
              jnp.asarray(y), jbasis(xj, jlinear(2)),
              _jax_mesh({"mr": 2, "mc": 2}), block=16,
              factorization="block2d")
    np.testing.assert_allclose(got["nll"], float(st.nll), rtol=1e-9)
    np.testing.assert_allclose(got["beta"], np.asarray(st.beta), rtol=1e-9)
    assert got["bad"] == np.inf
