"""The ARD Matern 5/2 family on the port's serving tiers.

K3 and K4 take the correlation family as a template argument
(`csrc/common.cuh`); `ops/serve.py`'s wrappers and plain versions take
`family`, and `Emulator.predict` serves a matern52 emulator through the
fused tier. Here on the CPU (small sizes: n = 300, d = 8, m = 1000, seeded
data and delta) the fused tier's plain versions and the gemm tier are held
against the plain fp64 reference of the benchmark
(`gpbench/reference/gp_matern52.py`), the 3xTF32 arithmetic against fp64,
the Gaussian plain versions against their arithmetic before the family
argument, and the counters and the tier's span are checked. The `cuda`
cases hold the Matern instances of the kernels against their plain
versions on the card and skip elsewhere. No JAX: the JAX kernels are
Gaussian only.
"""
import dataclasses

import numpy as np
import pytest
import torch

from gpbench.reference import gp_matern52 as ref

from gp_emu_uqsa_torch import Emulator, gp
from gp_emu_uqsa_torch.kernels import make_params
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops import serve as tserve

T = torch.as_tensor
N, D, M = 300, 8, 1000
NUGGET = 1e-4
QUAD_HIGH_BUDGET = 4.7e-5          # docs/numerics.md, "high" tier on quad


def _data(seed=0, n=N, m=M, d=D):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(3 * x[:, 0]) + x[:, 1 % d] * x[:, 2 % d] + 0.1 * x.sum(1)
    xq = rng.uniform(size=(m, d))
    delta = rng.uniform(0.6, 1.4, size=d)
    return x, y, xq, delta


def _emulator(x, y, delta, family="matern52", dtype=torch.float64,
              device="cpu"):
    """An emulator of the family at fixed hyperparameters, fitted as the
    benchmark's serving drivers fit theirs."""
    emul = Emulator.from_arrays(
        x, y, tv_config=(1, 0, 0), shuffle=False, scale_inputs=False,
        kernel=family, nugget=NUGGET, dtype=dtype, device=device)
    emul.params = make_params(delta, nugget=NUGGET, dtype=dtype, device=device)
    emul.state = gp.fit(emul.params, *emul.train_view(), mode="mucm",
                        family=family)
    return emul


def _reference(x, y, xq, delta):
    """(mean, var, sigma2) of the fp64 reference, TF32 off."""
    with ref.precision(False):
        f = ref.fit(T(x), T(y), T(delta), NUGGET)
        mean, var = ref.predict(f, T(x), T(xq), T(delta))
    return mean.numpy(), var.numpy(), float(f.sigma2)


def _errors(mean, var, want):
    """The benchmark's numbers: mean_err over the largest reference mean,
    var_err over the reference's sigma2 (gpbench/drivers/serve_family.py)."""
    mean_r, var_r, sigma2 = want
    mean = np.asarray(mean, np.float64)
    var = np.asarray(var, np.float64)
    return (np.abs(mean - mean_r).max() / np.abs(mean_r).max(),
            np.abs(var - var_r).max() / sigma2)


@pytest.fixture(scope="module")
def problem():
    x, y, xq, delta = _data()
    return x, y, xq, delta, _reference(x, y, xq, delta)


def test_reference_is_the_port_correlation(problem):
    # the reference's c from its own equation and the port's family function
    # on the same fp64 distances
    x, _, xq, delta, _ = problem
    from gp_emu_uqsa_torch.kernels import CORR_FAMILIES
    d2 = km.sq_dists_plain(T(xq / delta), T(x / delta))
    np.testing.assert_allclose(
        ref.corr(T(xq), T(x), T(delta)).numpy(),
        CORR_FAMILIES["matern52"](d2).numpy(), rtol=1e-13, atol=1e-15)


def test_gemm_tier_matches_reference_fp64(problem):
    # fp64 on both sides: the gemm tier's products and the reference's
    # triangular solves differ only in rounding (about 1e-14 here)
    x, y, xq, delta, want = problem
    emul = _emulator(x, y, delta)
    mean, var = emul.predict(xq, serve="gemm")
    mean_err, var_err = _errors(mean, var, want)
    assert mean_err < 1e-11 and var_err < 1e-11, (mean_err, var_err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_tier_matches_reference(problem, dtype):
    """The fused tier's plain versions run K3 and K4 in fp32 (the fit too
    for the fp32 emulator, the card's configuration). Tolerances: mean_err
    and var_err, the benchmark's numbers, under 3e-5, ten times what fp32
    gives here (2e-6 to 3e-6 on both tiers), and far under the error of
    serving the wrong family (0.1 to 0.2, checked below)."""
    x, y, xq, delta, want = problem
    emul = _emulator(x, y, delta, dtype=dtype)
    assert emul._use_fused_serve("fused", M, D)
    mean, var = emul.predict(xq, serve="fused")
    mean_err, var_err = _errors(mean, var, want)
    assert mean_err < 3e-5 and var_err < 3e-5, (mean_err, var_err)
    # the same emulator served through the fp32 gemm tier agrees as closely
    if dtype == torch.float32:
        mean_g, var_g = emul.predict(xq, serve="gemm")
        assert max(_errors(mean_g, var_g, want)) < 3e-5


def test_fused_tier_serves_the_fit_family(problem):
    # the Gaussian in the fused tier for a Matern fit is far off
    x, y, xq, delta, want = problem
    emul = _emulator(x, y, delta)
    spred = emul._serving()
    xt, _, ht = emul.train_view()
    hs = emul._prepare_inputs(xq)[1]
    mean, var = tserve.serve_meanvar_batched(spred, xt, T(xq), hs,
                                             family="gaussian")
    assert max(_errors(mean, var, want)) > 1e-2


@pytest.mark.parametrize("batch", [131072, 256])
def test_serve_mean_takes_the_family(problem, batch):
    # the mean-only wrappers serve the family they are given: the fused
    # tier's tolerance from the reference with the fit's, far with another
    x, y, xq, delta, want = problem
    emul = _emulator(x, y, delta)
    xt, _, _ = emul.train_view()
    hs = emul._prepare_inputs(xq)[1]
    mean_r = want[0]
    for family, near in (("matern52", True), ("gaussian", False)):
        mean = tserve.serve_mean_batched(emul._serving(), xt, T(xq), hs,
                                         batch=batch, family=family).numpy()
        err = np.abs(mean - mean_r).max() / np.abs(mean_r).max()
        assert (err < 3e-5) == near, (family, err)


def test_tf32x3_plain_within_budget_of_fp64():
    # a Matern GP's own W (nugget 1e-2): quad = t^T A^-1 t in [0, 1], where
    # the "high" tier's budget is defined; fp64 arithmetic on the same fp32
    # W and c
    x, _, xq, delta = _data(seed=20, n=600, m=300, d=4)
    xd = x / delta
    c64 = ref.corr(T(xd), T(xd), T(np.ones(4)))
    a = c64 + 1e-2 * torch.eye(600, dtype=torch.float64)
    w = torch.linalg.inv(torch.linalg.cholesky(a)).float()
    args = (T(xq, dtype=torch.float32), T(x, dtype=torch.float32),
            T(delta, dtype=torch.float32), w)
    got = tserve.corr_quad_tf32x3_plain(*args, family="matern52").numpy()
    c = tserve.corr_plain(*tserve._scaled(*args[:3]), "matern52").double()
    u = c @ torch.tril(w.double()).T
    want = torch.sum(u * u, dim=1).numpy()
    assert 0.0 < want.max() <= 1.0 + 1e-4
    err = np.abs(got - want).max()
    assert err <= QUAD_HIGH_BUDGET, err


def _gaussian_before(xq, x, delta):
    """The Gaussian plain versions' correlation before the family argument."""
    return km.sq_exp_plain(*tserve._scaled(xq, x, delta))


def test_gaussian_plain_versions_unchanged():
    x, _, xq, delta = _data(seed=3, n=600, m=150, d=4)
    rng = np.random.default_rng(4)
    xq, x, delta = (T(v, dtype=torch.float32) for v in (xq, x, delta))
    rhs = T(rng.standard_normal((600, 10)), dtype=torch.float32)
    w = torch.tril(T(rng.standard_normal((600, 600)), dtype=torch.float32))
    c = _gaussian_before(xq, x, delta)
    torch.testing.assert_close(tserve.corr_matvec_plain(xq, x, delta, rhs),
                               c @ rhs, rtol=0, atol=0)
    u = c @ w.T
    torch.testing.assert_close(tserve.corr_quad_plain(xq, x, delta, w),
                               torch.sum(u * u, dim=1), rtol=0, atol=0)
    c_hi, c_lo = tserve.tf32_split(c)
    w_hi, w_lo = tserve.tf32_split(w)
    u3 = c_hi @ w_hi.T + c_hi @ w_lo.T + c_lo @ w_hi.T
    torch.testing.assert_close(tserve.corr_quad_tf32x3_plain(xq, x, delta, w),
                               torch.sum(u3 * u3, dim=1), rtol=0, atol=0)
    # the ordered forms: the default family is the explicit Gaussian
    for fn, extra in ((tserve.corr_matvec_segmented_plain, (rhs, 2)),
                      (tserve.corr_quad_split_plain, (w, 2))):
        torch.testing.assert_close(fn(xq, x, delta, *extra),
                                   fn(xq, x, delta, *extra, "gaussian"),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("form", ["segmented", "split"])
def test_ordered_plain_versions_take_the_family(form):
    # K3's segments and K4 "highest"'s splits reorder a sum of the same
    # Matern terms: fp32 reorderings of one value
    x, _, xq, delta = _data(seed=5, n=600, m=150, d=4)
    rng = np.random.default_rng(6)
    xq, x, delta = (T(v, dtype=torch.float32) for v in (xq, x, delta))
    if form == "segmented":
        rhs = T(rng.standard_normal((600, 10)) / 25, dtype=torch.float32)
        got = tserve.corr_matvec_segmented_plain(xq, x, delta, rhs, 3,
                                                 "matern52")
        want = tserve.corr_matvec_plain(xq, x, delta, rhs, "matern52")
    else:
        w = torch.tril(T(rng.standard_normal((600, 600)) / 25,
                         dtype=torch.float32))
        got = tserve.corr_quad_split_plain(xq, x, delta, w, 2, "matern52")
        want = tserve.corr_quad_plain(xq, x, delta, w, "matern52")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    gauss = tserve.corr_quad_plain(xq, x, delta, torch.eye(600), "gaussian")
    assert not torch.allclose(
        gauss, tserve.corr_quad_plain(xq, x, delta, torch.eye(600),
                                      "matern52"), rtol=1e-2)


def test_wrappers_refuse_a_family_without_a_kernel():
    x, _, xq, delta = _data(seed=7, n=40, m=10, d=3)
    xq, x, delta = (T(v, dtype=torch.float32) for v in (xq, x, delta))
    with pytest.raises(ValueError, match="families"):
        tserve.corr_quad(xq, x, delta, torch.eye(40), family="matern32")
    with pytest.raises(ValueError, match="families"):
        tserve.corr_matvec(xq, x, delta, torch.ones(40), family="exponential")


def _spans(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events() if e.name.startswith("gp.serve.")}


@pytest.mark.parametrize("family, serve, span", [
    ("matern52", "fused", "gp.serve.fused.matern52"),
    ("matern52", "gemm", "gp.serve.gemm.matern52"),
    ("gaussian", "fused", "gp.serve.fused.gaussian"),
    ("matern32", "fused", "gp.serve.gemm.matern32"),
    ("exponential", "auto", "gp.serve.gemm.exponential"),
])
def test_tier_span_and_counters(family, serve, span):
    """The tier's span names the tier that served and the fit's family; on
    the CPU the plain versions launch nothing, so no counter moves."""
    x, y, xq, delta = _data(seed=8, n=64, m=32, d=3)
    emul = _emulator(x, y, delta, family=family)
    before = {name: (fn.launches, dict(fn.family_launches),
                     dict(fn.family_pairs))
              for name, fn in (("k3", tserve.corr_matvec),
                               ("k4", tserve.corr_quad))}
    assert _spans(lambda: emul.predict(xq, serve=serve)) == {span}
    assert _spans(lambda: emul.predict(xq[:4], full_cov=True)) == {
        f"gp.serve.full.{family}"}
    for name, fn in (("k3", tserve.corr_matvec), ("k4", tserve.corr_quad)):
        assert (fn.launches, fn.family_launches, fn.family_pairs) == before[name]
        assert set(fn.family_launches) == set(tserve.FAMILIES)


# ----- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _gp_factor_on(x, delta, nugget, device):
    """W = L^-1 of the Matern correlation matrix of x, fp64 on `device`,
    fp32 out."""
    x64 = T(x, dtype=torch.float64, device=device)
    a = ref.corr(x64, x64, T(delta, dtype=torch.float64, device=device))
    a.diagonal().add_(nugget)
    eye = torch.eye(len(x), dtype=torch.float64, device=device)
    l = torch.linalg.cholesky(a)
    return torch.linalg.solve_triangular(l, eye, upper=False).float()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 20])
@pytest.mark.parametrize("n", [129, 4097])
def test_cuda_matern52_kernels_match_plain(cuda_device, n, d):
    """Each Matern instance against its plain version (the tolerances of
    test_torch_kernels.py's Gaussian cases: the same fp32 terms summed in
    other orders, or, for "high", the same TF32 operands), with ragged m
    and n, a query on a training point (d2 = 0, c = 1), and the counters:
    one launch and m n pairs a call, by family."""
    x, _, xq, delta = _data(seed=30 + n + d, n=n, m=1025, d=d)
    xq[0] = x[n // 2]
    w = _gp_factor_on(x, delta, 1e-2, cuda_device)
    x, xq, delta = (T(v, dtype=torch.float32, device=cuda_device)
                    for v in (x, xq, delta))
    rhs = torch.randn((n, 10), generator=torch.Generator().manual_seed(n),
                      dtype=torch.float32).to(cuda_device) / n ** 0.5
    for m in (1, 129, 1025):
        q = xq[:m]
        k3 = (tserve.corr_matvec.family_launches["matern52"],
              tserve.corr_matvec.family_pairs["matern52"],
              tserve.corr_matvec.family_launches["gaussian"])
        got = tserve.corr_matvec(q, x, delta, rhs, family="matern52")
        assert (tserve.corr_matvec.family_launches["matern52"],
                tserve.corr_matvec.family_pairs["matern52"],
                tserve.corr_matvec.family_launches["gaussian"]) == (
                    k3[0] + 1, k3[1] + m * n, k3[2])
        torch.testing.assert_close(
            got, tserve.corr_matvec_plain(q, x, delta, rhs, "matern52"),
            rtol=3e-5, atol=3e-5, msg=lambda s: f"K3 m={m}: {s}")
        for tier, plain, tol in (
                ("highest", tserve.corr_quad_plain, (5e-4, 5e-5)),
                ("high", tserve.corr_quad_tf32x3_plain, (5e-4, 5e-5))):
            before = tserve.corr_quad.family_pairs["matern52"]
            got = tserve.corr_quad(q, x, delta, w, quad_precision=tier,
                                   family="matern52")
            assert tserve.corr_quad.family_pairs["matern52"] == before + m * n
            torch.testing.assert_close(
                got, plain(q, x, delta, w, "matern52"), rtol=tol[0],
                atol=tol[1], msg=lambda s: f"K4 {tier} m={m}: {s}")


@pytest.mark.cuda
@pytest.mark.parametrize("family, fused", [("matern52", True),
                                           ("matern32", False),
                                           ("exponential", False)])
def test_cuda_emulator_serves_matern52_on_the_fused_tier(cuda_device, family,
                                                         fused):
    """An fp32 emulator on the card with m >= 1024 queries: matern52 takes
    K3 and K4 "high" through `Emulator.predict`, the other families the
    gemm tier; both within the reference's reach."""
    x, y, xq, delta = _data(seed=40, n=1000, m=2048, d=8)
    emul = _emulator(x, y, delta, family=family, dtype=torch.float32,
                     device=cuda_device)
    k3 = tserve.corr_matvec.family_launches.get(family, 0)
    k4 = tserve.corr_quad.family_launches.get(family, 0)
    mean, var = emul.predict(xq)
    assert tserve.corr_matvec.family_launches.get(family, 0) == k3 + fused
    assert tserve.corr_quad.family_launches.get(family, 0) == k4 + fused
    if family == "matern52":
        want = _reference(x, y, xq, delta)
        assert max(_errors(mean.cpu(), var.cpu(), want)) < 1e-3
