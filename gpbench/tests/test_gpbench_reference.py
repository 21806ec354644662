"""The reference agrees with the port on the CPU at tiny sizes, in float64
(this test imports both; the reference itself imports nothing of the
port)."""
import numpy as np
import pytest
import torch

from gp_emu_uqsa_torch import gp
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.inference import MLEConfig
from gp_emu_uqsa_torch.inference.hmc import make_gp_logdensity, value_and_grad
from gp_emu_uqsa_torch.inference.nuts import NutsDraws, _nuts_transition
from gp_emu_uqsa_torch.kernels import make_params
from gpbench.reference import data
from gpbench.reference import gp as ref
from gpbench.reference import nuts as ref_nuts

N, D, NUGGET = 96, 3, 1e-4
CONFIG = {"n": N, "d": D, "dtype": "float64", "data": {"sum_coef": 0.1}}


@pytest.fixture(scope="module")
def problem():
    torch.manual_seed(0)
    x, y = data.training_set(CONFIG, 7, "cpu")
    return x, y, basis_matrix(x, linear_basis(D))


def test_data_repeat_from_the_seed():
    a = data.training_set(CONFIG, 2 ** 31 + 5, "cpu")
    b = data.training_set(CONFIG, 2 ** 31 + 5, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_corr_from_differences(problem):
    x = problem[0]
    delta = torch.tensor([0.5, 0.8, 1.3], dtype=torch.float64)
    want = torch.exp(-(((x[:, None, :] - x[None, :, :]) / delta) ** 2).sum(-1))
    torch.testing.assert_close(ref.corr(x, x, delta), want, rtol=0, atol=1e-15)


def test_posterior_matches_the_port(problem):
    x, y, h = problem
    delta = torch.tensor([0.5, 0.8, 1.3], dtype=torch.float64)
    params = make_params(delta.numpy(), nugget=NUGGET, dtype=torch.float64,
                         device="cpu")
    state = gp.fit(params, x, y, h)
    rng = np.random.default_rng(1)
    xs = torch.as_tensor(rng.uniform(size=(50, D)))
    mean_p, var_p = gp.predict(state, x, h, xs, basis_matrix(xs, linear_basis(D)))
    f = ref.fit(x, y, delta, NUGGET)
    mean_r, var_r = ref.predict(f, x, xs, delta, block=16)
    mean_w, var_w = ref.whitened_predict(f, x, xs, delta, block=16)
    for mean, var in ((mean_r, var_r), (mean_w, var_w)):
        torch.testing.assert_close(mean, mean_p, rtol=1e-9, atol=1e-9)
        torch.testing.assert_close(var, var_p, rtol=1e-7, atol=1e-9)
    torch.testing.assert_close(f.sigma2, state.sigma2, rtol=1e-10, atol=0)


def test_nll_and_gradient_match_the_port(problem):
    x, y, h = problem
    z = torch.tensor([[-0.5, 0.1, 0.4], [0.2, -0.3, 0.0]], dtype=torch.float64)
    ld = make_gp_logdensity(x, y, h, MLEConfig(mode="mucm", nugget=NUGGET))
    v_p, g_p = value_and_grad(ld, z)
    v_r, g_r = ref.logdensity_and_grad(z, x, y, NUGGET)
    torch.testing.assert_close(v_r, v_p, rtol=1e-10, atol=1e-8)
    torch.testing.assert_close(g_r, g_p, rtol=1e-7, atol=1e-8)


def test_nuts_transition_matches_the_port(problem):
    x, y, h = problem
    ld = make_gp_logdensity(x, y, h, MLEConfig(mode="mucm", nugget=NUGGET))
    gen = torch.Generator().manual_seed(3)
    chains, depth = 6, 5
    z0 = 0.3 * torch.randn((chains, D), generator=gen, dtype=torch.float64)
    r0 = torch.randn((chains, D), generator=gen, dtype=torch.float64)
    u = torch.rand((chains, depth, 2 + (1 << (depth - 1))), generator=gen,
                   dtype=torch.float64)
    eps = torch.tensor(0.02, dtype=torch.float64)
    inv_mass = torch.tensor([0.3, 1.0, 2.0], dtype=torch.float64)
    draws = NutsDraws(r0, u[:, :, 0] < 0.5, u[:, :, 1], u[:, :, 2:])
    z_p, _, _ = _nuts_transition(lambda z: value_and_grad(ld, z), z0, draws,
                                 eps, inv_mass, depth, 1000.0)
    z_r = ref_nuts.transition(
        lambda z: ref.logdensity_and_grad(z, x, y, NUGGET), z0, r0,
        u[:, :, 0] < 0.5, u[:, :, 1], u[:, :, 2:], eps, inv_mass, depth)
    assert int((z_p != z0).any(-1).sum()) >= chains // 2
    torch.testing.assert_close(z_r, z_p, rtol=1e-8, atol=1e-9)
