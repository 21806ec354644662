"""K1's tile schedule and the build wrappers' arguments, in plain PyTorch on the CPU.

K1 (`csrc/corr_build.cu`) computes only the 64 x 64 tile pairs (I, J) with
I >= J and stores each at (I, J) and, transposed, at (J, I); it scales the
inputs and adds the nugget itself. `corr_self_tile_pairs` is its pair
index formula and `gaussian_corr_self_mirrored_plain` its schedule. Held
here: the schedule writes every entry once, the mirrored build is bitwise
the plain version and exactly symmetric, and it matches the JAX package's
`gaussian_corr_self_pallas` in interpret mode within
test_torch_kernels.py::test_k1_self_build_matches_pallas's tolerance
(rtol 2e-5, atol 2e-6). A nugget and a delta given as tensors give the
same result as Python numbers.
"""
import numpy as np
import pytest
import torch

from gp_emu_uqsa_tpu.ops.kernel_matrix import gaussian_corr_self_pallas

from gp_emu_uqsa_torch.ops import kernel_matrix as km

torch.set_num_threads(1)

T = torch.as_tensor
SIZES = [1, 63, 64, 65, 300, 513]


def _x(seed, n, d):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, d)).astype(np.float32),
            rng.uniform(0.4, 1.5, size=d).astype(np.float32))


@pytest.mark.parametrize("tiles", [1, 2, 3, 9, 256, 257])
def test_tile_pairs_are_the_lower_triangle_in_row_order(tiles):
    want = [(i, j) for i in range(tiles) for j in range(i + 1)]
    assert km.corr_self_tile_pairs(tiles * km.BUILD_TILE) == want


def test_tile_pair_formula_holds_past_float_precision():
    # the kernel's float square root is off by one here; the corrections
    # bring it back
    for i in (2047, 4095, 5792):
        first = i * (i + 1) // 2
        assert km.tile_pair(first - 1) == (i - 1, i - 1)
        assert km.tile_pair(first) == (i, 0)
        assert km.tile_pair(first + i) == (i, i)


@pytest.mark.parametrize("n", SIZES)
def test_schedule_writes_every_entry_once(n):
    tile = km.BUILD_TILE
    count = np.zeros((n, n), dtype=np.int64)
    for i, j in km.corr_self_tile_pairs(n):
        count[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] += 1
        if i != j:
            count[j * tile:(j + 1) * tile, i * tile:(i + 1) * tile] += 1
    np.testing.assert_array_equal(count, 1)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("d", [1, 5, 20])
def test_mirrored_build_is_bitwise_plain_and_symmetric(n, d):
    x, delta = _x(n + d, n, d)
    want = km.gaussian_corr_self_plain(T(x), T(delta), 1e-4)
    got = km.gaussian_corr_self_mirrored_plain(T(x), T(delta), 1e-4)
    assert torch.equal(got, want)
    assert torch.equal(got, got.T)


def test_mirrored_build_matches_pallas():
    x, delta = _x(0, 300, 5)
    want = np.asarray(gaussian_corr_self_pallas(x, delta, 1e-4,
                                                interpret=True))
    got = km.gaussian_corr_self_mirrored_plain(T(x), T(delta), 1e-4).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_tensor_nugget_and_delta_match_numbers():
    x, delta = _x(3, 130, 4)
    nugget = 1e-4
    by_number = km.gaussian_corr_self_fused(T(x), [float(v) for v in delta],
                                            nugget)
    for nu in (T(nugget, dtype=torch.float32), T([nugget], dtype=torch.float64)):
        assert torch.equal(km.gaussian_corr_self_fused(T(x), T(delta), nu),
                           by_number)
        assert torch.equal(
            km.gaussian_corr_self_mirrored_plain(T(x), T(delta), nu), by_number)
    x1 = x[:70]
    assert torch.equal(km.gaussian_corr_fused(T(x1), T(x), T(delta)),
                       km.gaussian_corr_fused(T(x1), T(x),
                                              [float(v) for v in delta]))


def test_wrapper_arguments_take_tensors_as_they_are():
    x = torch.zeros((10, 3))
    dl = torch.tensor([0.5, 1.0, 2.0])
    assert km._delta_arg(dl, x) is dl            # no copy, no launch
    assert torch.equal(km._delta_arg(0.5, x), torch.full((3,), 0.5))
    with pytest.raises(ValueError, match="delta has shape"):
        km._delta_arg(dl[:2], x)
    # a number, or a tensor on the CPU, goes by value
    assert km._nugget_arg(1e-4, x) == (None, 1e-4)
    nu, value = km._nugget_arg(torch.tensor(0.25), x)
    assert nu is None and value == 0.25
