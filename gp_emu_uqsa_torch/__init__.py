"""gp_emu_uqsa_torch — the GP emulation engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of `gp_emu_uqsa_tpu` (the JAX package, which stays the reference):
same module and function names, plain PyTorch around four kernels written
for `sm_90a`. It carries the training path (config files, multi-restart
maximum likelihood with the analytic adjoint, validation, written beliefs),
the serving path (refit at fixed hyperparameters, mean and variance,
validation against held-out sets), the UQSA path (`sensitivity`,
`multi.MultiEmulator`, `design_inputs.optLatinHyperCube`, `plot`), the
samplers, the matrix-free path, the noise fit, and the multi-device path
(`parallel`: SPMD over torch.distributed ranks).

    import gp_emu_uqsa_torch as g
    emul = g.setup("toy-sim_config", device="cuda", dtype=torch.float32)
    g.train(emul)
    mean, var = emul.predict(x_new)

    emul = g.load_emulator("ckpt", device="cuda", dtype=torch.float32)

    import gp_emu_uqsa_torch.sensitivity as s
    sens = s.setup(emul, m=[0.5] * d, v=[0.02] * d)
    sens.sensitivity(); sens.totaleffectvariance(); sens.uncertainty()

Entry points run on the CUDA card unless given device="cpu"; without a
card they raise. The package imports neither jax nor gp_emu_uqsa_tpu.
"""
from gp_emu_uqsa_torch.emulator import Emulator, final_build, setup, train
from gp_emu_uqsa_torch.configs import Beliefs, Config
from gp_emu_uqsa_torch.kernels import GPParams, make_params, params_from_numpy
from gp_emu_uqsa_torch.basis import BasisSpec, basis_matrix, linear_basis, const_basis
from gp_emu_uqsa_torch.inference import MLEConfig, mle_fit
from gp_emu_uqsa_torch.utils.checkpoint import load_emulator, save_emulator
from gp_emu_uqsa_torch.plotting import plot
from gp_emu_uqsa_torch import gp

__version__ = "0.1.0"

__all__ = [
    "Emulator", "Beliefs", "Config", "GPParams", "make_params",
    "params_from_numpy", "BasisSpec", "basis_matrix", "linear_basis",
    "const_basis", "MLEConfig", "mle_fit", "load_emulator", "save_emulator",
    "gp", "setup", "train", "final_build", "plot",
]
