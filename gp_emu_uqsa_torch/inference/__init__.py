from gp_emu_uqsa_torch.inference.lbfgs import MLEConfig, mle_fit
from gp_emu_uqsa_torch.inference.hmc import (
    HMCConfig, hmc_continue, hmc_sample, make_gp_logdensity,
    predict_marginalized,
)
from gp_emu_uqsa_torch.inference.nuts import nuts_continue, nuts_sample
