from gp_emu_uqsa_torch.inference.lbfgs import MLEConfig, mle_fit
