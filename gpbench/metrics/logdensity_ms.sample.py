"""logdensity_ms.sample: one batched value and gradient of the log density
over all chains at their last positions, CUDA events, median of 5 after
the traced window."""


def read(run):
    return run.layer.get("logdensity_ms")
