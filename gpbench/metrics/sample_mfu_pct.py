"""sample_mfu_pct: the operations of the window's chain evaluations (the
sampler's batched evaluations times its chains, times counts/mucm.py's
value and gradient) over the window's seconds times the card's TF32
peak."""
from gpbench.counts import mucm


def read(run):
    return mucm.mfu_pct(run.record, run.peaks, run.chips)
