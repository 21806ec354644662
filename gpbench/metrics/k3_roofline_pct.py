"""k3_roofline_pct: K3 (csrc/corr_matvec.cu, r = 1 + q right-hand sides:
the mean and the R-term's cross product) against its roofline: the least
time for the window's requests (counts/serve.py) over the device time of
its kernels in the trace."""
from gpbench.counts import serve
from gpbench.trace import seconds_of

KERNELS = ("corr_matvec_kernel", "matvec_combine_kernel")


def read(run):
    device_s = seconds_of(run.trace, KERNELS)
    if device_s <= 0 or run.peaks is None:
        return None
    rec = run.record
    least = 0.0
    for m in rec["sizes"]:
        ops, moved = serve.k3(m, rec["n"], rec["d"], 1 + rec["q"])
        least += serve.least_seconds(ops, 0.0, moved, run.peaks)
    return 100.0 * least / device_s
