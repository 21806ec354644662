"""k4_high_roofline_pct: K4 "high" (csrc/corr_quad.cu: the TF32 split of
W and the 3xTF32 triangular product) against its roofline: the least
time for the window's requests (counts/serve.py) over the device time of
its kernels in the trace."""
from gpbench.counts import serve
from gpbench.trace import seconds_of

KERNELS = ("corr_quad_tf32x3_kernel", "tf32_split_kernel")


def read(run):
    device_s = seconds_of(run.trace, KERNELS)
    if device_s <= 0 or run.peaks is None:
        return None
    rec = run.record
    least = sum(serve.least_seconds(*serve.k4_high(m, rec["n"], rec["d"]),
                                    run.peaks) for m in rec["sizes"])
    return 100.0 * least / device_s
