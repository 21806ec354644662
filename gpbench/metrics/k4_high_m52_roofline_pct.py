"""k4_high_m52_roofline_pct: the Matern 5/2 instance of K4 "high"
(csrc/corr_quad.cu: `corr_quad_tf32x3_kernel<gpemu::Matern52>` and the
TF32 split of W that feeds it) against its roofline: the least time for the
window's requests (counts/serve_matern52.py) over the device time of those
kernels in the trace. None where the trace holds no Matern 5/2 instance."""
from gpbench.counts import serve_matern52 as counts


def read(run):
    device_s = counts.family_seconds(run.trace, "corr_quad_tf32x3_kernel",
                                     ("tf32_split_kernel",))
    if device_s <= 0 or run.peaks is None:
        return None
    rec = run.record
    least = sum(counts.least_seconds(*counts.k4_high(m, rec["n"], rec["d"]),
                                     run.peaks) for m in rec["sizes"])
    return 100.0 * least / device_s
