"""k3_m52_roofline_pct: the Matern 5/2 instance of K3 (csrc/corr_matvec.cu,
`corr_matvec_kernel<10, gpemu::Matern52>` and the fold of its segments; r =
1 + q right-hand sides) against its roofline: the least time for the
window's requests (counts/serve_matern52.py) over the device time of those
kernels in the trace. None where the trace holds no Matern 5/2 instance."""
from gpbench.counts import serve_matern52 as counts


def read(run):
    device_s = counts.family_seconds(run.trace, "corr_matvec_kernel",
                                     ("matvec_combine_kernel",))
    if device_s <= 0 or run.peaks is None:
        return None
    rec = run.record
    least = 0.0
    for m in rec["sizes"]:
        ops, moved = counts.k3(m, rec["n"], rec["d"], 1 + rec["q"])
        least += counts.least_seconds(ops, 0.0, moved, run.peaks)
    return 100.0 * least / device_s
