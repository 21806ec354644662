"""serve_m52_mfu_pct: the operations the window's Matern 5/2 requests need,
each counted once with the Matern rebuild (counts/serve_matern52.py), over
the window's seconds times the cards' TF32 peak (the top rate for float32
data)."""
from gpbench.counts import serve_matern52 as counts


def read(run):
    if run.peaks is None:
        return None
    rec = run.record
    ops = sum(counts.request_useful_flops(m, rec["n"], rec["d"], rec["q"])
              for m in rec["sizes"])
    return 100.0 * ops / (rec["window_s"] * run.chips * run.peaks["tf32"])
