"""serve_mfu_pct: the operations the window's requests need, each counted
once (counts/serve.py), over the window's seconds times the cards' TF32
peak (the top rate for float32 data)."""
from gpbench.counts import serve


def read(run):
    if run.peaks is None:
        return None
    rec = run.record
    ops = sum(serve.request_useful_flops(m, rec["n"], rec["d"], rec["q"])
              for m in rec["sizes"])
    return 100.0 * ops / (rec["window_s"] * run.chips * run.peaks["tf32"])
