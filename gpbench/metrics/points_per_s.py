"""points_per_s: mean-and-variance points completed in the window, over
the window's seconds (the last request, finished after the deadline,
counted with its time)."""


def read(run):
    rec = run.record
    return rec["points"] / rec["window_s"] if rec["window_s"] > 0 else None
