"""draws_per_s: post-warmup draws of all chains completed in the window,
over the window's seconds (the segment running at the deadline finished
and counted with its time)."""


def read(run):
    rec = run.record
    return rec["draws"] / rec["window_s"] if rec["draws"] else None
