"""evals_per_draw: batched log-density evaluations (leaves and the start
of each transition, the sampler's `new_counts`) over the transitions a
chain made in the window."""


def read(run):
    c = run.record["counts"]
    if not c.get("transitions"):
        return None
    return c["evaluations"] / c["transitions"]
