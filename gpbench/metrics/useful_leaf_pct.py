"""useful_leaf_pct: the chain-leaves of chains still building their
subtree, over all chain-leaves evaluated in lockstep (the sampler's
`new_counts`), in the window."""


def read(run):
    c = run.record["counts"]
    if not c.get("chain_leaves"):
        return None
    return 100.0 * c["useful_chain_leaves"] / c["chain_leaves"]
