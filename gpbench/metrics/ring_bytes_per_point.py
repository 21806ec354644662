"""ring_bytes_per_point: the bytes rank 0 sent through the mesh's
collectives in the window (`parallel.mesh.traffic`, computed from the
tensors' sizes), over the points served."""


def read(run):
    rec = run.record
    return rec["bytes_sent"] / rec["points"] if rec["points"] else None
