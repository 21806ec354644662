"""request_p95_ms: the 95th percentile (linear interpolation) of every
completed request's latency in the window, from the call to both answers
on the host."""
import numpy as np


def read(run):
    lat = run.record["latencies_s"]
    return float(np.percentile(lat, 95) * 1e3) if lat else None
