"""device_idle_pct.sample: the share of the traced window in which no
operation ran on the device (`trace.idle_pct`), in the sample cells."""
from gpbench.trace import idle_pct


def read(run):
    return idle_pct(run.trace)
