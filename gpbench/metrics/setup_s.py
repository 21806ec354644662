"""setup_s: process start to the window's start (host clock): imports,
the data, the system's set-up and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
