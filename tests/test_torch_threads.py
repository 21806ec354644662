"""One BLAS/OpenMP thread for every test process, set once here.

Under `-n 6` each xdist worker otherwise runs numpy's OpenBLAS, scipy's and
torch's OpenMP pools sized for the whole machine, and their waits spin: six
concurrent copies of tests/test_fp32.py then finish 1 of their 7 tests in
240 s, and all 7 in about 66 s capped (PERF.md "Tier-1").

Under `--dist loadfile` every worker imports every test module at
collection, before any test runs, so the module-level caps below reach every
worker. Libraries already loaded are capped through threadpoolctl; those
loaded later, `spawn_ranks` ranks and subprocess tests read the environment.
A value the caller gives wins.
"""
import os

import threadpoolctl
import torch

# OMP_NUM_THREADS caps libgomp, and with it torch's intra-op pool.
os.environ.setdefault("OMP_NUM_THREADS", "1")
# OPENBLAS_NUM_THREADS caps numpy's and scipy's OpenBLAS whatever OMP says.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
threadpoolctl.threadpool_limits({
    "openmp": int(os.environ["OMP_NUM_THREADS"]),
    "blas": int(os.environ["OPENBLAS_NUM_THREADS"]),
})
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


def test_each_worker_runs_one_blas_and_openmp_thread():
    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert os.environ["OPENBLAS_NUM_THREADS"] == "1"
    assert torch.get_num_threads() == 1
    pools = threadpoolctl.threadpool_info()
    assert any(p["user_api"] == "blas" for p in pools)
    assert all(p["num_threads"] == 1 for p in pools), pools
    assert "--xla_force_host_platform_device_count=8" in os.environ["XLA_FLAGS"]
