"""The multi-device path on torch.distributed (SPMD, one process a rank).

Port of `gp_emu_uqsa_tpu.parallel`: `init_multihost` and, for
command-line entry points, `process_group` (`runtime`), `make_mesh` with
`shard_rows` / `gather_rows` in place of the JAX package's `sharded` /
`replicated` shardings (`mesh`), `predict_sharded`, `fit_large`,
`predictor_large` and `ring_predict`.
"""
from gp_emu_uqsa_torch.parallel.runtime import (
    init_multihost, process_group, spawn_ranks,
)
from gp_emu_uqsa_torch.parallel.mesh import gather_rows, make_mesh, shard_rows
from gp_emu_uqsa_torch.parallel.predict import predict_sharded
from gp_emu_uqsa_torch.parallel.large_fit import fit_large, predictor_large
from gp_emu_uqsa_torch.parallel.ring import ring_predict
from gp_emu_uqsa_torch.parallel.sharded_gp import build_corr_sharded
