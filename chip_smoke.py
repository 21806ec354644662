#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gp_emu_uqsa_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
PyTorch built for CUDA and the CUDA toolkit (nvcc). Imports no JAX. Phases,
each of which fails the run with a non-zero exit:

1. Print the card's name and power limit (nvidia-smi); build the CUDA
   kernels from `gp_emu_uqsa_torch/csrc/` and print the build time, and
   ptxas's registers and spills and the launch plan of the K1/K2 bodies.
2. Hold each kernel (K1-K4) against its plain PyTorch version on the card at
   the serving path's shapes, with the tolerances of
   tests/test_pallas_kernels.py; time each kernel two ways, its C entry
   point alone on preallocated buffers (CUDA events around 20 back-to-back
   launches: `ms`) and through its wrapper (median: `wrapper_ms`), time the
   plain version, and compute the bound from the same shapes. K1 and K2 are
   held bit for bit (K1 also exactly symmetric) at n=16384 and at K2's three
   served shapes (1000 x 16384, 256 x 16384, 256 x 256), and at ragged
   shapes (K1 at n in {513, 16383}, K2 at 257 x 16383, d in {1, 20}); K1 is
   timed beside fill_(1.0) of its output, what the card's store path gives.
   The K1 and K2 wrappers, with delta and the nugget as tensors on the card,
   run under torch.cuda.set_sync_debug_mode("error") (a host sync fails
   the run), and the profiler counts the kernels each call runs (one).
   K4 is held and timed
   per precision tier ("highest": exact fp32 on the CUDA cores; "high":
   3xTF32 on the tensor cores) at the serving request m=65536, against the
   plain version and an fp64 evaluation of the same W and c; "high" also
   against its own arithmetic in plain PyTorch on the first and last 4096
   queries. It is timed beside cuBLAS doing the same contraction as one
   fp32 product, and the error of the products' split alone is printed for
   3xTF32 and for the JAX package's bf16x3. K3 and K4 "highest" are also
   held against their plain versions at ragged shapes that hit the edges of
   their tiles (m=4097, n=16383, d in {1, 20}; K3 with r in {1, 10, 17,
   33}), and K4 "highest" is timed at the m=4096 request with its factor
   tiles split over blocks (as served) and unsplit.
3. Serve at full width (BASELINE config 5 on one card, the data of
   bench.py::_problem: seed 0, d=8, delta 0.8, nugget 1e-4, linear basis,
   fp32): save a trained emulator with n=16384 training rows and one
   256-row V-set, `load_emulator` it on the card (refit: K1, Cholesky,
   jitter ladder), answer requests through `Emulator.predict` (m=1000 on
   the gemm tier, m=65536 twice on the fused tier with K4 "high",
   full_cov at m=256) and `validate_against(0)`, with every launch counter
   set to 0 before that run and read after it. Then, in a launch window of
   its own, one request of m=4096 on the fused tier with K4 "highest".
   Check the results, the fused tier against the gemm tier, the two K4
   tiers against each other, and a small fp32 card run against the fp64
   CPU path.
4. Train at full width (n=4096, d=8, fp32, 8 restarts, data of
   `problem`), every check collected and failing the phase at its end:
   (a) the batched value and gradient of nll_mucm at the 8 LHC starts (K1,
   the analytic adjoint) against the same code in fp64 on the card, within
   budgets set by each restart's kappa(A) and capped, beside a TF32
   backward that the budgets must reject, and the adjoint against
   autograd in fp64; one evaluation's breakdown (torch.profiler: K1,
   Cholesky, solves, products, the rest, the host gap), K1 alone and its
   wrapper's host time at the fit size; (b) the same for nll_gp4ml
   (autograd); (c)
   Emulator.from_arrays -> train (8 L-BFGS iterations an optimize, one
   256-row V-set, so validation runs K2), timed per optimize, iteration
   and evaluation, its launches counted in a window of their own, the
   final NLL against fp64; (d) fit(refine=1) and a refined solve against
   fp64 solves (tests/test_fp32.py's n=4096 budgets); (e) one evaluation at
   n=16384 against fp64, with the breakdown; (f) the jitter ladder per
   restart, card against CPU, no NaN; (g) setup -> train -> final_build
   on a copy of examples/toy-sim in a temporary directory.
5. The UQSA path, every check collected and failing the phase at its end:
   (a) sensitivity.setup and the indices (uncertainty, sensitivity,
   totaleffectvariance, main and interaction effects) of phase 3's
   emulator in fp32 and fp64, each step timed with its peak memory; fp32
   held against fp64 per quantity under budgets set by kappa(A), at the
   serving nugget and at larger ones, beside two controls (the JAX
   package's Gram-product log rho; every UQSA product in TF32, which must
   break a held budget) and fp32 with A^-1 formed in fp64; a miss where a
   budget reaches its cap is printed as a finding; (b) BASELINE config 3
   (examples/synthetic-10d/run_10d.py: optLatinHyperCube -> fp64
   train_full -> setup) against tests/oracle.py at rtol 1e-8, the oracle
   run in worker processes while (a) and (c) use the card; (c) a
   3-output MultiEmulator fit at n=4096 (K1), its NLL at the starts and
   at the fitted parameters against the single-output objective, the fit
   and a single-output fit again in fp64 (the batched rows must end where
   output 0's restarts end alone), sense_matrix and a prediction (K2),
   every launch of the phase counted.
6. The Bayesian path, every check collected and failing the phase at its
   end: (a) BASELINE config 4 (gp_test_posterior(1024, 8), fp32, 64
   chains; tools/long_chain.py's settings): the batched log density and
   gradient at the starts against fp64 within phase 4's kappa(A) budgets
   beside the TF32-backward control; nuts_sample with 24 warmup draws at
   max depth 4, then 4 nuts_continue segments of 8 draws at max depth 5,
   the chain state through save_hmc_state/load_hmc_state between them and
   one segment rerun from its checkpoint bit for bit; draws/s, ms a
   batched leapfrog, ESS, split R-hat, accept and divergence rates, tree
   depth, host syncs and useful chain-leaves a draw, the window's
   launches, one evaluation's breakdown; a short hmc_sample run (printed,
   not held); (b) NUTS on a d=2 posterior at n=512 (fp32, K1) within 5
   Monte-Carlo standard errors of a quadrature of the same log density;
   (c) one NUTS and one HMC transition from the same draws on the card and
   the CPU (fp64, rtol 1e-10, flags and leaf counts equal); (d)
   Emulator.train_bayes -> predict_bayes at m=4096 (K2) against the same
   draws in fp64, and sample_posterior's moments against predict's; (e)
   utils.sampler_compare.compare with a tiny budget.
7. The matrix-free path and the noise fit, every check collected and
   failing the phase at its end: (a) at n=16384 (examples/matrix-free's
   simulator and data rule, d=2, fp32), make_corr_matvec through K3 at
   r=12 and r=8 (one launch each, against the chunked plain matvec and
   against K3 with one segment, an exact self diagonal) and K2's
   gradient-pass blocks against the plain build,
   nll_and_grad_matrix_free (PCG on K3, the gradient pass on K2) against
   gp.nll_mucm and its gradient in fp64 with tests/test_matrix_free.py's
   bounds at nugget 1e-2, against the
   same estimator in fp64 from the same probes at the fp32 nugget floor
   0.25 eps32 n (4.9e-4; printed at 1e-4), fit_matrix_free ->
   predict_mean_matrix_free against gp.fit -> gp.predict in fp64 within a
   kappa(A) budget; (b) the example's workflow at n=131072, past the
   dense path's memory wall (an fp32 subset MLE at n=2048 on K1, 5 Adam
   steps of mle_fit_matrix_free at the fp32 nugget floor 0.25 eps32 n =
   3.9e-3, not the example's 1e-4, fit_matrix_free, the mean at
   m=65536), in a launch window of its own: the NLL trace finite,
   every CG column at its tolerance, the fit's true residual (A in fp64)
   within a kappa(A) eps32 budget, the mean's RMSE against the noiseless
   simulator, the peak memory far below one dense A; then the (a) checks
   of K3 and K2 at this n and K3 at the mean's m=65536, r=1; the Adam
   start's fp32 gradient against the fp64 estimator from the same probes,
   and the fp64 NLL at both ends of the steps; K3's time at r=12 and r=8,
   CG iterations and host syncs, an evaluation split into CG, SLQ and the
   gradient pass, the host gap of a PCG iteration; (c)
   noisefit_arrays at n=1024, d=8, fp64 (the noise ramp recovered, each
   end within a band of the truth; s an iteration, s and objective calls
   an mle_fit, one data-GP evaluation's profile); (d) noisefit_arrays card
   against CPU with the CPU run's fits replayed; (e) noisefit on a copy of
   examples/noise-fit; (f) roofline.measure, utils.timing.timed on K1
   against phase 2, sanitize.checked_fit, tiny measure_hmc/measure_nuts.
8. The multi-device path (`gp_emu_uqsa_torch.parallel`), every check
   collected and failing the phase at its end: (a) one rank over NCCL on a
   localhost store (world size 1, the collectives issued on CUDA
   tensors) at BASELINE config 5's width, n=16384, through
   `tools/multi_gpu_run.py`'s checks: build_corr_sharded (K2 rows) against
   K1's A and exactly symmetric, fit_large with the recursive, panel and
   block2d factorizations against gp.fit in fp32 and fp64, refine=1 before
   and after, predictor_large's W, ring_predict and predict_sharded at
   m=65536 against predict_fast and predict, each timed beside its
   single-device counterpart with its peak memory, and K2 against its
   plain version at the row-block and ring-block shapes; then whether NCCL
   takes two ranks on one card (expected: refused); (b) four gloo ranks
   spawned on the one card at n=4096: the same checks of
   `tools/multi_gpu_run.py` on a {"mr": 4} mesh (block2d on 2 x 2), in
   fp64 with every multi-device result also held against the same
   function on one rank, then in fp32; mle_fit with 8 restarts over the
   ranks (K1) against one process in the same batches, config 4's NUTS in
   fp64 (16 chains a rank) against one process fed the ranks' draws, each
   rank's peak memory and the bytes each factorization sends. The
   multi-device launches of K1 and K2 are counted with the counters set
   to 0 just before each multi-device call and read just after it, in (a)
   and on each rank of (b); the references and checks run outside.
9. The example workflows (`gp_emu_uqsa_torch.examples`), each module's
   workflow at its published size in a launch window of its own, timed
   with its peak memory, every check collected and failing the phase at
   its end: BASELINE config 5 (`large_scale.run`: n=16384, d=8, m=1M,
   block 256, fp32, one NCCL rank) through fit_large, predictor_large, the
   ring in chunks of 65536 queries and the fused tier (K2, K3, K4 "high"
   launched), the fused mean and variance against the ring's at
   tests/test_serve_facade.py:35-38's tolerances on all 1M points, every
   mean against an fp64 CPU fit on the first 4096 queries (phase 3b's
   budget), the ring's and the fused tier's points/s; configs 2, 3, 4 and
   1 (branin_2d, synthetic_10d, hmc_bayes, toy_sim), sensitivity_2d,
   noise_fit (both scripts) and matrix_free, in fp64 as their scripts,
   held to tests/test_acceptance_configs.py's bounds (split R-hat < 1.1
   for config 4, the serving RMSE < 3e-3 for matrix_free, phase 4 (g)'s
   grid RMSE for config 1).
10. Print the kernels JSON line (each entry with its serving, training,
   UQSA, sampling, matrix-free, multi-device and examples launches), the
   card line, and as the last line {"ok": true, "device": {...}}.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import importlib.util
import io
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

import gp_emu_uqsa_torch.emulator as emulator_module
from gp_emu_uqsa_torch import (
    Emulator, gp, kernels, load_emulator, params_from_numpy, save_emulator,
    setup, train,
)
from gp_emu_uqsa_torch.basis import basis_matrix, linear_basis
from gp_emu_uqsa_torch.configs import Beliefs
from gp_emu_uqsa_torch.design_inputs import optLatinHyperCube
from gp_emu_uqsa_torch.examples import (
    branin_2d, hmc_bayes, large_scale, matrix_free, noise_fit,
    sensitivity_2d, synthetic_10d, toy_sim,
)
from gp_emu_uqsa_torch.inference import hmc, lbfgs, nuts
from gp_emu_uqsa_torch.inference import matrix_free as mf
from gp_emu_uqsa_torch.multi import MultiEmulator
from gp_emu_uqsa_torch.ops import _build
from gp_emu_uqsa_torch.ops import cg as cgmod
from gp_emu_uqsa_torch.ops import cholesky as chol
from gp_emu_uqsa_torch.ops import kernel_matrix as km
from gp_emu_uqsa_torch.ops import serve as sv
from gp_emu_uqsa_torch.ops import precision
from gp_emu_uqsa_torch.ops.precision import fp32_exact_matmul
from gp_emu_uqsa_torch.parallel import init_multihost, make_mesh, spawn_ranks
from gp_emu_uqsa_torch.parallel.mesh import all_gather, mesh_device
from gp_emu_uqsa_torch.parallel.runtime import default_backend, free_port
from gp_emu_uqsa_torch.tools import multi_gpu_run, train_linalg
from gp_emu_uqsa_torch.tools.k4_high_variants import launches_ms, ptxas_report
from gp_emu_uqsa_torch.tools.uqsa_forms import gram_log_rho_sum
import gp_emu_uqsa_torch.noise_fit as nf
import gp_emu_uqsa_torch.sensitivity as sensitivity
from gp_emu_uqsa_torch.utils import roofline, sampler_compare, sanitize, timing
from gp_emu_uqsa_torch.utils.checkpoint import load_hmc_state, save_hmc_state

N_TRAIN = 16384          # training rows (BASELINE config 5)
N_VALID = 256            # one V-set: tv_config (65, 64, 1) over 16640 rows
DIM = 8
M_SERVE = 65536          # fused-tier request
M_GEMM = 1000            # gemm-tier request
M_COV = 256              # full-covariance request
M_QUAD_CHECK = 4096      # K4 kernel-vs-plain check
M_COMPARE = 2048         # fused vs gemm on the card
RHS_WIDTH = 10           # 1 + q, q = 9 (linear basis, d = 8)
DELTA = 0.8
NUGGET = 1e-4

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# HBM bytes/s, fp32 FLOP/s outside the tensor cores, TF32 and bf16
# tensor-core FLOP/s (half the data sheets' figures with sparsity).
_PEAKS = {
    "PCIe": (2.0e12, 51e12, 378e12, 756e12),
    "NVL": (3.9e12, 60e12, 417.5e12, 835.5e12),
    "SXM": (3.35e12, 67e12, 495e12, 989e12),
}
# K4 "high" against an fp64 evaluation of the same fp32 W and c: the tier's
# measured budget on quad (docs/numerics.md, bf16x3 tier)
QUAD_HIGH_FP64_BUDGET = 4.7e-5
# K4 "highest" against the same fp64 evaluation: twice the PR 1 body's
# 6.805e-6 at m=65536 on this W
QUAD_HIGHEST_FP64_BUDGET = 1.4e-5
# the fused tier's mean against an fp64 sum of the same fp32 state
MEAN_FP64_BUDGET = 1e-4
# ragged shapes for K3 and K4 "highest": one past a query tile, one short of
# a training chunk and factor tile
M_RAGGED, N_RAGGED = 4097, 16383


# the training phase: BASELINE.md's fit size, one restart per LHC stratum
N_FIT = 4096
FIT_TRIES = 8
TRAIN_MAX_ITERS = 8      # L-BFGS iterations an optimize (the default is 200)
TOY_MAX_ITERS = 4        # the same for the toy-sim workflow (host-bound)
TRAIN_VALID = 256        # one V-set: tv_config (17, 16, 1) over 4352 rows
# fp32 on the card against fp64 on the card, the same code and starts:
# |dNLL| / max(|NLL|, 1) and |dg| / max(|g|, 1) per restart are held to
# budgets set by the conditioning of that restart's A, as fp32 solves
# lose kappa(A) eps32: NLL_BUDGET * kappa eps32 and GRAD_BUDGET * kappa
# eps32, at least the floor and at most the cap (a zero or sign-flipped
# gradient reads 1 or 2 and fails at any kappa). Each is at least 2.6x
# the fp32 path's reading at every start of (a) and (b) and at (e)
# (PERF.md, Training). A backward with TF32 products is run beside it as
# the control: at the starts of (a) and (b) it must break a budget.
EPS32 = 2.0 ** -23
NLL_BUDGET, NLL_FLOOR, NLL_CAP = 0.02, 1e-5, 1e-2
GRAD_BUDGET, GRAD_FLOOR, GRAD_CAP = 0.05, 5e-6, 1e-1
BUDGETS = {
    # the analytic adjoint against autograd, both fp64
    "adjoint_rel": 1e-6,
    # tests/test_fp32.py::test_fit_refine_fp32_n4096 (e after one sweep)
    "refine_fit": 5e-4,
    # tests/test_fp32.py::test_refined_solve_error_bound_n4096
    "refine_solve": 1e-5,
    "unrefined_solve": 3e-2,
}


# phase 5, the UQSA path. (a) at phase 3's emulator (n = 16384): fp32 on the
# card against fp64 on the card at the same hyperparameters, each quantity
# within c kappa(A) eps32, at least the floor and at most the cap: E_EY,
# V_EY, V_i and V_Ti relative to the largest fp64 value, the indices S_i and
# S_Ti absolute, capped at the JAX package's fp32 budget for them (0.02,
# docs/numerics.md). The fp32 A^-1 carries about kappa eps32 of error, and
# so do the indices: each c is 2.6x the largest reading / (kappa eps32) of
# the sound run (PERF.md §6). Held, with every miss a failure, at the
# nuggets where no budget reaches its cap; at the others (the serving
# nugget among them) a miss is printed as a finding. A control, every
# product of the UQSA in TF32, must break a held budget.
UQSA_M, UQSA_V = 0.5, 0.02
# nuggets beside the serving 1e-4: kappa(A) from about 3e3 up
UQSA_SWEEP_NUGGETS = (1.0, 1e-1, 1e-2, 1e-3)
UQSA_BUDGETS = {            # quantity: (c, floor, cap)
    "E_EY": (5e-4, 1e-6, 1e-4),
    "V_EY": (2.5, 1e-5, 0.5),
    "V_i": (1.25, 1e-5, 0.05),
    "V_Ti": (1.25, 1e-5, 0.05),
    "S_i": (1.5, 1e-5, 0.02),
    "S_Ti": (1.5, 1e-5, 0.02),
}
# (b) BASELINE config 3 (examples/synthetic-10d/run_10d.py): 500 points of
# a 10-D smooth g-function from an optimized LHC, fp64, held against
# tests/oracle.py at the trained hyperparameters
G10_N, G10_DIM, G10_CANDIDATES, G10_TRIES = 500, 10, 50, 8
G10_MAX_ITERS = 40        # L-BFGS iterations of the optimize (default 200)
G10_A_COEF = np.array([0.0, 0.5, 1.5, 3.0, 6.0, 9.0, 12.0, 15.0, 20.0, 30.0])
ORACLE_RTOL = 1e-8
# (c) MultiEmulator at the fit size: k outputs x tries restarts in one batch
MULTI_K, MULTI_TRIES, MULTI_MAX_ITERS = 3, 4, 8
# fp64 batched rows against the single-output run: the rtol at which
# tests/test_torch_multi.py holds two fp64 L-BFGS implementations together;
# the fp32 runs' ends differ by about 0.16 relative
MULTI_ROWS_RTOL = 1e-6


# phase 6, the Bayesian path. (a) BASELINE config 4 with tools/long_chain.py's
# settings: gp_test_posterior(1024, 8) in fp32 (MUCM, nugget 1e-4), 64
# chains, NUTS with 24 warmup draws at max depth 4, then 8 segments of 8
# draws at max depth 5, the chain state through a checkpoint between
# segments; one segment rerun from its checkpoint must repeat bit for bit.
# The chains start at log delta ~ N(0, 0.25^2) (long_chain.py starts them
# all at 0), so the log density is held at 64 different points.
BAYES_N, BAYES_D, BAYES_CHAINS = 1024, 8, 64
BAYES_WARMUP, BAYES_WARMUP_DEPTH = 24, 4
# 4 segments, cut from 8 to make room for phase 9 in the run's time
BAYES_SEGMENTS, BAYES_SEGMENT_DRAWS, BAYES_DEPTH = 4, 8, 5
BAYES_RERUN_SEGMENT = 3
BAYES_START_SD = 0.25
HMC_WARMUP, HMC_DRAWS, HMC_LEAPFROG = 24, 16, 8
# (b) a d = 2 posterior at n = 512 (fp32: K1 runs), NUTS against a
# quadrature of the same log density: mean and sd of each log delta within
# QUAD_MCSE Monte-Carlo standard errors (sd / sqrt(ESS))
# 50 + 100 draws, cut from 200 + 400 (phase 9's room): the bound
# is in Monte-Carlo standard errors, which grow as the draws shrink
QUAD_N, QUAD_CHAINS, QUAD_WARMUP, QUAD_DRAWS, QUAD_DEPTH = 512, 16, 50, 100, 6
QUAD_GRID, QUAD_CHUNK, QUAD_MCSE = 80, 256, 5.0
# (c) one NUTS and one HMC transition from the same draws, card and CPU,
# fp64: z relative, the accept statistic absolute (it lies in [0, 1], and
# relative to a statistic near 0 the same rounding reads 7.7e-10)
CPU_N, CPU_CHAINS, CPU_DEPTH, CPU_RTOL, CPU_ACCEPT_ATOL = \
    256, 8, 5, 1e-10, 1e-10
# (d) predict_bayes against the same draws in fp64 on the card, with phase
# 3b's budgets (mean error relative to the largest mean, variance error
# relative to sigma2); sample_posterior's moments against predict's (its
# covariance with the jitter that the t scale matrix's fp32 factor took)
# within POST_MCSE Monte-Carlo standard errors for the mean's 256 entries
# and POST_COV_MCSE for the covariance's 32,896
PRED_M, PRED_DRAWS = 4096, 32
POST_M, POST_DRAWS, POST_MCSE, POST_COV_MCSE = 256, 2000, 5.0, 6.0

# phase 7, the matrix-free path (examples/matrix-free/run_matrix_free.py:
# its simulator, d = 2, noise sd 0.05, seed 0, linear basis, fp32) and the
# noise fit. (b) runs it at MF_N, past the dense path's memory wall; (a)
# holds it against the exact path at MF_N_EXACT, where A still fits
MF_N, MF_N_SUB, MF_M = 131072, 2048, 65536
MF_N_EXACT, MF_M_EXACT = 16384, 4096
MF_NOISE_SD = 0.05
MF_STEPS = 5             # Adam steps (the example: 60)
# L-BFGS iterations of the subset MLE (the default 200 took 57.1 s in fp32,
# most of it linesearches of up to 20 steps near the optimum)
MF_SUB_MAX_ITERS = 40
# the example's learning rate; its nugget floor (1e-4) raised for fp32 to
# MF_FLOOR_C eps32 n. Below that the fp32 estimator's log-nugget gradient
# is wrong: the error of fp32 K3's solves, amplified by A^-1 in the
# Hutchinson trace, grows as eps32 n / nugget. fp32 against fp64 from the
# same probes (tools/mf_fp32_floor.py, PERF.md section 6), gradient
# cosine: n = 131072: 0.285 at 5e-4 (0.064 eps32 n), 0.906 at 1e-3, 0.996
# at 2e-3, 0.9999 at 4e-3; n = 65536: 0.898 at 5e-4 (0.064 eps32 n),
# 0.9965 at 1e-3; n = 16384: 0.994 at 5e-4 (0.26 eps32 n)
MF_FLOOR_C = 0.25


def mf_floor(n: int) -> float:
    """The fp32 matrix-free path's nugget floor at n rows."""
    return MF_FLOOR_C * EPS32 * n


MF_LR, MF_MIN_NUGGET = 0.03, mf_floor(MF_N)
# MFConfig(num_probes=8, lanczos_k=24, cg_maxiter=500, chunk=256,
# precond_rank=48) of the example, with CG tolerances an fp32 K3 matvec
# reaches (the example's 1e-7 and 1e-8 are fp64's): the recursive residual
# of every column must fall below them
MF_CFG = dict(num_probes=8, lanczos_k=24, cg_maxiter=500, chunk=256,
              precond_rank=48)
MF_TRAIN_TOL, MF_FIT_TOL = 1e-5, 1e-5
# (a) tests/test_matrix_free.py:44-55's point and bounds (delta (0.7, 0.9),
# nugget 1e-2; NLL relative error, gradient cosine and norm ratio), with
# 256 probes: the Hutchinson noise of the gradient does not shrink with n
# (fp64 on the CPU at n = 8192, 64 probes read cosine 0.955 and ratio 0.79)
MF_EXACT_DELTA, MF_EXACT_NUGGET = (0.7, 0.9), 1e-2
MF_EXACT_CFG = dict(num_probes=256, lanczos_k=40, cg_maxiter=500, chunk=256,
                    precond_rank=48)
MF_NLL_RTOL, MF_COS, MF_RATIO = 0.01, 0.95, (0.6, 1.6)
# the served mean against gp.fit -> gp.predict in fp64, relative to its
# largest entry: MF_MEAN_C kappa(A) eps32 plus the CG residual reached (the
# fp32 plain path read 0.0027-0.0037 kappa eps32 at n = 4096 on the CPU)
MF_MEAN_C = 0.02
# K3 against the chunked plain matvec: relative to (|C| |V|)_i, the sum of
# the terms' magnitudes
MF_MATVEC_RTOL = 2e-6
# (b): the peak device memory under an eighth of the dense fp32 A
MF_MEM_FRACTION = 1 / 8
# (b): the fit's true residual |b - A x| / |b| (A applied in fp64) under
# tol + MF_RESID_C kappa(A) eps32, kappa(A) <= lambda_max / nugget: CG's
# true residual drifts from its recursive one by the matvec's rounding,
# which grows with |A| |x| / |b|, about kappa(A). Readings with A in fp64
# (tools/mf_fp32_floor.py and this phase, H100): 1.2e-4 kappa eps32 at
# nuggets 5e-4 to 1.6e-2 (3.2e-3 to 1.0e-4; lambda_max about 1.15e5);
# held at about 4x that
MF_RESID_C = 5e-4
# (b): the served mean's RMSE against the noiseless simulator. Readings
# (tools/mf_fp32_floor.py at the subset MLE's delta, H100): 1.27e-3 at
# nugget 4e-3, 1.59e-3 at 2e-3, 5.35e-3 at 5e-4, where the fp32 solve is
# 8x less accurate. Held at 2.4x the reading at the floor (the data's
# noise sd, 0.05, would pass a mean 40x worse)
MF_RMSE = 3e-3
# (b): the Adam steps' start and end from the fit's own probes in fp64
# (cg_tol MF_WITNESS_TOL64), and the start's gradient from
# MF_WITNESS_PROBES fresh probes in fp32
MF_WITNESS_TOL64, MF_WITNESS_PROBES = 1e-8, 64
# (c) the noise fit: chip_smoke.py::problem's inputs and signal with noise
# sd 0.1 + 0.4 x0 (examples/noise-fit/run_noisefit.py's ramp), the
# file-driven entry's design of olhcmult 100 x d, stopat 3, the JAX
# defaults otherwise (tries 4, max_iters 200); fp64 on the card. n is cut
# from 2048 to 1024: at 2048 (c) took 66.5 s (PERF.md §4)
NF_N, NF_D, NF_DESIGN, NF_STOPAT = 1024, 8, 800, 3
NF_RATIO = 2.5           # top-decile noise sd over bottom (test_noise_fit)
# each end's mean sd within these factors of the truth, up or down: 1.25x
# the readings. The estimator overestimates in 8-D in both packages: on
# these inputs the port read 2.55x and 2.02x the truth at the bottom and
# top deciles at n = 1024 (the card and the CPU alike); at n = 512 the
# JAX package read 1.65x and 1.13x, the port 1.75x and 1.17x (CPU, fp64,
# their own L-BFGS starts; PERF.md section 6)
NF_BAND = {"bottom": 3.2, "top": 2.5}
# (d) card against CPU from the same fits (fp64), relative to each
# quantity's largest entry: a noise variance is est_total - latent, which
# cancels where the two agree (one entry read 1.5e-10 of itself)
NF_REPLAY_RTOL = 1e-10
# (d)'s CPU fits: L-BFGS iterations (the default 200; cut for phase 9's
# room)
NF_REPLAY_MAX_ITERS = 20
# (e): one alternating iteration (cut from 3 for phase 9's room;
# phase 9 runs examples/noise-fit's scripts at their stopat 5)
NF_FILES_STOPAT = 1
# (f) utils.timing.timed on K1 against phase 2's ms
TIMED_AGREE = 0.2


class SmokeFailure(RuntimeError):
    pass


def _peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, _PEAKS[key]
    return "SXM", _PEAKS["SXM"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def problem(n: int, d: int = DIM, seed: int = 0):
    """bench.py::_problem's data: x ~ U[0,1]^d, y = sin(3x0) + x1 x2 + 0.1 sum x."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d)).astype(np.float32)
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.1 * x.sum(1)
    return x, y.astype(np.float32)


def time_ms(fn, reps: int = 5):
    """(median CUDA-event time of fn() over `reps` runs after one warm-up,
    the last run's result). The events are created before the timed runs:
    creating one costs the host about as much as a short kernel takes
    (`tools/cuda_core_variants.py build` times it)."""
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for pair in events:
        for event in pair:
            event.record()
    torch.cuda.synchronize()
    times = []
    for start, stop in events:
        start.record()
        out = fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times)), out


def check_close(name, got, want, rtol, atol) -> float:
    """max |got - want|; fails unless |got - want| <= atol + rtol |want|."""
    got = got.double()
    want = want.double()
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    worst = float((err / (atol + rtol * want.abs())).max())
    max_err = float(err.max())
    ok = worst <= 1.0
    print(f"  {name}: max_abs_err={max_err:.3e} (rtol={rtol:g}, atol={atol:g};"
          f" worst err/tolerance {worst:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: exceeds its tolerance {worst:.3f}-fold")
    return max_err


def check_build(name, got, want, symmetric=False) -> float:
    """A correlation build against its plain version: within K1/K2's
    tolerance (rtol 2e-5, atol 2e-6) and, as designed, bit for bit; K1 also
    exactly symmetric."""
    err = check_close(name, got, want, 2e-5, 2e-6)
    print(f"    bitwise equal to the plain version: {torch.equal(got, want)}"
          + (f"; torch.equal(a, a.T): {torch.equal(got, got.T)}"
             if symmetric else ""))
    if symmetric and not torch.equal(got, got.T):
        raise SmokeFailure(f"{name}: output is not exactly symmetric")
    return err


def entry_call(source: str, symbol: str, argtypes, *args):
    """A no-argument call of a C entry point on fixed arguments on the
    current stream (tensors go as their pointers and are kept alive);
    raises on an error code."""
    fn = _build.kernel(source, symbol, argtypes)
    ptrs = (*(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), torch.cuda.current_stream().cuda_stream)

    def call(_keep=args):
        err = fn(*ptrs)
        if err:
            _build.check(err, source, symbol)
    return call


def self_entry(x, delta, nugget, out):
    """K1's C entry point alone, writing into out."""
    n, d = x.shape
    return entry_call(km._SOURCE, "gp_corr_self", km._SELF_ARGTYPES,
                      x, delta, nugget, 0.0, out, n, d)


def cross_entry(x1, x2, delta, out):
    """K2's C entry point alone, writing into out."""
    (m, d), n = x1.shape, x2.shape[0]
    return entry_call(km._SOURCE, "gp_corr_cross", km._CROSS_ARGTYPES,
                      x1, x2, delta, out, m, n, d)


def matvec_entry(xq, x, delta, rhs):
    """K3's C entry point alone on buffers prepared as ops/serve.py
    prepares them."""
    xs, xt = sv._scaled(xq, x, delta)
    (m, d), (n, r) = xs.shape, rhs.shape
    segments = sv._matvec_segments(m, n, r)
    out = torch.zeros((m, r), dtype=torch.float32, device=xs.device)
    partial = (torch.empty((segments, m, r), dtype=torch.float32,
                           device=xs.device) if segments > 1 else out)
    return entry_call(sv._MATVEC_SOURCE, "gp_corr_matvec",
                      sv._MATVEC_ARGTYPES, xs, xt, rhs, partial, out, m, n,
                      d, r, segments)


def quad_entry(xq, x, delta, w, tier):
    """K4's C entry point of one tier alone on buffers prepared as
    ops/serve.py prepares them."""
    xs, xt = sv._scaled(xq, x, delta)
    (m, d), n = xs.shape, xt.shape[0]
    quad = torch.zeros((m,), dtype=torch.float32, device=xs.device)
    tile = 4 if tier == "high" else sv.QUAD_TILE_K
    ld = -(-n // tile) * tile
    xt_t = torch.zeros((d, ld), dtype=torch.float32, device=xs.device)
    xt_t[:, :n] = xt.T
    if tier == "high":
        w_split = torch.empty((2, n, ld), dtype=torch.float32, device=xs.device)
        return entry_call(sv._QUAD_SOURCE, "gp_corr_quad_tf32x3",
                          sv._QUAD_TF32X3_ARGTYPES, xs, xt_t, w, w_split,
                          quad, m, n, d, ld)
    sms = torch.cuda.get_device_properties(xs.device).multi_processor_count
    splits = sv.quad_splits(m, n, sms)
    wt = torch.empty((ld, ld), dtype=torch.float32, device=xs.device)
    partial = (torch.empty((splits, m), dtype=torch.float32, device=xs.device)
               if splits > 1 else quad)
    return entry_call(sv._QUAD_SOURCE, "gp_corr_quad", sv._QUAD_ARGTYPES, xs,
                      xt_t, w, wt, partial, quad, m, n, d, ld, splits)


def device_kernels(fn):
    """Names of the kernels that fn() ran on the card, from torch.profiler's
    trace; None when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return names or None


def check_build_wrappers(x, xv):
    """K1 and K2 through their wrappers with delta and the nugget as tensors
    on the card (kernels.corr_self and kernels.corr pass params.delta and
    params.nugget): no host synchronisation under
    torch.cuda.set_sync_debug_mode("error"), and one kernel on the card per
    call."""
    params = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0,
                               np.log(NUGGET), device=x.device,
                               dtype=torch.float32)
    delta, nugget = params.delta, params.nugget
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # a sync raises
    try:
        km.gaussian_corr_self_fused(x, delta, nugget)
        km.gaussian_corr_fused(xv, x, delta)
        kernels.corr_self(x, params)
        kernels.corr(xv, x, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  K1, K2 wrappers and kernels.corr_self/corr with device delta "
          "and nugget: no host sync under set_sync_debug_mode(\"error\")")
    for name, fn in (
            ("K1", lambda: km.gaussian_corr_self_fused(x, delta, nugget)),
            ("K2", lambda: km.gaussian_corr_fused(xv, x, delta))):
        seen = device_kernels(fn)
        if seen is None:
            print(f"  {name} wrapper, kernels on the card per call: not "
                  "measured (the profiler's trace holds no device activity)")
            continue
        print(f"  {name} wrapper, kernels on the card per call: {len(seen)} "
              f"{sorted(set(seen))}")
        if len(seen) != 1:
            raise SmokeFailure(f"{name} wrapper ran {len(seen)} kernels, not 1")


def bound(bytes_moved: float, flops: float, peaks, tf32_flops: float = 0.0):
    """Least time (ms, what bounds it): bytes over HBM, fp32 operations over
    the CUDA cores' peak and TF32 operations over the tensor cores' peak."""
    bw, fp32, tf32 = peaks[:3]
    t_bytes = bytes_moved / bw * 1e3
    t_ops = max(flops / fp32, tf32_flops / tf32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_WRAPPERS = {"K1": km.gaussian_corr_self_fused, "K2": km.gaussian_corr_fused,
             "K3": sv.corr_matvec, "K4": sv.corr_quad}


def counters():
    return {key: fn.launches for key, fn in _WRAPPERS.items()}


def reset_counters():
    for fn in _WRAPPERS.values():
        fn.launches = 0


def bf16x3_split(c, w):
    """The JAX package's bf16x3 operands (`_quad_kernel_bf16x3` and its
    caller): c_hi is c truncated to bf16, W_hi is W rounded to nearest
    even, and each lo part is the remainder rounded to bf16; as fp32."""
    c_hi = (c.contiguous().view(torch.int32) & -0x10000).view(torch.float32)
    w_hi = w.bfloat16().float()
    return ((c_hi, (c - c_hi).bfloat16().float()),
            (w_hi, (w - w_hi).bfloat16().float()))


def phase_kernels(dev, peaks, card):
    """Kernel vs plain version at the serving path's shapes; times; bounds."""
    print(f"[phase 2] kernels vs plain versions ({card})")
    torch.manual_seed(5)
    x_np, _ = problem(N_TRAIN + N_VALID)
    x = torch.as_tensor(x_np[:N_TRAIN], device=dev)
    xv = torch.as_tensor(x_np[N_TRAIN:], device=dev)
    delta = torch.full((DIM,), DELTA, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(1)
    xq = torch.as_tensor(rng.uniform(size=(M_SERVE, DIM)).astype(np.float32),
                         device=dev)
    n, d = N_TRAIN, DIM
    rows = {}

    # K1: the training build at n = 16384, with delta and the nugget as
    # tensors on the card, as kernels.corr_self passes them
    nugget = torch.tensor(NUGGET, dtype=torch.float32, device=dev)
    a = km.gaussian_corr_self_fused(x, delta, nugget)
    torch.cuda.synchronize()
    err = check_build("K1 gaussian_corr_self", a,
                      km.gaussian_corr_self_plain(x, delta, NUGGET),
                      symmetric=True)
    t_wrap, _ = time_ms(lambda: km.gaussian_corr_self_fused(x, delta, nugget))
    t = launches_ms(self_entry(x, delta, nugget, a))
    t_fill, _ = time_ms(lambda: a.fill_(1.0), reps=20)
    tp, _ = time_ms(lambda: km.gaussian_corr_self_plain(x, delta, NUGGET),
                    reps=3)
    rows["K1"] = (err, t, t_wrap, tp, bound(4.0 * (n * d + n * n),
                                            n * n * (3.0 * d + 1), peaks),
                  None)
    print(f"  K1 at n={n}: {t:.4f} ms alone, {t_wrap:.4f} ms through the "
          f"wrapper; write-rate yardstick fill_(1.0) of the same {n}^2 fp32 "
          f"output {t_fill:.4f} ms (median of 20): K1 writes at "
          f"{t_fill / t:.3f} of fill_'s rate ({card})")
    # W = L^-1 of the same matrix, as the serving predictor builds it
    a = km.gaussian_corr_self_fused(x, delta, nugget)
    l, jitter = chol.cholesky_with_jitter(a)
    w = torch.tril(chol.tri_inverse(l))
    del a, l
    print(f"  (K4 check factor: jitter {float(jitter):.4g})")

    # K2 at the serving run's shapes: gp.predict_batched (m = 1000),
    # predict(full_cov) and validate (256 x n, 256 x 256); the kernels entry
    # is the validation block, 256 x 16384
    k2 = {}
    for xa, xb in ((xq[:M_GEMM], x), (xv, x), (xv, xv)):
        shape = f"{xa.shape[0]} x {xb.shape[0]}"
        c = km.gaussian_corr_fused(xa, xb, delta)
        torch.cuda.synchronize()
        err = check_build(f"K2 gaussian_corr, {shape}", c,
                          km.gaussian_corr_plain(xa, xb, delta))
        t_wrap, _ = time_ms(lambda: km.gaussian_corr_fused(xa, xb, delta),
                            reps=20)
        t = launches_ms(cross_entry(xa, xb, delta, c))
        k2[shape] = (err, t, t_wrap)
        print(f"  K2 at {shape}: {t * 1e3:.2f} us alone, {t_wrap * 1e3:.2f} us "
              f"through the wrapper ({card})")
    mv = xv.shape[0]
    tp, _ = time_ms(lambda: km.gaussian_corr_plain(xv, x, delta))
    rows["K2"] = (*k2[f"{mv} x {n}"], tp,
                  bound(4.0 * (mv * n + (mv + n) * d), mv * n * (3.0 * d + 1),
                        peaks), None)
    # ragged edges: past and short of a 64-row tile, rows that are not a
    # multiple of 16 bytes (thread stores instead of TMA), d in {1, 20}
    for dr in (1, 20):
        dl = torch.full((dr,), DELTA * (dr / DIM) ** 0.5, device=dev)
        for nr in (513, N_RAGGED):
            xr = torch.rand((nr, dr), device=dev)
            check_build(f"K1 gaussian_corr_self, n={nr}, d={dr}",
                        km.gaussian_corr_self_fused(xr, dl, nugget),
                        km.gaussian_corr_self_plain(xr, dl, NUGGET),
                        symmetric=True)
        xr = torch.rand((N_RAGGED, dr), device=dev)
        qr = torch.rand((N_VALID + 1, dr), device=dev)
        check_build(f"K2 gaussian_corr, {N_VALID + 1} x {N_RAGGED}, d={dr}",
                    km.gaussian_corr_fused(qr, xr, dl),
                    km.gaussian_corr_plain(qr, xr, dl))
    del xr, qr
    check_build_wrappers(x, xv)

    # K3: the serving slab, m = 65536, r = 10. rhs ~ N(0,1)/sqrt(n) keeps the
    # outputs O(0.1), as in the n = 300 test whose tolerance this is
    r = RHS_WIDTH
    rhs = torch.as_tensor((rng.standard_normal((n, r)) / np.sqrt(n))
                          .astype(np.float32), device=dev)
    out = sv.corr_matvec(xq, x, delta, rhs)
    torch.cuda.synchronize()
    err = check_close("K3 corr_matvec", out,
                      sv.corr_matvec_plain(xq, x, delta, rhs), 3e-5, 3e-5)
    vec = sv.corr_matvec(xq[:4096], x, delta, rhs[:, 0])
    check_close("K3 corr_matvec (vector rhs)", vec,
                sv.corr_matvec_plain(xq[:4096], x, delta, rhs[:, :1])[:, 0],
                3e-5, 3e-5)
    print(f"  K3 at m={M_SERVE}, r={r}: {sv._matvec_segments(M_SERVE, n, r)} "
          f"segments of n")
    for dr in (1, 20):
        xr = torch.rand((N_RAGGED, dr), device=dev)
        qr = torch.rand((M_RAGGED, dr), device=dev)
        dl = torch.full((dr,), DELTA * (dr / DIM) ** 0.5, device=dev)
        for rr in (1, 10, 17, 33):
            b = torch.randn((N_RAGGED, rr), device=dev) / N_RAGGED ** 0.5
            check_close(f"K3 corr_matvec, m={M_RAGGED}, n={N_RAGGED}, d={dr}, "
                        f"r={rr} ({sv._matvec_segments(M_RAGGED, N_RAGGED, rr)}"
                        f" segments)", sv.corr_matvec(qr, xr, dl, b),
                        sv.corr_matvec_plain(qr, xr, dl, b), 3e-5, 3e-5)
    t_wrap, _ = time_ms(lambda: sv.corr_matvec(xq, x, delta, rhs))
    t = launches_ms(matvec_entry(xq, x, delta, rhs))
    tp, _ = time_ms(lambda: sv.corr_matvec_plain(xq, x, delta, rhs), reps=3)
    m = M_SERVE
    rows["K3"] = (err, t, t_wrap, tp, bound(4.0 * (m * d + n * d + n * r + m * r),
                                    m * n * (3.0 * d + 1 + 2 * r), peaks),
                  None)

    # K4: the variance quadratic against W = L^-1. Both tiers are timed at
    # the serving request m = 65536 (512 blocks of the "high" body: several
    # waves on the card) and the timed runs' outputs are held against the
    # plain version and against fp64 arithmetic on the same fp32 W and c.
    m = M_SERVE
    got = {}
    t_high, got["high"] = time_ms(
        lambda: sv.corr_quad(xq, x, delta, w, quad_precision="high"), reps=3)
    t_highest, got["highest"] = time_ms(
        lambda: sv.corr_quad(xq, x, delta, w, quad_precision="highest"),
        reps=3)
    # the second-long calls: one warm-up and one timed run each
    tp, want = time_ms(lambda: sv.corr_quad_plain(xq, x, delta, w), reps=1)
    errs = {}
    for tier, rtol, atol in (("highest", 5e-4, 5e-5), ("high", 1e-3, 1e-4)):
        errs[tier] = check_close(f"K4 corr_quad ({tier}), m={m}", got[tier],
                                 want, rtol, atol)
    # fp64 on the same W and c (the fp32 correlation of the plain version,
    # which the kernels rebuild to an ulp), over all m in slices
    w64 = torch.tril(w.double())
    e64 = dict.fromkeys(got, 0.0)
    q_max = 0.0
    for s in range(0, m, M_QUAD_CHECK):
        sl = slice(s, s + M_QUAD_CHECK)
        u64 = km.sq_exp_plain(*sv._scaled(xq[sl], x, delta)).double() @ w64.T
        q64 = torch.sum(u64 * u64, dim=1)
        del u64
        q_max = max(q_max, float(q64.abs().max()))
        for tier in got:
            e64[tier] = max(e64[tier],
                            float((got[tier][sl].double() - q64).abs().max()))
    for tier in got:
        print(f"  K4 corr_quad ({tier}), m={m}, vs fp64 of the same W and c: "
              f"max abs {e64[tier]:.3e} (|quad| max {q_max:.3e})")
    for tier, budget in (("high", QUAD_HIGH_FP64_BUDGET),
                         ("highest", QUAD_HIGHEST_FP64_BUDGET)):
        if e64[tier] > budget:
            raise SmokeFailure(f"K4 {tier}: {e64[tier]:.3e} from fp64 exceeds "
                               f"{budget:g}")
    # "high" against its own arithmetic (the same TF32 hi/lo operands, bit
    # for bit) on the first and the last 4096 queries: only the order and
    # rounding of the fp32 sums differ, so it gets the budget of two fp32
    # summations, the "highest" tier's
    for end, sl in (("first", slice(0, M_QUAD_CHECK)),
                    ("last", slice(m - M_QUAD_CHECK, m))):
        check_close(f"K4 corr_quad (high) vs corr_quad_tf32x3_plain, {end} "
                    f"{M_QUAD_CHECK} queries", got["high"][sl],
                    sv.corr_quad_tf32x3_plain(xq[sl], x, delta, w), 5e-4, 5e-5)
    # the strict upper triangle is never read
    xc = xq[:M_QUAD_CHECK]
    w_dirty = w + torch.triu(torch.randn_like(w), 1)
    for tier in got:
        if not torch.equal(
                sv.corr_quad(xc, x, delta, w_dirty, quad_precision=tier),
                sv.corr_quad(xc, x, delta, w, quad_precision=tier)):
            raise SmokeFailure(f"K4 {tier}: a dirty upper triangle changed "
                               "the result")
    print("  K4 corr_quad (both tiers): dirty upper triangle gives an "
          "identical result")
    del w_dirty
    # "highest" at ragged shapes, on W = L^-1 of a random SPD matrix
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.randn((N_RAGGED, N_RAGGED), device=dev) / N_RAGGED ** 0.5
    w_r = torch.eye(N_RAGGED, device=dev)
    w_r = torch.tril(chol.tri_inverse(torch.linalg.cholesky(
        torch.addmm(w_r, g, g.T))))
    del g
    for dr in (1, 20):
        xr = torch.rand((N_RAGGED, dr), device=dev)
        qr = torch.rand((M_RAGGED, dr), device=dev)
        dl = torch.full((dr,), DELTA * (dr / DIM) ** 0.5, device=dev)
        check_close(f"K4 corr_quad (highest), m={M_RAGGED}, n={N_RAGGED}, "
                    f"d={dr} ({sv.quad_splits(M_RAGGED, N_RAGGED, sms)} "
                    f"splits)", sv.corr_quad(qr, xr, dl, w_r),
                    sv.corr_quad_plain(qr, xr, dl, w_r), 5e-4, 5e-5)
    del w_r
    # the m = 4096 "highest" request's K4: factor tiles split over blocks
    # (as served) and in one block per query tile
    xs_c, xt_c = sv._scaled(xc, x, delta)
    splits = sv.quad_splits(M_QUAD_CHECK, n, sms)
    t_split, q_split = time_ms(lambda: sv.corr_quad(xc, x, delta, w))
    q_one = torch.zeros_like(q_split)

    def unsplit():
        _build.check(sv._launch_quad_fp32(xs_c, xt_c, w, q_one, splits=1),
                     sv._QUAD_SOURCE, "corr_quad (highest, one split)")
        return q_one
    t_one, _ = time_ms(unsplit)
    check_close(f"K4 corr_quad (highest), m={M_QUAD_CHECK}, {splits} splits "
                f"vs one", q_split, q_one, 5e-4, 5e-5)
    print(f"  K4 highest at the m={M_QUAD_CHECK} request: {t_split:.4f} ms "
          f"with {splits} splits, {t_one:.4f} ms unsplit ({card})")
    # the error of the products' split alone (products summed in fp64, on
    # the first 4096 queries): this body's 3xTF32 and the JAX package's
    # bf16x3, against the "high" tier's budget
    c = km.sq_exp_plain(*sv._scaled(xc, x, delta))
    u64 = c.double() @ w64.T
    q64 = torch.sum(u64 * u64, dim=1)
    w_tri = torch.tril(w)
    for name, ((c_hi, c_lo), (w_hi, w_lo)) in (
            ("3xTF32", (sv.tf32_split(c), sv.tf32_split(w_tri))),
            ("bf16x3", bf16x3_split(c, w_tri))):
        c_hi, c_lo = c_hi.double(), c_lo.double()
        w_hi, w_lo = w_hi.double(), w_lo.double()
        u64 = c_hi @ w_hi.T + c_hi @ w_lo.T + c_lo @ w_hi.T
        err = float((torch.sum(u64 * u64, dim=1) - q64).abs().max())
        print(f"  K4 split error alone, {name}, lo*lo dropped: max abs {err:.3e} "
              f"on quad (budget {QUAD_HIGH_FP64_BUDGET:g})")
    del c, u64, q64, w64, w_tri, c_hi, c_lo, w_hi, w_lo
    k4_bytes = 4.0 * (m * d + n * d + n * (n + 1) / 2 + m)
    rebuild_ops = m * n * (3.0 * d + 1)
    tri_ops = m * n * (n + 1.0)
    # library yardstick, never called by the port: cuBLAS doing the whole
    # square contraction c @ W^T in fp32 (TF32 off) on a prebuilt c
    c = km.gaussian_corr_fused(xq, x, delta)
    with fp32_exact_matmul():
        t_lib, _ = time_ms(lambda: torch.matmul(c, w.T), reps=1)
    del c
    print(f"  K4 high: the JAX package's bf16x3 arithmetic (three bf16 "
          f"passes) would be bound at {3.0 * tri_ops / peaks[3] * 1e3:.4f} ms "
          f"at the bf16 peak")
    alone = {tier: launches_ms(quad_entry(xq, x, delta, w, tier))
             for tier in ("high", "highest")}
    rows["K4 high"] = (errs["high"], alone["high"], t_high, tp,
                       bound(k4_bytes, rebuild_ops, peaks, 3.0 * tri_ops), t_lib)
    rows["K4 highest"] = (errs["highest"], alone["highest"], t_highest, tp,
                          bound(k4_bytes, rebuild_ops + tri_ops, peaks), t_lib)
    for name, (_, t, t_wrap, tp, (b, by), lib) in rows.items():
        extra = "" if lib is None else f", cuBLAS fp32 product {lib:.4f} ms"
        print(f"  {name}: {t:.4f} ms alone, {t_wrap:.4f} ms through the "
              f"wrapper (plain {tp:.4f} ms, bound {b:.4f} ms by {by}{extra}) "
              f"on {card}")
    del w, xq, x, xv
    torch.cuda.empty_cache()
    return rows


def phase_serve(dev, card):
    """The serving path at full width, through the user's entry points."""
    print(f"[phase 3] serving path, n={N_TRAIN}, d={DIM}, fp32 ({card})")
    x_np, y_np = problem(N_TRAIN + N_VALID)
    emul = Emulator.from_arrays(x_np, y_np, tv_config=(65, 64, 1),
                                dtype=torch.float32, device=dev, seed=0)
    emul.params = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0,
                                    np.log(NUGGET), device=dev,
                                    dtype=torch.float32)
    rng = np.random.default_rng(2)
    xq = rng.uniform(size=(M_SERVE, DIM))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "emulator"
        save_emulator(ckpt, emul)
        reset_counters()
        t0 = time.perf_counter()
        served = load_emulator(ckpt, device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    n_train = served.train_view()[0].shape[0]
    if n_train != N_TRAIN:
        raise SmokeFailure(f"expected {N_TRAIN} training rows, got {n_train}")
    mean_g, var_g = served.predict(xq[:M_GEMM])
    served.predict(xq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mean_f, var_f = served.predict(xq)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    mean_c, cov = served.predict(xq[:M_COV], full_cov=True)
    diag = served.validate_against(0)
    torch.cuda.synchronize()
    launches = counters()
    print(f"  launches in the serving run (K4 \"high\"): {launches}")
    if min(launches.values()) <= 0:
        raise SmokeFailure(f"a kernel of the path never launched: {launches}")
    # the exact fp32 K4 body through the same entry point, counted apart
    reset_counters()
    _, var_h = served.predict(xq[:M_QUAD_CHECK], quad_precision="highest")
    torch.cuda.synchronize()
    side = counters()
    print(f"  launches in the quad_precision=\"highest\" request: {side}")
    if side["K3"] <= 0 or side["K4"] <= 0:
        raise SmokeFailure(f"the \"highest\" request did not launch K3 and "
                           f"K4: {side}")

    for name, v in (("mean_gemm", mean_g), ("var_gemm", var_g),
                    ("mean_fused", mean_f), ("var_fused", var_f),
                    ("var_fused_highest", var_h),
                    ("mean_cov", mean_c), ("cov", cov),
                    ("mahalanobis", diag["mahalanobis"]),
                    ("std_err", diag["std_err"])):
        if not bool(torch.isfinite(v).all()):
            raise SmokeFailure(f"{name}: non-finite values")
    shapes = {"mean_gemm": (mean_g.shape, (M_GEMM,)),
              "mean_fused": (mean_f.shape, (M_SERVE,)),
              "var_fused": (var_f.shape, (M_SERVE,)),
              "cov": (cov.shape, (M_COV, M_COV)),
              "std_err": (diag["std_err"].shape, (N_VALID,))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise SmokeFailure(f"{name}: shape {tuple(got)}, expected {want}")
    if float(var_f.min()) < 0 or float(var_g.min()) < 0:
        raise SmokeFailure("negative predictive variance")

    # fused tier vs gemm tier on the card (tests/test_serve_facade.py:35-38)
    s2 = float(served.state.sigma2)
    m_ref, v_ref = served.predict(xq[:M_COMPARE], serve="gemm")
    check_close("fused vs gemm mean", mean_f[:M_COMPARE], m_ref,
                1e-4, 1e-4 * max(1.0, s2))
    check_close("fused vs gemm var", var_f[:M_COMPARE], v_ref,
                2e-3, 1e-4 * s2)
    check_close("gemm m=1000 vs fused", mean_g, mean_f[:M_GEMM],
                1e-4, 1e-4 * max(1.0, s2))
    # K4 "high" vs "highest" in the served variance: each tier's quad within
    # the 4.7e-5 budget of fp64, times sigma2
    check_close("fused var, K4 high vs highest", var_f[:M_QUAD_CHECK], var_h,
                0.0, 2 * QUAD_HIGH_FP64_BUDGET * s2)
    # each tier's mean against an fp64 evaluation of the same fp32 state
    # (c e summed in fp64): which side of the gap is summation error
    xs, hs = served._prepare_inputs(xq[:M_COMPARE])
    st = served.state
    inv = 1.0 / torch.exp(st.params.log_delta).double()
    c64 = km.sq_exp_plain(xs.double() * inv,
                          served.train_view()[0].double() * inv)
    m64 = hs.double() @ st.beta.double() + c64 @ st.e.double()
    fused_err = float((mean_f[:M_COMPARE].double() - m64).abs().max())
    print(f"  mean vs fp64 sum of the same state: fused {fused_err:.3e}, "
          f"gemm {float((m_ref.double() - m64).abs().max()):.3e}; "
          f"|e| max {float(st.e.abs().max()):.3e}")
    del c64
    if fused_err > MEAN_FP64_BUDGET:
        raise SmokeFailure(f"fused mean: {fused_err:.3e} from fp64 exceeds "
                           f"{MEAN_FP64_BUDGET:g}")
    jitter = float(served.state.jitter)
    pts = M_SERVE / serve_s
    print(f"  jitter used: {jitter:.6g} ({card})")
    print(f"  fit (load_emulator) : {fit_s * 1e3:.1f} ms ({card})")
    print(f"  serve m={M_SERVE}: {serve_s * 1e3:.1f} ms = {pts:.0f} "
          f"mean+var points/s ({card})")
    print(f"  validate: mahalanobis {float(diag['mahalanobis']):.4g} "
          f"(expect {float(diag['mahalanobis_mean']):.4g} "
          f"+- {float(diag['mahalanobis_sd']):.4g})")
    del served, emul
    torch.cuda.empty_cache()
    return launches, side["K4"]


def phase_reference(dev):
    """A small fp32 card run against the fp64 CPU path (test_fp32 budgets)."""
    print("[phase 3b] small fp32 card run vs fp64 CPU")
    x_np, y_np = problem(640, seed=3)
    xq = np.random.default_rng(4).uniform(size=(1024, DIM))
    results = {}
    for device, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
        emul = Emulator.from_arrays(x_np, y_np, tv_config=(5, 4, 1),
                                    dtype=dtype, device=device, seed=0)
        emul.params = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0,
                                        np.log(1e-2), device=device,
                                        dtype=dtype)
        x, y, h = emul.train_view()
        emul.state = gp.fit(emul.params, x, y, h)
        mean, var = emul.predict(xq)   # fused tier on the card (m >= 1024)
        results[str(device)] = (mean.cpu().double(), var.cpu().double(),
                                float(emul.state.sigma2))
    m32, v32, _ = results[str(dev)]
    m64, v64, s64 = results["cpu"]
    rel_mean = float((m32 - m64).abs().max() / m64.abs().max())
    rel_var = float((v32 - v64).abs().max() / s64)
    print(f"  mean rel err {rel_mean:.3e} (< 1e-3), var err / sigma2 "
          f"{rel_var:.3e} (< 1e-2)")
    if not (rel_mean < 1e-3 and rel_var < 1e-2):
        raise SmokeFailure("fp32 card run disagrees with the fp64 CPU path")


def _self_device_ms(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


# where the card's time of a likelihood evaluation goes: the aten op that
# launched each kernel (K1 is launched from ctypes and found by its name)
_OP_PARTS = (
    ("Cholesky (cholesky_ex)", ("aten::linalg_cholesky_ex",)),
    ("triangular solves", ("aten::linalg_solve_triangular",)),
    ("inverse (cholesky_inverse)", ("aten::cholesky_inverse",)),
    ("products", ("aten::mm", "aten::bmm", "aten::addmm", "aten::matmul",
                  "aten::mv", "aten::dot")),
)


def device_profile(fn):
    """fn() once under torch.profiler: (device busy ms, {part: device ms}),
    or (None, None) when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels_ = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels_:
        return None, None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels_)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    parts = {"K1 (corr_build_kernel)": sum(
        e.time_range.end - e.time_range.start for e in kernels_
        if "corr_build_kernel" in e.name) / 1e3}
    by_op = {e.key: _self_device_ms(e) for e in prof.key_averages()}
    for part, ops in _OP_PARTS:
        parts[part] = sum(by_op.get(op, 0.0) for op in ops)
    parts["elementwise and other"] = busy / 1e3 - sum(parts.values())
    return busy / 1e3, parts


def wall_ms(fn, reps: int = 3):
    """Median host-clock time of fn() ending in a synchronize, after one
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def evaluation_breakdown(label, objective, u, card):
    """Time one value-and-gradient of the batched objective and its forward
    alone; print where the card's time goes and the host gap."""
    t_vg = wall_ms(lambda: lbfgs.value_and_grad(objective, u))

    def forward():
        with torch.no_grad():
            objective(u)
    t_fwd = wall_ms(forward)
    print(f"  {label}: value and gradient {t_vg:.2f} ms, forward alone "
          f"{t_fwd:.2f} ms (host clock, median of 3; {card})")
    out = {"eval_ms": t_vg, "forward_ms": t_fwd}
    for name, fn, wall in (("forward", forward, t_fwd),
                           ("value and gradient",
                            lambda: lbfgs.value_and_grad(objective, u), t_vg)):
        busy, parts = device_profile(fn)
        if busy is None:
            print(f"    {name}: device breakdown not measured (the "
                  "profiler's trace holds no device activity)")
            continue
        text = ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        print(f"    {name}: card busy {busy:.3f} ms of {wall:.3f} ms (host "
              f"gap {wall - busy:.3f} ms, {100 * (1 - busy / wall):.1f}%): "
              f"{text} ms")
        out[name] = (busy, parts)
    return out


def kappa_fp64(a64, iters: int = 30):
    """kappa(A) of each matrix of an fp64 batch (..., n, n): power iteration
    for lambda_max, inverse iteration through the Cholesky factor for
    lambda_min. Both approach from inside, so kappa is underestimated and
    the budgets it sets err tight."""
    l = torch.linalg.cholesky(a64)
    gen = torch.Generator(device=a64.device).manual_seed(0)
    v = torch.randn(a64.shape[:-1] + (1,), generator=gen, dtype=a64.dtype,
                    device=a64.device)
    w = v.clone()
    for _ in range(iters):
        v = a64 @ v
        v = v / v.norm(dim=-2, keepdim=True)
        w = torch.cholesky_solve(w, l)
        w = w / w.norm(dim=-2, keepdim=True)
    lmax = (v.mT @ (a64 @ v))[..., 0, 0]
    lmin = (w.mT @ (a64 @ w))[..., 0, 0]
    return lmax / lmin


def fp32_budgets(kappa):
    """(NLL budget, gradient budget) per restart from kappa(A)."""
    k = kappa * EPS32
    return (torch.clamp(NLL_BUDGET * k, min=NLL_FLOOR, max=NLL_CAP),
            torch.clamp(GRAD_BUDGET * k, min=GRAD_FLOOR, max=GRAD_CAP))


def _tf32(fn):
    """fn's undecorated body (`fp32_exact` keeps it as __wrapped__) with
    TF32 products."""
    body = getattr(fn, "__wrapped__", fn)

    def run(*args, **kwargs):
        torch.backends.cuda.matmul.allow_tf32 = True
        return body(*args, **kwargs)
    return run


def value_and_grad_tf32_backward(objective, u):
    """The control: lbfgs.value_and_grad with the forward as the port runs
    it and every backward (the analytic adjoints, `_chol_rev`, autograd's
    own) with TF32 products, the error that `fp32_exact` on the backward
    exists to prevent."""
    patched = ((gp, "_nll_mucm_bwd"), (chol, "_chol_rev"),
               (kernels, "_gaussian_self_grads"),
               (kernels, "_gaussian_cross_grads"))
    saved = [getattr(mod, name) for mod, name in patched]
    flags = torch.backends.cuda.matmul
    flag = flags.allow_tf32
    with torch.enable_grad():
        u = u.detach().requires_grad_(True)
        v = objective(u)
        try:
            for mod, name in patched:
                setattr(mod, name, _tf32(getattr(mod, name)))
            flags.allow_tf32 = True
            (g,) = torch.autograd.grad(v.sum(), u)
        finally:
            for (mod, name), fn in zip(patched, saved):
                setattr(mod, name, fn)
            flags.allow_tf32 = flag
    v = v.detach()
    return v, torch.where(torch.isfinite(v)[:, None], g, torch.zeros_like(g))


def hold_fp32(name, v32, g32, v64, g64, kappa, failures, control,
              must_catch=True):
    """Print the fp32 errors beside their budgets; record any miss. Print
    the errors of `control` (the gradients of a TF32 backward) too, and
    with `must_catch` record a failure unless one breaks its budget."""
    nll_err, grad_err = rel_errors(v32, g32, v64, g64)
    nll_b, grad_b = fp32_budgets(kappa)
    fmt = lambda t: "[" + ", ".join(f"{v:.3e}" for v in t.tolist()) + "]"
    print(f"    {name}: kappa(A) {fmt(kappa)}")
    print(f"      NLL rel err {fmt(nll_err)} (budgets {fmt(nll_b)})")
    print(f"      gradient rel err {fmt(grad_err)} (budgets {fmt(grad_b)})")
    bad = (nll_err > nll_b) | (grad_err > grad_b)
    if bool(bad.any()):
        failures.append(f"{name}: fp32 vs fp64 over budget at restarts "
                        f"{torch.nonzero(bad).flatten().tolist()}")
    ctrl = rel_errors(v32, control, v64, g64)[1]
    caught = ctrl > grad_b
    print(f"      control, TF32 backward: gradient rel err {fmt(ctrl)} "
          f"(over budget at restarts "
          f"{torch.nonzero(caught).flatten().tolist()})")
    if must_catch and not bool(caught.any()):
        failures.append(f"{name}: the budgets pass a TF32 backward")


def rel_errors(v32, g32, v64, g64):
    """Per restart: |NLL32 - NLL64| / max(|NLL64|, 1) and |g32 - g64| /
    max(|g64|, 1): relative where the value or the gradient is large,
    absolute where it is flat."""
    v32, g32 = v32.double(), g32.double()
    nll = (v32 - v64).abs() / v64.abs().clamp(min=1.0)
    grad = (g32 - g64).norm(dim=-1) / g64.norm(dim=-1).clamp(min=1.0)
    return nll, grad


def phase_train_gradients(dev, card, failures):
    """(a), (b): batched value and gradient at the 8 LHC starts, fp32 (K1,
    the analytic adjoint, the ladder) against fp64 on the card (the plain
    build), and the analytic adjoint against autograd in fp64."""
    x_np, y_np = problem(N_FIT)
    x32 = torch.as_tensor(x_np, device=dev)
    y32 = torch.as_tensor(y_np, device=dev)
    spec = linear_basis(DIM)
    h32 = basis_matrix(x32, spec)
    x64, y64, h64 = x32.double(), y32.double(), h32.double()
    out = {}
    for mode in ("mucm", "gp4ml"):
        cfg = lbfgs.MLEConfig(mode=mode, tries=FIT_TRIES, nugget=NUGGET)
        lo, hi = lbfgs._default_bounds(cfg, DIM)
        z0 = lbfgs._lhc_starts(torch.Generator().manual_seed(0), FIT_TRIES,
                               lo, hi, torch.float64).to(dev)
        obj32, _, _ = lbfgs._make_objective(x32, y32, h32, cfg, lo, hi)
        obj64, to64, from64 = lbfgs._make_objective(x64, y64, h64, cfg, lo,
                                                    hi)
        u64 = from64(z0)
        u32 = u64.float()
        reset_counters()
        v32, g32 = lbfgs.value_and_grad(obj32, u32)
        torch.cuda.synchronize()
        k1 = counters()["K1"]
        v64, g64 = lbfgs.value_and_grad(obj64, u64)
        p64 = lbfgs._unpack(to64(u64), cfg, DIM, torch.float64)
        p32 = kernels.GPParams(*(t.float() for t in p64))
        with torch.no_grad():
            jit32 = gp._common(p32, x32, y32, h32)[2]
            jit64 = gp._common(p64, x64, y64, h64)[2]
        kappa = kappa_fp64(kernels.corr_self(x64, p64))
        print(f"  ({'a' if mode == 'mucm' else 'b'}) nll_{mode} at {FIT_TRIES} "
              f"LHC starts, n={N_FIT}, d={DIM}: K1 launches {k1}; fp32 "
              f"jitter {jit32.tolist()}, fp64 jitter {jit64.tolist()}")
        print(f"    NLL fp64 {v64.tolist()}; |gradient| fp64 "
              f"{g64.norm(dim=-1).tolist()}")
        ctrl = value_and_grad_tf32_backward(obj32, u32)[1]
        hold_fp32("fp32 vs fp64", v32, g32, v64, g64, kappa, failures, ctrl)
        if not bool(torch.isfinite(v64).all()):
            failures.append(f"nll_{mode}: non-finite fp64 NLL")
        if not torch.equal(jit32.double(), jit64):
            failures.append(f"nll_{mode}: the fp32 ladder took another rung")
        if k1 < FIT_TRIES:
            failures.append(f"nll_{mode}: K1 launched {k1} times for "
                            f"{FIT_TRIES} restarts")
        if mode == "mucm":
            # the analytic adjoint against autograd through the factor
            def obj_ad(u):
                params = lbfgs._unpack(to64(u), cfg, DIM, torch.float64)
                return gp.nll_mucm_ad(params, x64, y64, h64)
            va, ga = lbfgs.value_and_grad(obj_ad, u64)
            adj = (g64 - ga).norm(dim=-1) / ga.norm(dim=-1).clamp(min=1.0)
            print(f"    analytic adjoint vs autograd (fp64): gradient rel "
                  f"err {adj.tolist()} (budget {BUDGETS['adjoint_rel']:g})")
            if float(adj.max()) > BUDGETS["adjoint_rel"]:
                failures.append(f"adjoint vs autograd: {float(adj.max()):.3e}")
            out["breakdown"] = evaluation_breakdown(
                f"one evaluation, n={N_FIT}, {FIT_TRIES} restarts, fp32",
                obj32, u32, card)
            out["k1_fit"] = k1_at_fit_size(x32, card)
    del x32, x64
    torch.cuda.empty_cache()
    return out


def k1_at_fit_size(x, card):
    """K1 at the fit size: the kernel alone (C entry point, 20 back-to-back
    launches) and the wrapper's host time a call (perf_counter over 200
    calls into one preallocated output, no wait for the card)."""
    delta = torch.full((DIM,), DELTA, dtype=torch.float32, device=x.device)
    nugget = torch.tensor(NUGGET, dtype=torch.float32, device=x.device)
    out = km.gaussian_corr_self_fused(x, delta, nugget)
    alone = launches_ms(self_entry(x, delta, nugget, out))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        km.gaussian_corr_self_fused(x, delta, nugget, out=out)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"    K1 at n={x.shape[0]}: {alone * 1e3:.2f} us alone, wrapper host "
          f"time {host_us:.2f} us a call ({card})")
    return alone, host_us


class _NllCalls:
    """Counts objective calls (gp.nll, each on the running restarts) and
    the restart evaluations in them."""

    def __enter__(self):
        self.calls = self.rows = 0
        self._nll = gp.nll

        def nll(params, *args, **kwargs):
            self.calls += 1
            self.rows += params.log_nugget.numel()
            return self._nll(params, *args, **kwargs)

        gp.nll = nll
        return self

    def __exit__(self, *exc):
        gp.nll = self._nll


class _OptimizeLog(_NllCalls):
    """Wraps the emulator's mle_fit: time, iterations and objective
    evaluations of every optimize (the objective is gp.nll)."""

    def __enter__(self):
        super().__enter__()
        self.runs = []
        self._fit = emulator_module.mle_fit

        def fit(*args, **kwargs):
            calls0, rows0 = self.calls, self.rows
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, info = self._fit(*args, **kwargs)
            torch.cuda.synchronize()
            self.runs.append({"s": time.perf_counter() - t0,
                              "n": args[1].shape[0],
                              "iters": int(info["iters"].max()),
                              "evals": self.calls - calls0,
                              "rows": self.rows - rows0,
                              "nlls": info["nlls"].tolist(),
                              "best": float(info["best_nll"]),
                              "params": params})
            return params, info

        emulator_module.mle_fit = fit
        return self

    def __exit__(self, *exc):
        emulator_module.mle_fit = self._fit
        super().__exit__(*exc)


def phase_train_path(dev, card, failures):
    """(c) Emulator.from_arrays -> train at n = 4096 (+ one 256-row V-set),
    fp32, 8 restarts, counted in a launch window of its own."""
    n_all = N_FIT + TRAIN_VALID
    x_np, y_np = problem(n_all)
    emul = Emulator.from_arrays(x_np, y_np, tv_config=(17, 16, 1),
                                tries=FIT_TRIES, nugget=NUGGET,
                                dtype=torch.float32, device=dev, seed=0)
    emul.mle_config = dataclasses.replace(emul.mle_config,
                                          max_iters=TRAIN_MAX_ITERS)
    if emul.train_view()[0].shape[0] != N_FIT:
        raise SmokeFailure("training set is not 4096 rows")
    reset_counters()
    with _OptimizeLog() as log:
        t0 = time.perf_counter()
        train(emul)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = counters()
    print(f"  (c) train: {total_s:.2f} s for {len(log.runs)} optimize calls "
          f"and one validation; launches in the training window: "
          f"{launches} ({card})")
    for run in log.runs:
        iters = max(run["iters"], 1)
        print(f"    optimize n={run['n']}: {run['s'] * 1e3:.1f} ms, "
              f"{run['iters']} L-BFGS iterations ({run['s'] * 1e3 / iters:.1f}"
              f" ms each), {run['evals']} objective evaluations "
              f"({run['s'] * 1e3 / max(run['evals'], 1):.2f} ms each, "
              f"{run['rows']} restart evaluations in them); "
              f"best NLL {run['best']:.6g}; finite restarts "
              f"{sum(np.isfinite(run['nlls']))}/{len(run['nlls'])}")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        failures.append(f"training window: K1 and K2 must launch: {launches}")
    last = log.runs[-1]
    if not np.isfinite(last["best"]) or sum(np.isfinite(last["nlls"])) < 2:
        failures.append(f"train: best NLL {last['best']}, restarts "
                        f"{last['nlls']}")
    # the best NLL against fp64 at the same parameters on the same rows
    x, y, h = emul.train_view()
    p64 = kernels.GPParams(*(t.double() for t in last["params"]))
    nll64 = float(gp.nll_mucm(p64, x.double(), y.double(), h.double()))
    rel = abs(last["best"] - nll64) / max(abs(nll64), 1.0)
    budget = float(fp32_budgets(kappa_fp64(kernels.corr_self(x.double(),
                                                              p64)))[0])
    print(f"    final NLL fp32 {last['best']:.8g} vs fp64 at the same "
          f"parameters {nll64:.8g}: rel err {rel:.3e} (budget {budget:.3e}); "
          f"delta {torch.exp(last['params'].log_delta).tolist()}")
    if rel > budget:
        failures.append(f"train: final NLL {rel:.3e} from fp64")
    mean, var = emul.predict(x_np[:1000])
    if not (bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all())
            and float(var.min()) >= 0):
        failures.append("trained emulator: non-finite or negative prediction")
    del emul
    torch.cuda.empty_cache()
    return launches, log.runs


def _clustered_system(n, d=4, nugget=1e-2, seed=3):
    """tests/test_fp32.py::_clustered_kernel_system's inputs and its y."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(size=(n // 2, d))
    x = np.vstack([base, base + 1e-3 * rng.standard_normal((n // 2, d))])
    rng = np.random.default_rng(7)
    y = np.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2] + 0.05 * rng.standard_normal(n)
    return x, y, np.full(d, 1.2), nugget


def _rel(got, want) -> float:
    return float((got.double() - want).norm() / want.norm())


def phase_refine(dev, failures):
    """(d) fp32 iterative refinement (fp64 residual, corrections through
    the fp64 factor) at n = 4096, held to tests/test_fp32.py's budgets for
    the JAX package's compensated one: gp.fit(refine=1) (K1's A, cuSOLVER's
    factor) against the fp64 solve of the same A, and one sweep of
    cho_solve_refined on that test's fp32-rounded system."""
    x, y, delta, nugget = _clustered_system(N_FIT)
    x32 = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y32 = torch.as_tensor(y, dtype=torch.float32, device=dev)
    h32 = basis_matrix(x32, linear_basis(4))
    p32 = kernels.make_params(delta, nugget=nugget, device=dev)
    st0 = gp.fit(p32, x32, y32, h32)
    st1 = gp.fit(p32, x32, y32, h32, refine=1)
    a64 = kernels.corr_self(x32, p32).double()
    l64 = torch.linalg.cholesky(a64)
    beta = st1.beta.double()
    e64 = torch.cholesky_solve((y32.double() - h32.double() @ beta)[:, None],
                               l64)[:, 0]
    ah64 = torch.cholesky_solve(h32.double(), l64)
    err_e = [_rel(st.e, e64) for st in (st0, st1)]
    err_ah = [_rel(st.ainv_h, ah64) for st in (st0, st1)]
    print(f"  (d) fit(refine=1), fp32, n={N_FIT}: jitter {float(st1.jitter)}; "
          f"against the fp64 solve of the same A: e {err_e[0]:.3e} -> "
          f"{err_e[1]:.3e} (budget {BUDGETS['refine_fit']:g} and < "
          f"unrefined / 5), A^-1 H {err_ah[0]:.3e} -> {err_ah[1]:.3e}")
    if not torch.equal(st0.beta, st1.beta):
        failures.append("refine changed beta")
    if not (err_e[1] <= BUDGETS["refine_fit"] and err_e[1] < err_e[0] / 5):
        failures.append(f"fit(refine=1): e {err_e}")
    del a64, l64
    # the solve-level contract: the system of _clustered_kernel_system
    # (matmul-expansion build in fp64, rounded to fp32), a random b
    a32, b32 = train_linalg.refine_system(N_FIT, dev)
    x_true = torch.linalg.solve(a32.double(), b32.double())
    l32, jit = chol.cholesky_with_jitter(a32)
    x0 = chol.cho_solve(l32, b32[:, None])[:, 0]
    x1 = chol.cho_solve_refined(l32, a32, b32[:, None], iters=1)[:, 0]
    err0, err1 = _rel(x0, x_true), _rel(x1, x_true)
    print(f"      cho_solve_refined of the fp32-rounded system: jitter "
          f"{float(jit)}, unrefined {err0:.3e} (budget "
          f"{BUDGETS['unrefined_solve']:g}), one sweep {err1:.3e} (budget "
          f"{BUDGETS['refine_solve']:g} and < unrefined / 10)")
    if not (float(jit) == 0.0 and err0 <= BUDGETS["unrefined_solve"]
            and err1 <= BUDGETS["refine_solve"] and err1 < err0 / 10):
        failures.append(f"refined solve: {err0:.3e} -> {err1:.3e}, jitter "
                        f"{float(jit)}")
    del a32, l32
    torch.cuda.empty_cache()


def phase_train_serving_width(dev, card, failures):
    """(e) one value and gradient at the serving width n = 16384, B = 1,
    fp32 against fp64 on the card, with the breakdown."""
    x_np, y_np = problem(N_TRAIN)
    x32 = torch.as_tensor(x_np, device=dev)
    y32 = torch.as_tensor(y_np, device=dev)
    h32 = basis_matrix(x32, linear_basis(DIM))
    cfg = lbfgs.MLEConfig(nugget=NUGGET, constraints="none")
    z = torch.tensor([[np.log(DELTA)] * DIM], dtype=torch.float64, device=dev)
    lo, hi = lbfgs._default_bounds(cfg, DIM)
    obj32, _, _ = lbfgs._make_objective(x32, y32, h32, cfg, lo, hi)
    v32, g32 = lbfgs.value_and_grad(obj32, z.float())
    ctrl = value_and_grad_tf32_backward(obj32, z.float())[1]
    out = evaluation_breakdown(f"(e) one evaluation, n={N_TRAIN}, 1 restart, "
                               "fp32", obj32, z.float(), card)
    torch.cuda.empty_cache()
    x64 = x32.double()
    obj64, _, _ = lbfgs._make_objective(x64, y32.double(), h32.double(), cfg,
                                        lo, hi)
    v64, g64 = lbfgs.value_and_grad(obj64, z)
    print(f"    NLL fp32 {float(v32):.8g}, fp64 {float(v64):.8g}")
    kappa = kappa_fp64(kernels.corr_self(
        x64, lbfgs._unpack(z, cfg, DIM, torch.float64)))
    # at this kappa the TF32 backward reads no worse than the fp32 one
    hold_fp32(f"n={N_TRAIN}, fp32 vs fp64", v32, g32, v64, g64, kappa,
              failures, ctrl, must_catch=False)
    del x32, x64, obj32, obj64
    torch.cuda.empty_cache()
    return out


def phase_ladder(dev, failures):
    """(f) a batch in which some restarts need jitter (duplicated rows, a
    tiny nugget, long length scales) and others do not: per-restart rungs
    as on the CPU for the same A, no NaN, finite gradients."""
    x_np, y_np = problem(1024, seed=5)
    x_np = np.vstack([x_np, x_np[:1024]])          # every row twice
    y_np = np.concatenate([y_np, y_np[:1024]])
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    h = basis_matrix(x, linear_basis(DIM))
    log_delta = torch.log(torch.tensor(
        [[0.05] * DIM, [2.0] * DIM, [0.1] * DIM, [4.0] * DIM], device=dev))
    log_nugget = torch.log(torch.tensor([1e-3, 1e-9, 1e-2, 1e-9],
                                        device=dev))
    params = kernels.GPParams(log_delta.requires_grad_(True),
                              torch.zeros(4, device=dev),
                              log_nugget.requires_grad_(True))
    a = kernels.corr_self(x, params).detach()
    l, jit = chol.cholesky_with_jitter(a)
    _, jit_cpu = chol.cholesky_with_jitter(a.cpu())
    v = gp.nll_mucm(params, x, y, h)
    gd, gn = torch.autograd.grad(v.sum(), (params.log_delta,
                                           params.log_nugget))
    print(f"  (f) ladder, n={x.shape[0]} with every row twice, 4 restarts: "
          f"jitter on the card {jit.tolist()}, on the CPU for the same A "
          f"{jit_cpu.tolist()}; NLL {v.tolist()}")
    ok = (bool(torch.isfinite(l).all()) and bool(torch.isfinite(v).all())
          and bool(torch.isfinite(gd).all()) and bool(torch.isfinite(gn).all()))
    if not ok:
        failures.append("ladder: NaN or inf in the factor, NLL or gradient")
    if not torch.equal(jit.cpu(), jit_cpu):
        failures.append(f"ladder: rungs {jit.tolist()} on the card, "
                        f"{jit_cpu.tolist()} on the CPU")
    if not (float(jit[0]) == 0.0 and float(jit[1]) > 0.0):
        failures.append(f"ladder: expected restart 0 healthy and 1 jittered: "
                        f"{jit.tolist()}")
    del a, l
    torch.cuda.empty_cache()


def phase_workflow(dev, failures):
    """(g) setup -> train -> final_build on a copy of examples/toy-sim in a
    temporary directory (final_build writes beside its inputs)."""
    src = Path(__file__).resolve().parent / "examples" / "toy-sim"
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp) / "toy-sim"
        shutil.copytree(src, work)
        emul = setup(work / "toy-sim_config", device=dev, dtype=torch.float32)
        emul.mle_config = dataclasses.replace(emul.mle_config,
                                              max_iters=TOY_MAX_ITERS)
        t0 = time.perf_counter()
        train(emul)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        written = sorted(p.name for p in work.iterdir() if p.name.endswith("-f"))
        bel = Beliefs.from_file(work / "toy-sim_beliefs-f")
        mean, var = emul.predict(np.linspace(0.05, 1.95, 60)[:, None])
        truth = 3.0 * np.linspace(0.05, 1.95, 60) * np.sin(
            5.0 * np.pi * np.linspace(0.05, 1.95, 60) / 2.0)
        rmse = float(np.sqrt(np.mean((mean.double().cpu().numpy() - truth)
                                     ** 2)))
    print(f"  (g) setup -> train -> final_build on toy-sim (n=40, d=1): "
          f"{t:.2f} s; wrote {written}; delta {bel.delta}, RMSE against the "
          f"simulator {rmse:.3e} (< 0.05)")
    if written != ["toy-sim_beliefs-f", "toy-sim_input-f", "toy-sim_output-f"]:
        failures.append(f"final_build wrote {written}")
    if not (rmse < 0.05 and bool(torch.isfinite(var).all())):
        failures.append(f"toy-sim emulator RMSE {rmse}")


def phase_train(dev, card):
    """Phase 4: the training path at full width. Every check is collected
    and the phase fails at its end if any failed."""
    print(f"[phase 4] training path, n={N_FIT}, d={DIM}, fp32, "
          f"tries={FIT_TRIES} ({card})")
    failures = []
    grads = phase_train_gradients(dev, card, failures)
    launches, runs = phase_train_path(dev, card, failures)
    phase_refine(dev, failures)
    wide = phase_train_serving_width(dev, card, failures)
    phase_ladder(dev, failures)
    phase_workflow(dev, failures)
    if failures:
        raise SmokeFailure("phase 4: " + "; ".join(failures))
    return launches


def timed(label, fn, card):
    """fn() on the host clock, ending in a synchronize, and the peak of
    torch.cuda.max_memory_allocated over it: (result, s, GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"    {label}: {t * 1e3:.1f} ms, peak allocated {peak:.3f} GiB "
          f"({card})")
    return out, t, peak


def uqsa_results(sens) -> dict:
    """uncertainty(), sensitivity() and totaleffectvariance() as fp64 on the
    host."""
    out = {**sens.uncertainty(), **sens.sensitivity(),
           **sens.totaleffectvariance()}
    return {k: v.detach().double().cpu() for k, v in out.items()}


def uqsa_errors(r32, r64) -> dict:
    """fp32 against fp64 per quantity: relative to the largest fp64 value for
    E_EY, V_EY, V_i, V_Ti; absolute for the indices."""
    out = {}
    for q in UQSA_BUDGETS:
        err = float((r32[q] - r64[q]).abs().max())
        out[q] = err if q.startswith("S_") else err / float(r64[q].abs().max())
    return out


def index_checks(name, r, tol, failures):
    """S_i >= -tol, sum S_i <= 1 + tol, S_Ti >= S_i - tol."""
    si, sti = r["S_i"], r["S_Ti"]
    ok = (bool((si >= -tol).all()) and float(si.sum()) <= 1.0 + tol
          and bool((sti >= si - tol).all()))
    print(f"    {name}: min S_i {float(si.min()):.4g}, sum S_i "
          f"{float(si.sum()):.6f}, min(S_Ti - S_i) {float((sti - si).min()):.3e}"
          f" (tolerance {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: index inequalities")


def uqsa_emulator(dev, dtype, nugget):
    """Phase 3's emulator (n = 16384 training rows, delta 0.8, data of
    `problem`), fit at those hyperparameters and `nugget` in `dtype`."""
    x_np, y_np = problem(N_TRAIN + N_VALID)
    emul = Emulator.from_arrays(x_np, y_np, tv_config=(65, 64, 1), dtype=dtype,
                                device=dev, seed=0)
    emul.params = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0,
                                    np.log(nugget), device=dev, dtype=dtype)
    emul.state = gp.fit(emul.params, *emul.train_view())
    return emul


@contextlib.contextmanager
def _tf32_matmul():
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def tf32_products(fn):
    """fn() with every `fp32_exact` region of the port (the decorator reads
    `precision.fp32_exact_matmul` at each call) running TF32 products: the
    error that `fp32_exact` exists to prevent."""
    saved = precision.fp32_exact_matmul
    precision.fp32_exact_matmul = _tf32_matmul
    try:
        return fn()
    finally:
        precision.fp32_exact_matmul = saved


def uqsa_run(dev, card, dtype, nugget, timed_steps=False, ainv=None):
    """sensitivity.setup and the indices of `uqsa_emulator` in `dtype`.
    fp64: (results, {"kappa": kappa(A) of the factored matrix, "ainv": A^-1
    rounded to fp32, on the host}). fp32: (results, {control: results}) for the controls
    (the Gram-product log rho; every product in TF32) and, given `ainv`, the
    same workflow with that A^-1 in place of the fp32 one. With
    `timed_steps`, every step of the workflow is timed and printed with its
    peak memory."""
    emul = uqsa_emulator(dev, dtype, nugget)
    m, v = np.full(DIM, UQSA_M), np.full(DIM, UQSA_V)

    def run(label, fn):
        return timed(label, fn, card)[0] if timed_steps else fn()

    sens = run("setup (A^-1)", lambda: sensitivity.setup(emul, m, v))
    if timed_steps:
        for label, fn in (
                ("uncertainty() (the total: 1 subset of 8 dims)",
                 sens.uncertainty),
                ("sensitivity() (8 subsets of 1 dim)", sens.sensitivity),
                ("totaleffectvariance() (8 complements of 7 dims)",
                 sens.totaleffectvariance),
                ("main_effect(0, 100)", lambda: sens.main_effect(0, 100)),
                ("interaction_effect(0, 1, 25)",
                 lambda: sens.interaction_effect(0, 1, 25))):
            out = run(label, fn)
            vals = out.values() if isinstance(out, dict) else out
            if not all(bool(torch.isfinite(a).all()) for a in vals):
                raise SmokeFailure(f"(a) {dtype} {label}: non-finite values")
    res = uqsa_results(sens)
    if dtype == torch.float64:
        a64 = kernels.corr_self(emul.train_view()[0], emul.params)
        a64.diagonal().add_(emul.state.jitter)
        # held on the host, out of the fp32 run's peak memory
        other = {"kappa": float(kappa_fp64(a64)),
                 "ainv": sens.ainv.float().cpu()}
        del a64
    else:
        sens._log_rho_sum = gram_log_rho_sum.__get__(sens)
        sens._total = None
        other = {"Gram log rho": uqsa_results(sens)}
        del sens
        other["TF32 products"] = tf32_products(
            lambda: uqsa_results(sensitivity.setup(emul, m, v)))
        if ainv is not None:
            sens = sensitivity.setup(emul, m, v)
            sens.ainv = ainv.to(dev)
            other["A^-1 from fp64"] = uqsa_results(sens)
    del sens, emul
    torch.cuda.empty_cache()
    return res, other


def phase_uqsa_serving_width(dev, card, failures):
    """(a) UQSA of phase 3's emulator in fp32 and fp64 on the card, each step
    timed with its peak memory; fp32 held against fp64 at the serving nugget
    and at larger ones (smaller kappa(A)), beside two controls."""
    runs = {}
    for dtype in (torch.float64, torch.float32):
        print(f"  (a) UQSA at n={N_TRAIN}, d={DIM}, {str(dtype)[6:]}, nugget "
              f"{NUGGET:g}, m={UQSA_M}, v={UQSA_V}:")
        ainv = runs[torch.float64][1].pop("ainv") if runs else None
        runs[dtype] = uqsa_run(dev, card, dtype, NUGGET, True, ainv)
    print("    fp32 vs fp64 per quantity (E_EY, V_EY, V_i, V_Ti relative; "
          "S_i, S_Ti absolute): error | budget | controls: Gram log rho, "
          "TF32 products | fp32 with A^-1 from fp64")
    caught_any, findings = False, []
    for nugget in UQSA_SWEEP_NUGGETS + (NUGGET,):
        if nugget == NUGGET:
            (r64, o64), (r32, o32) = runs[torch.float64], runs[torch.float32]
        else:
            r64, o64 = uqsa_run(dev, card, torch.float64, nugget)
            r32, o32 = uqsa_run(dev, card, torch.float32, nugget,
                                ainv=o64.pop("ainv"))
        kappa = o64["kappa"]
        k = kappa * EPS32
        budgets = {q: min(max(c * k, floor), cap)
                   for q, (c, floor, cap) in UQSA_BUDGETS.items()}
        held = all(c * k <= cap for c, _, cap in UQSA_BUDGETS.values())
        errs = uqsa_errors(r32, r64)
        other = {name: uqsa_errors(r, r64) for name, r in o32.items()}
        over = [q for q in UQSA_BUDGETS if errs[q] > budgets[q]]
        caught = [q for q in UQSA_BUDGETS
                  if other["TF32 products"][q] > budgets[q]]
        print(f"    nugget {nugget:g}: kappa(A) {kappa:.4g}, kappa eps32 "
              f"{k:.4g}, {'held' if held else 'reported'}; fp64 E_VarY "
              f"{float(r64['E_VarY']):.8g}, V_EY {float(r64['V_EY']):.6g}")
        for q in UQSA_BUDGETS:
            print(f"      {q}: {errs[q]:.3e} | {budgets[q]:.3e} | "
                  f"{other['Gram log rho'][q]:.3e}, "
                  f"{other['TF32 products'][q]:.3e} | "
                  f"{other['A^-1 from fp64'][q]:.3e}"
                  f"{'  over' if q in over else ''}")
        index_checks(f"nugget {nugget:g} fp64", r64, budgets["S_i"], failures)
        if held:
            print(f"      TF32 control over budget in {caught}")
            caught_any |= bool(caught)
            if over:
                failures.append(f"(a) nugget {nugget:g}: fp32 vs fp64 over "
                                f"budget in {over}")
            index_checks(f"nugget {nugget:g} fp32", r32, budgets["S_i"],
                         failures)
        elif over:
            findings.append(f"nugget {nugget:g} (kappa {kappa:.3g}): {over}")
    if not caught_any:
        failures.append("(a) no budget caught the TF32 control")
    for name, r in (("fp32", r32), ("fp64", r64),
                    ("fp32, A^-1 from fp64", o32["A^-1 from fp64"])):
        print(f"    nugget {NUGGET:g} {name} S_i  "
              f"{np.round(r['S_i'].numpy(), 5).tolist()}")
        print(f"    nugget {NUGGET:g} {name} S_Ti "
              f"{np.round(r['S_Ti'].numpy(), 5).tolist()}")
    for f in findings:
        print(f"    FINDING: fp32 UQSA misses its budgets where they exceed "
              f"the caps, at {f} ({card})")


def smooth_g(x):
    """examples/synthetic-10d/run_10d.py's simulator."""
    b = 0.8 / (1.0 + G10_A_COEF)
    return np.prod(1.0 + b * np.cos(2 * np.pi * x), axis=1)


_ORACLE = None


def oracle_call(name, args):
    """tests/oracle.py's `name`(*args), the module loaded by its path (it is
    plain NumPy); run in worker processes."""
    global _ORACLE
    if _ORACLE is None:
        path = Path(__file__).resolve().parent / "tests" / "oracle.py"
        spec = importlib.util.spec_from_file_location("oracle", path)
        _ORACLE = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_ORACLE)
    return getattr(_ORACLE, name)(*args)


def phase_uqsa_config3(dev, card, pool):
    """(b) BASELINE config 3 as run_10d.py runs it, fp64 on the card:
    optLatinHyperCube -> Emulator.from_arrays -> train_full -> setup. The
    oracle's evaluations at the trained hyperparameters go to `pool`;
    returns what `hold_config3` needs."""
    print(f"  (b) BASELINE config 3: n={G10_N}, d={G10_DIM}, fp64, "
          f"tries={G10_TRIES}, {G10_MAX_ITERS} L-BFGS iterations ({card})")
    x, _, _ = timed(
        f"optLatinHyperCube({G10_DIM}, {G10_N}, {G10_CANDIDATES})",
        lambda: optLatinHyperCube(G10_DIM, G10_N, G10_CANDIDATES,
                                  [[0.0, 1.0]] * G10_DIM, seed=0, device=dev),
        card)
    y = smooth_g(x)
    emul = Emulator.from_arrays(x, y, tries=G10_TRIES, nugget=1e-8,
                                scale_inputs=False, seed=0,
                                tv_config=(10, 0, 1), dtype=torch.float64,
                                device=dev)
    emul.mle_config = dataclasses.replace(emul.mle_config,
                                          max_iters=G10_MAX_ITERS)
    timed("train_full()", emul.train_full, card)
    m, v = np.full(G10_DIM, UQSA_M), np.full(G10_DIM, UQSA_V)
    sens, _, _ = timed("setup", lambda: sensitivity.setup(emul, m, v), card)
    r, _, _ = timed("uncertainty + sensitivity + totaleffectvariance",
                    lambda: uqsa_results(sens), card)
    xt, yt, _ = emul.train_view()
    xt, yt = xt.cpu().numpy(), yt.cpu().numpy()
    delta = torch.exp(emul.params.log_delta).cpu().numpy()
    nugget = float(emul.params.nugget) + float(emul.state.jitter)
    h_cols = [None] + list(emul.spec.linear_dims)
    base = (xt, yt, h_cols, delta, nugget, m, v)
    print(f"    trained delta {np.round(delta, 4).tolist()}, nugget + jitter "
          f"{nugget:.3g}, NLL {float(emul.state.nll):.8g}")
    everything = tuple(range(G10_DIM))
    subsets = ([(i,) for i in range(G10_DIM)] + [everything]
               + [tuple(j for j in everything if j != i)
                  for i in range(G10_DIM)])
    jobs = {"uncertainty": pool.submit(oracle_call, "uqsa_uncertainty", base)}
    for w in subsets:
        jobs[w] = pool.submit(oracle_call, "uqsa_sensitivity_variance",
                              base + (w,))
    del sens, emul
    torch.cuda.empty_cache()
    return r, jobs, subsets


def hold_config3(r, jobs, subsets, failures):
    """(b)'s results against tests/oracle.py at rtol ORACLE_RTOL; S_i and
    S_Ti beside the g-function's order of importance."""
    t0 = time.perf_counter()
    m0, v0 = jobs["uncertainty"].result()
    sv_ = {w: jobs[w].result() for w in subsets}
    d = G10_DIM
    total = sv_[tuple(range(d))]
    want = {"E_EY": [m0], "V_EY": [v0], "E_VarY": [total],
            "V_i": [sv_[(i,)] for i in range(d)],
            "V_Ti": [total - sv_[tuple(j for j in range(d) if j != i)]
                     for i in range(d)]}
    print(f"  (b) against tests/oracle.py (waited {time.perf_counter() - t0:.1f}"
          f" s for the worker processes):")
    for q, w in want.items():
        got = np.atleast_1d(r[q].numpy())
        w = np.asarray(w)
        rel = float(np.max(np.abs(got - w) / np.abs(w)))
        ok = rel <= ORACLE_RTOL
        print(f"    {q}: max rel err {rel:.3e} (rtol {ORACLE_RTOL:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"(b) {q} vs oracle: {rel:.3e}")
    order = np.argsort(G10_A_COEF)
    print(f"    S_i  {np.round(r['S_i'].numpy(), 4).tolist()}")
    print(f"    S_Ti {np.round(r['S_Ti'].numpy(), 4).tolist()}")
    print(f"    inputs by S_Ti {np.argsort(-r['S_Ti'].numpy()).tolist()}; the "
          f"g-function's order (a = {G10_A_COEF.tolist()}): {order.tolist()}")


def phase_uqsa_multi(dev, card, failures):
    """(c) MultiEmulator at the fit size, fp32 (K1): k outputs x tries
    restarts in one batch, against a single-output mle_fit from the same
    starts, then sense_matrix and a prediction (K2)."""
    x_np, y0 = problem(N_FIT)
    y = np.stack([y0, np.cos(2 * x_np[:, 3]) + x_np[:, 4] * x_np[:, 5],
                  x_np[:, 0] + x_np[:, 6] ** 2], axis=1).astype(np.float32)
    cfg = lbfgs.MLEConfig(tries=MULTI_TRIES, nugget=NUGGET,
                          max_iters=MULTI_MAX_ITERS)
    print(f"  (c) MultiEmulator: n={N_FIT}, d={DIM}, k={MULTI_K} outputs x "
          f"{MULTI_TRIES} restarts, {MULTI_MAX_ITERS} L-BFGS iterations, fp32")
    k1_0 = counters()["K1"]
    with _NllCalls() as calls:
        me, _, _ = timed("MultiEmulator.fit", lambda: MultiEmulator.fit(
            torch.Generator().manual_seed(0), x_np, y, cfg=cfg,
            dtype=torch.float32, device=dev), card)
    k1 = counters()["K1"] - k1_0
    print(f"    {calls.calls} objective calls holding {calls.rows} restart "
          f"evaluations; K1 launches {k1}; iterations "
          f"{me.info['iters'].tolist()}")
    if k1 <= 0:
        failures.append("(c) MultiEmulator.fit did not launch K1")
    with _NllCalls() as calls1:
        (_, info), _, _ = timed("mle_fit, output 0 alone", lambda: lbfgs.mle_fit(
            torch.Generator().manual_seed(0), me.x, me.y[:, 0], me.h, cfg),
            card)
    # the first evaluation, at the starts: output 0's rows of the batched
    # objective (y one row a restart) against the single-output objective
    lo, hi = lbfgs._default_bounds(cfg, DIM)
    u0 = lbfgs._make_objective(me.x, me.y[:, 0], me.h, cfg, lo, hi)[2](
        me.info["starts_logspace"])
    with torch.no_grad():
        v_k = lbfgs._make_objective(
            me.x, me.y.T.repeat_interleave(MULTI_TRIES, 0), me.h, cfg, lo,
            hi)[0](u0.repeat(MULTI_K, 1))[:MULTI_TRIES]
        v_1 = lbfgs._make_objective(me.x, me.y[:, 0], me.h, cfg, lo, hi)[0](u0)
    print(f"    NLL at the starts, output 0: batched {v_k.tolist()}, alone "
          f"{v_1.tolist()}; bitwise equal: {torch.equal(v_k, v_1)}")
    if not torch.allclose(v_k, v_1, rtol=NLL_FLOOR, atol=0.0):
        failures.append("(c) the batched objective's rows differ from the "
                        "single-output objective at the starts")
    # and at the fitted parameters (batched K1 at 3 restarts against one)
    with torch.no_grad():
        v_k = gp.nll(me.params, me.x, me.y.T, me.h, mode=cfg.mode)[0]
        v_1 = gp.nll(kernels.GPParams(*(t[0] for t in me.params)), me.x,
                     me.y[:, 0], me.h, mode=cfg.mode)
    print(f"    NLL at output 0's fitted parameters: batched {float(v_k)!r}, "
          f"alone {float(v_1)!r}")
    if not torch.allclose(v_k, v_1, rtol=NLL_FLOOR, atol=0.0):
        failures.append("(c) the batched NLL differs from the single-output "
                        "NLL at the fitted parameters")
    # fp32: the runs' ends are printed, not held; fp64 below holds them
    best = [float(me.info["nlls"][i].min()) for i in range(MULTI_K)]
    single = float(info["best_nll"])
    print(f"    best NLL per output {best}; output 0 alone {single:.8g} "
          f"({calls1.calls} calls, iterations {info['iters'].tolist()}): "
          f"difference {best[0] - single:.4g}")
    if not np.isfinite(best).all():
        failures.append(f"(c) best NLLs {best}")
    multi_rows_fp64(dev, x_np, y, cfg, card, failures)
    smat, _, _ = timed("sense_matrix", lambda: me.sense_matrix(
        np.full(DIM, UQSA_M), np.full(DIM, UQSA_V)), card)
    for i, row in enumerate(smat):
        print(f"      output {i}: S_i {np.round(row, 4).tolist()}")
    xq = np.random.default_rng(2).uniform(size=(1000, DIM))
    (mean, var), _, _ = timed("predict(m=1000)", lambda: me.predict(xq), card)
    ok = (np.isfinite(smat).all() and bool(torch.isfinite(mean).all())
          and bool(torch.isfinite(var).all()) and float(var.min()) >= 0
          and tuple(mean.shape) == (MULTI_K, 1000))
    if not ok:
        failures.append("(c) non-finite or misshapen sense_matrix/predict")
    del me
    torch.cuda.empty_cache()


def multi_rows_fp64(dev, x_np, y, cfg, card, failures):
    """(c)'s batched fit and its single-output run again in fp64 on the
    card: the rows of the outputs x restarts batch must end where output
    0's restarts end alone (rtol MULTI_ROWS_RTOL, the same iteration
    counts). fp64 rounding cannot steer 8 iterations apart, so a coupling
    of the rows (in the lockstep L-BFGS, the batched Cholesky or its
    ladder) would show here."""
    me, _, _ = timed("fp64 MultiEmulator.fit", lambda: MultiEmulator.fit(
        torch.Generator().manual_seed(0), x_np, y.astype(np.float64),
        cfg=cfg, dtype=torch.float64, device=dev), card)
    (_, info), _, _ = timed("fp64 mle_fit, output 0 alone", lambda:
                            lbfgs.mle_fit(torch.Generator().manual_seed(0),
                                          me.x, me.y[:, 0], me.h, cfg), card)
    rows, alone = me.info["nlls"][0].cpu(), info["nlls"].cpu()
    rel = float(((rows - alone).abs() / alone.abs()).max())
    same_iters = torch.equal(me.info["iters"][0].cpu(), info["iters"].cpu())
    ok = rel <= MULTI_ROWS_RTOL and same_iters
    print(f"    fp64, output 0's restarts: batched {rows.tolist()}, alone "
          f"{alone.tolist()}; max rel difference {rel:.3e} (rtol "
          f"{MULTI_ROWS_RTOL:g}); iterations equal: {same_iters} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"(c) fp64 batched rows differ from output 0 alone "
                        f"({rel:.3e})")
    del me
    torch.cuda.empty_cache()


def phase_uqsa(dev, card):
    """Phase 5: the UQSA path. (b)'s oracle runs in worker processes while
    (a) and (c) use the card. Every check is collected and the phase fails
    at its end if any failed."""
    print(f"[phase 5] UQSA path ({card})")
    failures = []
    reset_counters()
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    t0 = time.perf_counter()
    parts = {}
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        try:
            r10, jobs, subsets = phase_uqsa_config3(dev, card, pool)
            parts["(b) on the card"] = time.perf_counter()
            phase_uqsa_serving_width(dev, card, failures)
            parts["(a)"] = time.perf_counter()
            phase_uqsa_multi(dev, card, failures)
            parts["(c)"] = time.perf_counter()
            hold_config3(r10, jobs, subsets, failures)
            parts["(b) against the oracle"] = time.perf_counter()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    launches = counters()
    print(f"  launches in phase 5: {launches}")
    t = t0
    spans = []
    for name, end in parts.items():
        spans.append(f"{name} {end - t:.1f} s")
        t = end
    print(f"  phase 5 took {time.perf_counter() - t0:.1f} s on the host "
          f"clock: {', '.join(spans)}")
    if failures:
        raise SmokeFailure("phase 5: " + "; ".join(failures))
    return launches


def _sum_counts(all_counts):
    """The step functions' counts (inference.nuts.new_counts) added up, as
    Python numbers."""
    total = {}
    for counts in all_counts:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + (int(v) if torch.is_tensor(v) else v)
    return total


def hold_logdensity(ld32, x, y, h, cfg, z0, failures):
    """The batched log density and its gradient at the chains' starts,
    fp32 (K1, the analytic adjoint) against fp64 on the card, within phase
    4's kappa(A) budgets, beside the TF32-backward control (printed)."""
    x64, y64, h64 = x.double(), y.double(), h.double()
    ld64 = hmc.make_gp_logdensity(x64, y64, h64, cfg)
    v32, g32 = hmc.value_and_grad(ld32, z0)
    v64, g64 = hmc.value_and_grad(ld64, z0.double())
    with torch.no_grad():
        params = lbfgs._unpack(z0.double(), cfg, x.shape[1], torch.float64)
        kappa = kappa_fp64(kernels.corr_self(x64, params))
    ctrl = value_and_grad_tf32_backward(ld32, z0)[1]
    nll_err, grad_err = rel_errors(v32, g32, v64, g64)
    nll_b, grad_b = fp32_budgets(kappa)
    ctrl_err = rel_errors(v32, ctrl, v64, g64)[1]
    print(f"    log density at the {z0.shape[0]} starts, fp32 vs fp64: "
          f"kappa(A) {float(kappa.min()):.3e} to {float(kappa.max()):.3e}; "
          f"worst value err / budget {float((nll_err / nll_b).max()):.3f}, "
          f"worst gradient err / budget {float((grad_err / grad_b).max()):.3f}"
          f" (gradient err up to {float(grad_err.max()):.3e}); control, TF32 "
          f"backward: worst gradient err / budget "
          f"{float((ctrl_err / grad_b).max()):.3f}, over budget at "
          f"{int((ctrl_err > grad_b).sum())} starts")
    if not bool(torch.isfinite(v64).all() & (v64 > -1e11).all()):
        failures.append("(a) the fp64 log density failed at a start")
    bad = (nll_err > nll_b) | (grad_err > grad_b)
    if bool(bad.any()):
        failures.append(f"(a) log density fp32 vs fp64 over budget at starts "
                        f"{torch.nonzero(bad).flatten().tolist()}")
    # printed, not required to break a budget: at n = 1024 the TF32
    # backward's error stays well inside the kappa(A) budgets (PERF.md §6)


def bayes_config4(dev, card, failures):
    """(a) BASELINE config 4 on one card: NUTS warmup, checkpointed
    segments, a bitwise rerun, the statistics and the costs; then a short
    HMC run, printed and not held."""
    x, y, h, cfg = roofline.gp_test_posterior(BAYES_N, BAYES_D, torch.float32,
                                              dev)
    ld32 = hmc.make_gp_logdensity(x, y, h, cfg)
    tf32_seen = set()

    def ld(z):
        tf32_seen.add(torch.backends.cuda.matmul.allow_tf32)
        return ld32(z)

    gen = torch.Generator(device=dev).manual_seed(0)
    z0 = BAYES_START_SD * torch.randn((BAYES_CHAINS, BAYES_D), generator=gen,
                                      device=dev)
    print(f"  (a) BASELINE config 4: n={BAYES_N}, d={BAYES_D}, fp32, "
          f"{BAYES_CHAINS} chains, NUTS ({card})")
    hold_logdensity(ld32, x, y, h, cfg, z0, failures)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_chain_"))
    try:
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        warm, wstats = nuts.nuts_sample(
            gen, ld, z0, hmc.HMCConfig(n_warmup=BAYES_WARMUP, n_samples=1),
            max_depth=BAYES_WARMUP_DEPTH)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        state = tmp / "state"
        save_hmc_state(state, warm[:, -1], wstats["step_size"],
                       wstats["inv_mass"], gen, meta={"segments_done": 0})
        segments, seg_ms, seg_stats, seg_counts = [], [], [], []
        for k in range(BAYES_SEGMENTS):
            z, eps, im, g, meta = load_hmc_state(state, device=dev)
            if meta["segments_done"] != k:
                failures.append(f"(a) checkpoint meta {meta} at segment {k}")
            if k == BAYES_RERUN_SEGMENT:
                for suffix in (".npz", ".json"):
                    shutil.copy(state.with_suffix(suffix),
                                (tmp / "rerun").with_suffix(suffix))
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            zs, st, g = nuts.nuts_continue(g, ld, z, eps, im,
                                           BAYES_SEGMENT_DRAWS,
                                           max_depth=BAYES_DEPTH)
            stop.record()
            stop.synchronize()
            seg_ms.append(start.elapsed_time(stop))
            segments.append(zs)
            seg_stats.append(st)
            seg_counts.append(st["counts"])
            save_hmc_state(state, zs[:, -1], eps, im, g,
                           meta={"segments_done": k + 1})
        launches = counters()
        # the rerun of one segment from its checkpoint
        z, eps, im, g, _ = load_hmc_state(tmp / "rerun", device=dev)
        rerun, _, _ = nuts.nuts_continue(g, ld, z, eps, im,
                                         BAYES_SEGMENT_DRAWS,
                                         max_depth=BAYES_DEPTH)
        same = torch.equal(rerun, segments[BAYES_RERUN_SEGMENT])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    draws = torch.cat(segments, 1)
    warm_counts = _sum_counts([wstats["counts"]])
    counts = _sum_counts(seg_counts)
    n_draws = BAYES_SEGMENTS * BAYES_SEGMENT_DRAWS
    sampling_s = sum(seg_ms) / 1e3
    e = hmc.ess(draws.double())
    rhat = hmc.split_rhat(draws.double())
    accept = float(torch.stack([st["accept_rate"] for st in seg_stats]).mean())
    div = float(torch.stack([st["divergence_rate"]
                             for st in seg_stats]).mean())
    evals = warm_counts["evaluations"] + counts["evaluations"]
    # one batched leapfrog and one evaluation, CUDA events (median of 5)
    zl = draws[:, -1]
    v0, g0 = hmc.value_and_grad(ld32, zl)
    p = torch.randn(zl.shape, generator=gen, device=dev)
    leap_ms, _ = time_ms(lambda: hmc._leapfrog(
        lambda z: hmc.value_and_grad(ld32, z), zl, p, v0, g0, im, eps, 1))
    eval_ms, _ = time_ms(lambda: hmc.value_and_grad(ld32, zl))
    print(f"    warmup: {BAYES_WARMUP} draws at depth {BAYES_WARMUP_DEPTH} in "
          f"{warm_s:.2f} s ({warm_counts['evaluations']} evaluations); "
          f"step size {float(wstats['step_size']):.4g}, inverse mass "
          f"{[round(v, 4) for v in wstats['inv_mass'].tolist()]}")
    print(f"    sampling: {n_draws} draws x {BAYES_CHAINS} chains at depth "
          f"{BAYES_DEPTH} in {BAYES_SEGMENTS} checkpointed segments, "
          f"{sampling_s:.3f} s (CUDA events; segments "
          f"{[round(t / 1e3, 2) for t in seg_ms]} s): "
          f"{BAYES_CHAINS * n_draws / sampling_s:.1f} post-warmup draws/s "
          f"({card})")
    print(f"    ESS min {e.min():.1f}, median {np.median(e):.1f} of "
          f"{BAYES_CHAINS * n_draws}; min ESS/s {e.min() / sampling_s:.2f}; "
          f"max split R-hat {float(rhat.max()):.4f}; accept rate {accept:.3f}; "
          f"divergence rate {div:.4f}")
    per_draw = lambda key: counts[key] / counts["transitions"]
    useful, slots = counts["useful_chain_leaves"], counts["chain_leaves"]
    print(f"    per draw: {per_draw('evaluations'):.2f} evaluations (leaves "
          f"+ 1), {per_draw('host_syncs'):.2f} host syncs, mean tree depth "
          f"{per_draw('tree_depths') / BAYES_CHAINS:.2f}; useful "
          f"chain-leaves {useful} of {slots} evaluated "
          f"({100 * useful / slots:.1f}%)")
    print(f"    one batched leapfrog ({BAYES_CHAINS} chains x n={BAYES_N}): "
          f"{leap_ms:.3f} ms; one value and gradient {eval_ms:.3f} ms (CUDA "
          f"events, median of 5); launches in the window (warmup and "
          f"segments): {launches}; {evals} evaluations; TF32 flag inside "
          f"the sampler loop: {sorted(tf32_seen)}")
    print(f"    segment {BAYES_RERUN_SEGMENT} rerun from its checkpoint: "
          f"bitwise equal {same}")
    breakdown = evaluation_breakdown(
        f"one log-density evaluation, {BAYES_CHAINS} chains, n={BAYES_N}, "
        f"fp32", ld32, zl, card)
    if not same:
        failures.append("(a) the segment rerun from its checkpoint differs")
    if not bool(torch.isfinite(draws).all()):
        failures.append("(a) non-finite draws")
    eps_f = float(wstats["step_size"])
    if not (math.isfinite(eps_f) and eps_f > 0):
        failures.append(f"(a) step size {eps_f}")
    im_w = wstats["inv_mass"]
    if not bool((torch.isfinite(im_w) & (im_w > 0)).all()):
        failures.append(f"(a) inverse mass {im_w.tolist()}")
    if tf32_seen != {False}:
        failures.append(f"(a) TF32 on inside the sampler loop: {tf32_seen}")
    if launches["K1"] != BAYES_CHAINS * evals:
        failures.append(f"(a) K1 launched {launches['K1']} times for "
                        f"{evals} evaluations of {BAYES_CHAINS} chains")

    # HMC for its path and timing; it does not converge on this posterior
    # in so few draws (docs/samplers.md), so its statistics are not held
    gen_h = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs, hst = hmc.hmc_sample(gen_h, ld32, z0, hmc.HMCConfig(
        n_warmup=HMC_WARMUP, n_samples=HMC_DRAWS, n_leapfrog=HMC_LEAPFROG))
    torch.cuda.synchronize()
    hmc_s = time.perf_counter() - t0
    he = hmc.ess(hs.double())
    hmc_evals = (HMC_WARMUP + HMC_DRAWS) * (HMC_LEAPFROG + 1)
    print(f"    HMC, {HMC_LEAPFROG} leapfrogs, {HMC_WARMUP} + {HMC_DRAWS} "
          f"draws: {hmc_s:.2f} s ({hmc_evals} evaluations); accept rate {float(hst['accept_rate']):.3f}, "
          f"divergence rate {float(hst['divergence_rate']):.4f}, ESS min "
          f"{he.min():.1f}, max split R-hat "
          f"{float(hmc.split_rhat(hs.double()).max()):.3f} (not held)")
    if not bool(torch.isfinite(hs).all()):
        failures.append("(a) HMC: non-finite draws")
    return {"x": x, "y": y, "draws": draws, "launches": launches,
            "breakdown": breakdown}


def _quadrature(ld, lo, hi, k):
    """Weights of the log density on a k x k grid of [lo, hi]: (points,
    mean, sd, weight on the rim), fp64 moments of fp32 evaluations in
    chunks of QUAD_CHUNK points."""
    dev = lo.device
    axes = [torch.linspace(float(lo[i]), float(hi[i]), k, dtype=torch.float64,
                           device=dev) for i in range(2)]
    pts = torch.cartesian_prod(*axes)
    with torch.no_grad():
        logp = torch.cat([ld(c.float()) for c in pts.split(QUAD_CHUNK)])
    logp = logp.double()
    w = torch.exp(logp - logp.max())
    w = w / w.sum()
    mean = w @ pts
    sd = torch.sqrt(w @ (pts - mean) ** 2)
    rim = ((pts[:, 0] == axes[0][0]) | (pts[:, 0] == axes[0][-1])
           | (pts[:, 1] == axes[1][0]) | (pts[:, 1] == axes[1][-1]))
    return mean, sd, float(w[rim].sum())


def bayes_quadrature(dev, card, failures):
    """(b) NUTS on a d = 2 GP posterior (n = 512, fp32) against a
    quadrature of the same log density on the card."""
    rng = np.random.default_rng(5)
    x_np = rng.uniform(size=(QUAD_N, 2))
    a = np.exp(-(((x_np[:, None, :] - x_np[None, :, :])
                  / np.array([0.4, 0.7])) ** 2).sum(-1)) + 1e-6 * np.eye(QUAD_N)
    y_np = np.linalg.cholesky(a) @ rng.standard_normal(QUAD_N)
    x = torch.as_tensor(x_np, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y_np, dtype=torch.float32, device=dev)
    h = basis_matrix(x, linear_basis(2))
    ld = hmc.make_gp_logdensity(x, y, h, lbfgs.MLEConfig(nugget=NUGGET))
    gen = torch.Generator(device=dev).manual_seed(5)
    z0 = 0.1 * torch.randn((QUAD_CHAINS, 2), generator=gen, device=dev)
    t0 = time.perf_counter()
    samples, stats = nuts.nuts_sample(
        gen, ld, z0, hmc.HMCConfig(n_warmup=QUAD_WARMUP, n_samples=QUAD_DRAWS),
        max_depth=QUAD_DEPTH)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    draws = samples.double()
    # zoom in on the mass: three 40 x 40 grids, then the 80 x 80 one
    lo = torch.tensor([-4.0, -4.0], dtype=torch.float64, device=dev)
    hi = torch.tensor([3.0, 3.0], dtype=torch.float64, device=dev)
    t1 = time.perf_counter()
    for _ in range(3):
        mean, sd, _ = _quadrature(ld, lo, hi, 40)
        half = torch.maximum(7.0 * sd, 2.0 * (hi - lo) / 39)
        lo, hi = mean - half, mean + half
    q_mean, q_sd, rim = _quadrature(ld, lo, hi, QUAD_GRID)
    quad_s = time.perf_counter() - t1
    flat = draws.reshape(-1, 2)
    e = torch.as_tensor(hmc.ess(draws), device=dev)
    d_mean, d_sd = flat.mean(0), flat.std(0)
    mcse = d_sd / torch.sqrt(e)
    z_mean = (d_mean - q_mean).abs() / mcse
    z_sd = (d_sd - q_sd).abs() / mcse
    evals = stats["counts"]["evaluations"]
    print(f"  (b) NUTS on a d=2 posterior, n={QUAD_N}, fp32, {QUAD_CHAINS} "
          f"chains, {QUAD_WARMUP} + {QUAD_DRAWS} draws: {run_s:.2f} s, "
          f"{evals} evaluations ({1e3 * run_s / evals:.2f} ms each); accept "
          f"{float(stats['accept_rate']):.3f}, divergences "
          f"{float(stats['divergence_rate']):.4f}, ESS "
          f"{[round(v, 1) for v in e.tolist()]}")
    print(f"    quadrature ({QUAD_GRID} x {QUAD_GRID} over {lo.tolist()} .. "
          f"{hi.tolist()}, rim weight {rim:.2e}, {quad_s:.2f} s): mean "
          f"{q_mean.tolist()}, sd {q_sd.tolist()}; draws: mean "
          f"{d_mean.tolist()}, sd {d_sd.tolist()}; |difference| / MCSE: mean "
          f"{z_mean.tolist()}, sd {z_sd.tolist()} (held to {QUAD_MCSE:g})")
    if rim > 1e-6:
        failures.append(f"(b) the quadrature's box misses mass: rim {rim:.2e}")
    if not bool(((z_mean < QUAD_MCSE) & (z_sd < QUAD_MCSE)).all()):
        failures.append("(b) draws off the quadrature by more than "
                        f"{QUAD_MCSE:g} MCSE")


def bayes_card_vs_cpu(dev, failures):
    """(c) One NUTS and one HMC transition, fp64, the same pre-drawn
    tensors on the card and on the CPU."""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    z = 0.3 * torch.randn((CPU_CHAINS, BAYES_D), generator=gen,
                          dtype=torch.float64)
    nd = nuts._nuts_draws(gen, z, CPU_DEPTH)
    noise, u = hmc._hmc_draws(gen, z)
    eps = torch.tensor(0.05, dtype=torch.float64)
    out = []
    for device in (cpu, dev):
        x, y, h, cfg = roofline.gp_test_posterior(CPU_N, BAYES_D,
                                                  torch.float64, device)
        ld = hmc.make_gp_logdensity(x, y, h, cfg)
        ld_grad = lambda zz, f=ld: hmc.value_and_grad(f, zz)
        im = torch.ones(BAYES_D, dtype=torch.float64, device=device)
        counts = nuts.new_counts()
        res_n = nuts._nuts_transition(
            ld_grad, z.to(device), nuts.NutsDraws(*(t.to(device) for t in nd)),
            eps.to(device), im, CPU_DEPTH, 1000.0, counts)
        res_h = hmc._hmc_transition(ld_grad, z.to(device), noise.to(device),
                                    u.to(device), eps.to(device), im,
                                    hmc.HMCConfig(n_leapfrog=HMC_LEAPFROG))
        out.append(([t.cpu() for t in res_n], [t.cpu() for t in res_h],
                    counts["leaves"], int(counts["useful_chain_leaves"])))
    (cn, ch, cl, cu), (gn, gh, gl, gu) = out
    z_err, acc_err = {}, {}
    for name, c, g in (("NUTS", cn, gn), ("HMC", ch, gh)):
        z_err[name] = float(((c[0] - g[0]).abs()
                             / c[0].abs().clamp(min=1e-300)).max())
        acc_err[name] = float((c[1] - g[1]).abs().max())
        if not torch.equal(c[2], g[2]):
            failures.append(f"(c) {name}: the divergence flags differ")
    print(f"  (c) card vs CPU, fp64, n={CPU_N}, {CPU_CHAINS} chains, from the "
          f"same draws: z relative difference {z_err} (held to "
          f"{CPU_RTOL:g}); accept statistic absolute difference {acc_err} "
          f"(held to {CPU_ACCEPT_ATOL:g}); NUTS leaves {gl} / {cl}, useful "
          f"chain-leaves {gu} / {cu}; divergent {int(cn[2].sum())} (NUTS), "
          f"{int(ch[2].sum())} (HMC)")
    if max(z_err.values()) > CPU_RTOL:
        failures.append(f"(c) card vs CPU z beyond {CPU_RTOL:g}: {z_err}")
    if max(acc_err.values()) > CPU_ACCEPT_ATOL:
        failures.append(f"(c) card vs CPU accept statistic beyond "
                        f"{CPU_ACCEPT_ATOL:g}: {acc_err}")
    if (gl, gu) != (cl, cu):
        failures.append("(c) the NUTS leaf counts differ")


def _mean_sigma2(emul, max_draws):
    """The fp64 sigma2 of the draws predict_bayes marginalizes over."""
    x, y, h = emul.train_view()
    flat = emul.hyper_samples.reshape(-1, emul.hyper_samples.shape[-1])
    flat = flat[::max(1, flat.shape[0] // max_draws)][:max_draws]
    s2 = [gp.fit(lbfgs._unpack(z, emul.mle_config, x.shape[1], x.dtype), x,
                 y, h).sigma2 for z in flat]
    return float(torch.stack(s2).mean())


def bayes_predict(dev, card, failures, a):
    """(d) Emulator.train_bayes -> predict_bayes at (a)'s data against the
    same draws in fp64; sample_posterior's moments against predict's."""
    x_np = a["x"].cpu().double().numpy()
    y_np = a["y"].cpu().double().numpy()
    centre = a["draws"].double().reshape(-1, BAYES_D).mean(0).cpu().numpy()
    emul = Emulator.from_arrays(x_np, y_np, tv_config=(8, 0, 1),
                                nugget=NUGGET, dtype=torch.float32,
                                device=dev, seed=0)
    emul.params = params_from_numpy(centre, 0.0, np.log(NUGGET), device=dev,
                                    dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = emul.train_bayes(n_chains=16, n_warmup=16, n_samples=8,
                             max_depth=4, generator=gen)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    xq = np.random.default_rng(8).uniform(size=(PRED_M, BAYES_D))
    t_pred, (mean, var) = time_ms(lambda: emul.predict_bayes(
        xq, max_draws=PRED_DRAWS), reps=3)
    ref = Emulator.from_arrays(x_np, y_np, tv_config=(8, 0, 1), nugget=NUGGET,
                               dtype=torch.float64, device=dev, seed=0)
    ref.n_folded = emul.n_folded
    ref.hyper_samples = emul.hyper_samples.double()
    m64, v64 = ref.predict_bayes(xq, max_draws=PRED_DRAWS)
    s64 = _mean_sigma2(ref, PRED_DRAWS)
    rel_mean = float((mean.double() - m64).abs().max() / m64.abs().max())
    rel_var = float((var.double() - v64).abs().max() / s64)
    print(f"  (d) train_bayes (16 chains, 16 + 8 draws, depth 4) {t_train:.2f} "
          f"s, accept {float(stats['accept_rate']):.3f}; predict_bayes with "
          f"{PRED_DRAWS} draws at m={PRED_M}: {t_pred:.2f} ms (CUDA events, "
          f"median of 3; {card}); against the same draws in fp64: mean rel "
          f"err {rel_mean:.3e} (< 1e-3), var err / sigma2 {rel_var:.3e} "
          f"(< 1e-2)")
    if not (rel_mean < 1e-3 and rel_var < 1e-2):
        failures.append("(d) predict_bayes fp32 disagrees with fp64")
    if not bool(torch.isfinite(mean).all() & (var >= 0).all()):
        failures.append("(d) predict_bayes: non-finite mean or negative var")

    x, y, h = emul.train_view()
    params = lbfgs._unpack(torch.as_tensor(centre, dtype=torch.float32,
                                           device=dev),
                           emul.mle_config, BAYES_D, torch.float32)
    state = gp.fit(params, x, y, h)
    xs, hs = emul._prepare_inputs(xq[:POST_M])
    t_post, draws = time_ms(lambda: gp.sample_posterior(
        torch.Generator(device=dev).manual_seed(9), state, x, h, xs, hs,
        POST_DRAWS), reps=3)
    pm, pc = gp.predict(state, x, h, xs, hs, full_cov=True)
    # the covariance the draws have: the t scale matrix with the jitter its
    # factor took (the ladder of gp.sample_posterior), times dof/(dof - 2)
    dof = x.shape[0] - h.shape[1]
    scale = pc * ((dof - 2.0) / dof)
    jitter = float(chol.cholesky_with_jitter(scale)[1])
    d64, pm, pc = draws.double(), pm.double(), pc.double()
    sampled = pc + jitter * dof / (dof - 2.0) * torch.eye(
        POST_M, dtype=torch.float64, device=dev)
    n = POST_DRAWS
    emp = torch.cov(d64.T)

    def worst(cov):
        sd = torch.sqrt(torch.diagonal(cov))
        z_m = float(((d64.mean(0) - pm).abs() / (sd / n ** 0.5)).max())
        se = torch.sqrt((torch.outer(sd ** 2, sd ** 2) + cov ** 2) / n)
        return z_m, float(((emp - cov).abs() / se).max())

    z_mean, z_cov = worst(sampled)
    diag = torch.diagonal(pc)
    print(f"    sample_posterior, m={POST_M}, {POST_DRAWS} draws: {t_post:.2f} "
          f"ms; the scale matrix's factor took jitter {jitter:.3e} (predictive "
          f"variances {float(diag.min()):.3e} to {float(diag.max()):.3e}); "
          f"against predict's covariance with that jitter: worst mean error "
          f"{z_mean:.2f} MCSE (held to {POST_MCSE:g}), worst covariance "
          f"error {z_cov:.2f} MCSE (held to {POST_COV_MCSE:g}); against "
          f"predict's covariance itself: {worst(pc)[1]:.2f} MCSE")
    if not bool(torch.isfinite(draws).all()):
        failures.append("(d) sample_posterior: non-finite draws")
    if z_mean > POST_MCSE or z_cov > POST_COV_MCSE:
        failures.append("(d) sample_posterior's moments are off predict's")


def phase_bayes(dev, card):
    """Phase 6: the Bayesian path. Every check is collected and the phase
    fails at its end if any failed. Its launches are counted over the whole
    phase; (a) prints its own window."""
    print(f"[phase 6] Bayesian path ({card})")
    failures = []
    reset_counters()
    t0 = time.perf_counter()
    parts = {}
    a = bayes_config4(dev, card, failures)
    parts["(a)"] = time.perf_counter()
    bayes_quadrature(dev, card, failures)
    parts["(b)"] = time.perf_counter()
    bayes_card_vs_cpu(dev, failures)
    parts["(c)"] = time.perf_counter()
    bayes_predict(dev, card, failures, a)
    parts["(d)"] = time.perf_counter()
    res = sampler_compare.compare(n_warmup=20, n_samples=20, n_leapfrog=8,
                                  max_depth=4)
    print(f"  (e) sampler_compare.compare(n_warmup=20, n_samples=20, "
          f"n_leapfrog=8, max_depth=4): {json.dumps(res)}")
    parts["(e)"] = time.perf_counter()
    launches = counters()
    print(f"  launches in phase 6: {launches}")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        failures.append(f"phase 6: K1 and K2 must launch: {launches}")
    t = t0
    spans = []
    for name, end in parts.items():
        spans.append(f"{name} {end - t:.1f} s")
        t = end
    print(f"  phase 6 took {time.perf_counter() - t0:.1f} s on the host "
          f"clock: {', '.join(spans)}")
    if failures:
        raise SmokeFailure("phase 6: " + "; ".join(failures))
    return launches


# ----- phase 7: the matrix-free path and the noise fit ----------------------

def mf_simulator(x):
    """examples/matrix-free/run_matrix_free.py's simulator."""
    return (np.sin(3 * x[:, 0]) + np.sin(2 * x[:, 1])
            + 0.3 * x[:, 0] * x[:, 1])


def mf_data(n, m, dev):
    """The example's data rule (seed 0): x ~ U[0,1]^2, y = simulator +
    0.05 N(0,1), then m queries; fp32 on dev. (x, y, h, xs, hs, the
    noiseless simulator at xs)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(n, 2))
    y = mf_simulator(x) + MF_NOISE_SD * rng.standard_normal(n)
    xs = rng.uniform(size=(m, 2))
    spec = linear_basis(2)
    tx = torch.as_tensor(x, dtype=torch.float32, device=dev)
    txs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    return (tx, torch.as_tensor(y, dtype=torch.float32, device=dev),
            basis_matrix(tx, spec), txs, basis_matrix(txs, spec),
            mf_simulator(xs))


class _Spans:
    """Wraps functions of a module: host-clock seconds of their calls
    (synchronized at both ends), call counts, and what cg_solve returned."""

    def __init__(self, module, names):
        self.module, self.names = module, names

    def __enter__(self):
        self.seconds = {name: 0.0 for name in self.names}
        self.calls = {name: 0 for name in self.names}
        self.cg = []
        self._saved = {name: getattr(self.module, name) for name in self.names}
        for name, fn in self._saved.items():
            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                self.calls[_name] += 1
                if _name == "cg_solve":
                    self.cg.append(out[1])
                return out
            setattr(self.module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.module, name, fn)


_MF_EVAL_PARTS = ("pivoted_cholesky", "woodbury_ops", "cg_solve",
                  "slq_logdet_preconditioned_from_probes", "_grad_log_delta")


def _cg_text(infos):
    iters = [i["iters"] for i in infos]
    syncs = [i["host_syncs"] for i in infos]
    resid = max(float(i["rel_resid"].max()) for i in infos)
    return iters, syncs, resid


def _k3_one_segment(xq, x, delta, v):
    """K3's C entry point forced to one segment: no (segments, m, r)
    partial buffer and no fold of it."""
    xs, xt = sv._scaled(xq, x, delta)
    out = torch.zeros((xq.shape[0], v.shape[1]), dtype=torch.float32,
                      device=xq.device)
    _build.check(sv._launch_matvec(xs, xt, v.contiguous(), out, segments=1),
                 sv._MATVEC_SOURCE, "corr_matvec")
    return out


def mf_k3_check(what, xq, x, p32, v, label, failures):
    """K3 at the matrix-free path's call: m = xq's rows, n = x's, r = v's
    columns. make_corr_matvec (xq is x: CG and Lanczos, with the nugget
    shift) or corr_times (the served mean) launches K3 once; its result is
    held against the chunked plain matvec (256-row plain builds) and
    against K3 forced to one segment, which checks the plan's (segments,
    m, r) partial buffer and its fold; both relative to (|C| |V|)_i."""
    m, n, r = xq.shape[0], x.shape[0], v.shape[1]
    # the nugget shift of make_corr_matvec, on the diagonal
    shift = p32.nugget * v if xq is x else torch.zeros_like(v[:m])
    reset_counters()
    got = (cgmod.make_corr_matvec(x, p32)(v) if xq is x
           else cgmod.corr_times(xq, x, p32, v))
    torch.cuda.synchronize()
    launched = sv.corr_matvec.launches
    both = cgmod.corr_times_chunked(xq, x, p32, torch.cat([v, v.abs()], 1),
                                    256)
    scale = both[:, r:] + shift.abs()
    worst = float(((got - both[:, :r] - shift).abs() / scale).max())
    segments = sv._matvec_segments(m, n, r)
    one = _k3_one_segment(xq, x, p32.delta, v) + shift
    seg_err = float(((got - one).abs() / scale).max())
    print(f"    {label}: K3 {what} at m={m}, n={n}, r={r}: {launched} launch; "
          f"plan {segments} segments (partial buffer "
          f"{4 * segments * m * r / 2**20:.1f} MiB); max |err| / (|C||V|)_i "
          f"against the chunked plain matvec {worst:.3e}, against one "
          f"segment {seg_err:.3e} (held to {MF_MATVEC_RTOL:g})")
    if max(worst, seg_err) > MF_MATVEC_RTOL:
        failures.append(f"{label}: K3 {what} at m={m}, r={r} off: plain "
                        f"{worst:.3e}, one segment {seg_err:.3e}")
    if launched != 1:
        failures.append(f"{label}: K3 {what} launched {launched} times")


def mf_k2_check(x, p32, label, failures):
    """K2 at the gradient pass's blocks: 256 rows of x against all of x
    (kernels.corr, as `_grad_log_delta` calls it), first and last block,
    against the plain build with `check_build` (K1/K2's tolerance; whether
    they are bit for bit is printed)."""
    n = x.shape[0]
    for i in (0, n - MF_CFG["chunk"]):
        xa = x[i:i + MF_CFG["chunk"]]
        try:
            check_build(f"{label} K2 gaussian_corr, gradient-pass block "
                        f"{xa.shape[0]} x {n} at row {i}, d={x.shape[1]}",
                        kernels.corr(xa, x, p32),
                        km.gaussian_corr_plain(xa, x, p32.delta))
        except SmokeFailure as exc:
            failures.append(str(exc))


def mf_matvec_checks(x, p32, dev, failures, label):
    """K3 through make_corr_matvec at the CG's r = 12 and the Lanczos
    steps' r = 8 (see mf_k3_check), K2 at the gradient pass's blocks, and
    an exact self diagonal of 1."""
    n = x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    for r, what in ((12, "CG matvec"), (8, "Lanczos matvec")):
        v = torch.randn((n, r), generator=gen, device=dev)
        mf_k3_check(what, x, x, p32, v, label, failures)
    mf_k2_check(x, p32, label, failures)
    idx = torch.linspace(0, n - 1, 12, device=dev).long()
    cols = torch.arange(12, device=dev)
    unit = torch.zeros((n, 12), device=dev)
    unit[idx, cols] = 1.0
    diag = cgmod.corr_times(x, x, p32, unit)[idx, cols]
    exact = bool(torch.equal(diag, torch.ones_like(diag)))
    print(f"    {label}: c(x, x) through K3 with x on both sides: diagonal "
          f"exactly 1 at 12 rows: {exact}; K3 plan at m=n={n}, r=12: "
          f"{sv._matvec_segments(n, n, 12)} segments")
    if not exact:
        failures.append(f"{label}: K3's self diagonal is not exactly 1")


def mf_exact_nll_grad(p64, x64, y64, h64):
    """gp.nll_mucm and its (log delta, log nugget) gradient, fp64."""
    leaves = [t.clone().requires_grad_(True) for t in p64]
    val = gp.nll_mucm(kernels.GPParams(*leaves), x64, y64, h64)
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), torch.cat([grads[0], grads[2][None]])


def mf_against_exact(dev, nugget, failures, hold):
    """nll_and_grad_matrix_free (fp32: K3, K2) against the exact fp64 NLL
    and gradient at MF_EXACT_DELTA and `nugget`; beside it the same
    estimator in fp64 (the plain path) from the same probes, which
    separates the probes' noise from fp32's rounding. `hold`: "exact"
    holds fp32 against the exact, "estimator" against the fp64 estimator
    (the bounds of MF_NLL_RTOL, MF_COS and MF_RATIO), None prints."""
    x, y, h, _, _, _ = mf_data(MF_N_EXACT, MF_M_EXACT, dev)
    p32 = params_from_numpy(np.log(MF_EXACT_DELTA), 0.0, np.log(nugget),
                            device=dev, dtype=torch.float32)
    p64 = params_from_numpy(np.log(MF_EXACT_DELTA), 0.0, np.log(nugget),
                            device=dev, dtype=torch.float64)
    val, ge = mf_exact_nll_grad(p64, x.double(), y.double(), h.double())
    cfg = mf.MFConfig(cg_tol=MF_TRAIN_TOL, **MF_EXACT_CFG)
    probes = mf.matrix_free_probes(torch.Generator(device=dev).manual_seed(1),
                                   MF_N_EXACT, cfg, torch.float32)
    out = {}
    for name, p, dt in (("fp32", p32, torch.float32),
                        ("fp64", p64, torch.float64)):
        t0 = time.perf_counter()
        nll, g, aux = mf.nll_and_grad_from_probes(
            p, x.to(dt), y.to(dt), h.to(dt),
            tuple(t.to(dt) for t in probes),
            dataclasses.replace(cfg, cg_tol=MF_TRAIN_TOL if dt == torch.float32
                                else 1e-10))
        torch.cuda.synchronize()
        gm = torch.cat([g.log_delta, g.log_nugget[None]]).double()
        out[name] = (abs(float(nll) - val) / abs(val),
                     float(gm @ ge / (gm.norm() * ge.norm())),
                     float(gm.norm() / ge.norm()), gm.tolist(),
                     aux["cg_info"]["iters"],
                     float(aux["cg_info"]["rel_resid"].max()),
                     time.perf_counter() - t0, float(nll))
    print(f"    nugget {nugget:g}, exact NLL {val:.4f}, gradient "
          f"{ge.tolist()}" + ("" if hold == "exact"
                               else " (against it: a finding, not held)"))
    for name, (r, c, q, gm, it, res, t, _) in out.items():
        print(f"      {name}: NLL rel err {r:.3e}; gradient {gm}: cosine "
              f"{c:.4f}, norm ratio {q:.3f}; PCG {it} iterations (rel resid "
              f"{res:.2e}); {t:.2f} s")
    if hold == "exact":
        rel, cos, ratio = out["fp32"][:3]
    else:
        # fp32 against the fp64 estimator from the same probes: fp32's
        # rounding alone, held to the same bounds
        g32, g64 = (torch.tensor(out[k][3], dtype=torch.float64)
                    for k in ("fp32", "fp64"))
        rel = abs(out["fp32"][7] - out["fp64"][7]) / abs(out["fp64"][7])
        cos = float(g32 @ g64 / (g32.norm() * g64.norm()))
        ratio = float(g32.norm() / g64.norm())
        print(f"      fp32 against fp64 from the same probes: NLL rel diff "
              f"{rel:.3e}, gradient cosine {cos:.4f}, norm ratio {ratio:.3f}"
              + (" (held)" if hold else ""))
    ok = rel < MF_NLL_RTOL and cos > MF_COS and MF_RATIO[0] < ratio < MF_RATIO[1]
    if hold and not ok:
        failures.append(f"(a) matrix-free NLL/gradient at nugget {nugget:g} "
                        f"off the {hold}: rel {rel:.3e}, cos {cos:.4f}, "
                        f"ratio {ratio:.3f}")


def mf_exact(dev, card, failures):
    """(a) at n = MF_N_EXACT, where the exact path still fits: K3's matvec,
    the NLL and gradient, and the served mean against fp64 exact."""
    print(f"  (a) matrix-free against exact at n={MF_N_EXACT}, d=2, fp32 "
          f"({card})")
    x, y, h, xs, hs, _ = mf_data(MF_N_EXACT, MF_M_EXACT, dev)
    p32 = params_from_numpy(np.log(MF_EXACT_DELTA), 0.0,
                            np.log(MF_EXACT_NUGGET), device=dev,
                            dtype=torch.float32)
    mf_matvec_checks(x, p32, dev, failures, "(a)")
    print(f"    nll_and_grad_matrix_free at delta {MF_EXACT_DELTA}, "
          f"{MF_EXACT_CFG['num_probes']} probes, against gp.nll_mucm in "
          f"fp64, fp32 held to rel < {MF_NLL_RTOL}, cosine > {MF_COS}, ratio "
          f"in {MF_RATIO}:")
    mf_against_exact(dev, MF_EXACT_NUGGET, failures, hold="exact")
    mf_against_exact(dev, mf_floor(MF_N_EXACT), failures, hold="estimator")
    mf_against_exact(dev, 1e-4, failures, hold=None)

    ff = cgmod.fit_matrix_free(p32, x, y, h, chunk=MF_CFG["chunk"],
                               tol=MF_FIT_TOL, maxiter=1000,
                               precond_rank=MF_CFG["precond_rank"])
    mean = cgmod.predict_mean_matrix_free(ff, x, xs, hs, p32)
    p64 = params_from_numpy(np.log(MF_EXACT_DELTA), 0.0,
                            np.log(MF_EXACT_NUGGET), device=dev,
                            dtype=torch.float64)
    x64, y64, h64 = x.double(), y.double(), h.double()
    st = gp.fit(p64, x64, y64, h64)
    m64, _ = gp.predict(st, x64, h64, xs.double(), hs.double())
    kappa = float(kappa_fp64(kernels.corr_self(x64, p64)))
    resid = float(ff["info"]["rel_resid"].max())
    budget = MF_MEAN_C * kappa * EPS32 + resid
    err = float((mean.double() - m64).abs().max() / m64.abs().max())
    print(f"    fit_matrix_free -> predict_mean_matrix_free at m={MF_M_EXACT} "
          f"against gp.fit -> gp.predict in fp64: max err / max |mean| "
          f"{err:.3e}, budget {MF_MEAN_C} kappa eps32 + rel resid = "
          f"{budget:.3e} (kappa(A) {kappa:.3e}; PCG {ff['info']['iters']} "
          f"iterations, rel resid {resid:.2e})")
    if not (err <= budget and bool(torch.isfinite(mean).all())):
        failures.append(f"(a) matrix-free mean off the exact: {err:.3e} > "
                        f"{budget:.3e}")


def mf_k3_costs(x, p, dev, card):
    """K3 at r = 12 (a CG iteration) and r = 8 (a Lanczos step) at m = n,
    and the card's busy time and the host gap of PCG iterations."""
    n = x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for r in (12, 8):
        v = torch.randn((n, r), generator=gen, device=dev)
        out[r], _ = time_ms(lambda: cgmod.corr_times(x, x, p, v), reps=5)
    pre = cgmod.pivoted_chol_precond(x, p, MF_CFG["precond_rank"])
    mv = cgmod.make_corr_matvec(x, p)
    b = torch.randn((n, 12), generator=gen, device=dev)
    k = 10
    wall = {it: wall_ms(lambda it=it: cgmod.cg_solve(mv, b, tol=0.0,
                                                      maxiter=it, precond=pre))
            for it in (0, k)}
    busy = {it: device_profile(lambda it=it: cgmod.cg_solve(
        mv, b, tol=0.0, maxiter=it, precond=pre))[0] for it in (0, k)}
    it_wall = (wall[k] - wall[0]) / k
    text = (f"    K3 at m=n={n}: r=12 {out[12]:.3f} ms, r=8 {out[8]:.3f} ms "
            f"(wrapper, CUDA events, median of 5; {card}); one PCG "
            f"iteration (r=12) {it_wall:.3f} ms on the host clock")
    if busy[0] is not None:
        it_busy = (busy[k] - busy[0]) / k
        text += (f", card busy {it_busy:.3f} ms, host gap "
                 f"{it_wall - it_busy:.3f} ms")
    print(text)
    return out


def _rel_resid(matvec, b, x) -> float:
    """max over columns of |b - A x| / |b|."""
    return float((torch.linalg.vector_norm(b - matvec(x), dim=0)
                  / torch.linalg.vector_norm(b, dim=0)).max())


def _lambda_max(matvec, n, dev, iters: int = 20) -> float:
    """The largest eigenvalue of A by power iteration from the ones vector
    (A's dominant eigenvector is near it: every entry of C is positive)."""
    v = torch.full((n,), n ** -0.5, device=dev)
    lam = 0.0
    for _ in range(iters):
        w = matvec(v)
        lam = float(v @ w)
        v = w / torch.linalg.vector_norm(w)
    return lam


def _mf_eval(p, x, y, h, probes, cfg, dt):
    """nll_and_grad_from_probes in dtype dt: (NLL, (log delta, log
    nugget) gradient in fp64 on the host, PCG iterations, seconds)."""
    t0 = time.perf_counter()
    nll, g, aux = mf.nll_and_grad_from_probes(
        kernels.GPParams(*(t.to(dt) for t in p)), x.to(dt), y.to(dt),
        h.to(dt), tuple(t.to(dt) for t in probes), cfg)
    torch.cuda.synchronize()
    return (float(nll), torch.cat([g.log_delta, g.log_nugget[None]]).double()
            .cpu(), aux["cg_info"]["iters"], time.perf_counter() - t0)


def mf_adam_witness(x, y, h, p0, p, cfg, dev, failures):
    """The Adam steps' start (the subset MLE projected onto the nugget
    floor, as mle_fit_from_probes does) and end, evaluated from the fit's
    own probes by the fp64 estimator (the plain path): the fp32 gradient
    at the start held against fp64's with (a)'s bounds; the fp64 NLL at
    both ends (held: the steps lower it) beside the first-order change its
    start gradient predicts; and, a finding, the fp32 gradient at the
    start from MF_WITNESS_PROBES fresh probes, which shows the 8-probe
    estimate's noise."""
    n = x.shape[0]
    probes = mf.matrix_free_probes(torch.Generator(device=dev).manual_seed(1),
                                   n, cfg, torch.float32)
    start = kernels.GPParams(p0.log_delta, p0.log_sigma2, torch.clamp(
        p0.log_nugget, min=math.log(MF_MIN_NUGGET)))
    cfg64 = dataclasses.replace(cfg, cg_tol=MF_WITNESS_TOL64)
    r32 = _mf_eval(start, x, y, h, probes, cfg, torch.float32)
    r64 = _mf_eval(start, x, y, h, probes, cfg64, torch.float64)
    e64 = _mf_eval(p, x, y, h, probes, cfg64, torch.float64)
    wide_cfg = dataclasses.replace(cfg, num_probes=MF_WITNESS_PROBES)
    wide = _mf_eval(start, x, y, h, mf.matrix_free_probes(
        torch.Generator(device=dev).manual_seed(2), n, wide_cfg,
        torch.float32), wide_cfg, torch.float32)
    g32, g64 = r32[1], r64[1]
    cos = float(g32 @ g64 / (g32.norm() * g64.norm()))
    ratio = float(g32.norm() / g64.norm())
    rel = abs(r32[0] - r64[0]) / abs(r64[0])
    step = torch.cat([p.log_delta - start.log_delta,
                      (p.log_nugget - start.log_nugget)[None]]).double().cpu()
    gw = wide[1]
    print(f"    the Adam steps from the fit's own probes, fp32 against the "
          f"fp64 estimator (plain path, cg_tol {MF_WITNESS_TOL64:g}) at the "
          f"start: NLL {r32[0]:.3f} / {r64[0]:.3f} (rel diff {rel:.3e}); "
          f"gradient {g32.tolist()} / {g64.tolist()}: cosine {cos:.4f}, "
          f"norm ratio {ratio:.3f} (held to (a)'s bounds); PCG "
          f"{r32[2]} / {r64[2]} iterations; {r32[3]:.2f} / {r64[3]:.2f} s")
    print(f"    fp64 NLL at the start {r64[0]:.3f}, at the end {e64[0]:.3f} "
          f"(change {e64[0] - r64[0]:+.3f}; the start gradient predicts "
          f"{float(g64 @ step):+.3f} to first order along the step "
          f"{step.tolist()}); {e64[3]:.2f} s")
    print(f"    finding: the fp32 gradient at the start from "
          f"{MF_WITNESS_PROBES} fresh probes {gw.tolist()}: cosine "
          f"{float(gw @ g64 / (gw.norm() * g64.norm())):.4f} with the "
          f"8-probe fp64 gradient, norm ratio {float(gw.norm() / g64.norm()):.3f}"
          f"; NLL {wide[0]:.3f}; {wide[3]:.2f} s")
    if not (rel < MF_NLL_RTOL and cos > MF_COS
            and MF_RATIO[0] < ratio < MF_RATIO[1]):
        failures.append(f"(b) fp32 gradient at the Adam start off the fp64 "
                        f"estimator: rel {rel:.3e}, cos {cos:.4f}, ratio "
                        f"{ratio:.3f}")
    if not e64[0] < r64[0]:
        failures.append(f"(b) the Adam steps raised the fp64 NLL: "
                        f"{r64[0]:.3f} -> {e64[0]:.3f}")


def mf_full_width(dev, card, failures):
    """(b) the example's workflow at n = MF_N, fp32, in a launch window."""
    n = MF_N
    total = torch.cuda.get_device_properties(dev).total_memory / 2**30
    dense = 4.0 * n * n / 2**30
    print(f"  (b) matrix-free workflow at n={n}, d=2, fp32: the dense A alone "
          f"would take {dense:.0f} GiB, its Cholesky factor as much again; "
          f"the card has {total:.1f} GiB ({card})")
    x, y, h, xs, hs, truth = mf_data(n, MF_M, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    parts = {}
    t0 = time.perf_counter()
    p0, info0 = lbfgs.mle_fit(
        torch.Generator().manual_seed(0), x[:MF_N_SUB], y[:MF_N_SUB],
        h[:MF_N_SUB], lbfgs.MLEConfig(mode="mucm", tries=4, train_nugget=True,
                                      nugget_bounds=(1e-6, 1.0),
                                      max_iters=MF_SUB_MAX_ITERS))
    torch.cuda.synchronize()
    parts["subset MLE"] = time.perf_counter() - t0
    cfg = mf.MFConfig(cg_tol=MF_TRAIN_TOL, **MF_CFG)
    with _Spans(mf, _MF_EVAL_PARTS) as spans:
        p, info = mf.mle_fit_matrix_free(
            torch.Generator(device=dev).manual_seed(1), x, y, h,
            steps=MF_STEPS, learning_rate=MF_LR, min_nugget=MF_MIN_NUGGET,
            init=p0, cfg=cfg)
        trace = info["nll_trace"].tolist()
    parts["Adam"] = time.perf_counter() - t0 - sum(parts.values())
    with _Spans(cgmod, ("cg_solve", "pivoted_chol_precond")) as fit_spans:
        ff = cgmod.fit_matrix_free(p, x, y, h, chunk=MF_CFG["chunk"],
                                   tol=MF_FIT_TOL, maxiter=1000,
                                   precond_rank=MF_CFG["precond_rank"])
    parts["fit"] = time.perf_counter() - t0 - sum(parts.values())
    mean = cgmod.predict_mean_matrix_free(ff, x, xs, hs, p)
    torch.cuda.synchronize()
    parts["predict"] = time.perf_counter() - t0 - sum(parts.values())
    launches = counters()
    peak = torch.cuda.max_memory_allocated() / 2**30

    rmse = float(np.sqrt(np.mean((mean.double().cpu().numpy() - truth) ** 2)))
    iters, syncs, resid = _cg_text(spans.cg)
    f_iters, f_syncs, f_resid = _cg_text(fit_spans.cg)
    rhs = torch.cat([y[:, None], h], dim=1)
    sol = torch.cat([(ff["e"] + ff["ainv_h"] @ ff["beta"])[:, None],
                     ff["ainv_h"]], dim=1)
    mv = cgmod.make_corr_matvec(x, p)
    k3_resid = _rel_resid(mv, rhs, sol)
    # the true residual with A applied in fp64 by the plain chunked build,
    # out of reach of K3's rounding; its budget from kappa(A) <=
    # lambda_max / nugget (C is positive semi-definite)
    p64 = kernels.GPParams(*(t.double() for t in p))
    true_resid = _rel_resid(
        cgmod.make_corr_matvec(x.double(), p64, chunk=MF_CFG["chunk"]),
        rhs.double(), sol.double())
    kappa = _lambda_max(mv, n, dev) / float(p.nugget)
    resid_budget = MF_FIT_TOL + MF_RESID_C * kappa * EPS32
    per = {k: v / MF_STEPS for k, v in spans.seconds.items()}
    print(f"    subset MLE at n={MF_N_SUB} (K1, 4 restarts, at most "
          f"{MF_SUB_MAX_ITERS} iterations): "
          f"{parts['subset MLE']:.2f} s, {info0['iters'].tolist()} iterations"
          f"; delta {p0.delta.tolist()}, nugget {float(p0.nugget):.3e}")
    print(f"    {MF_STEPS} Adam steps (mle_fit_matrix_free, {cfg}): "
          f"{parts['Adam']:.2f} s, {parts['Adam'] / MF_STEPS:.2f} s a step; "
          f"NLL trace {trace}; delta {p.delta.tolist()}, nugget "
          f"{float(p.nugget):.3e}")
    print(f"    an evaluation, s (host clock, synchronized): CG "
          f"{per['cg_solve']:.3f}, SLQ "
          f"{per['slq_logdet_preconditioned_from_probes']:.3f}, gradient "
          f"pass {per['_grad_log_delta']:.3f}, pivoted Cholesky "
          f"{per['pivoted_cholesky']:.3f}, Woodbury setup "
          f"{per['woodbury_ops']:.3f}")
    print(f"    PCG a solve: iterations {iters}, host syncs {syncs}; largest "
          f"rel resid {resid:.2e} (tol {MF_TRAIN_TOL:g})")
    print(f"    fit_matrix_free: {parts['fit']:.2f} s, PCG {f_iters} "
          f"iterations, {f_syncs} host syncs, recursive rel resid "
          f"{f_resid:.2e} (tol {MF_FIT_TOL:g}); true relative residual "
          f"|b - A x| / |b| with A in fp64 (plain) {true_resid:.3e}, held to "
          f"tol + {MF_RESID_C:g} kappa(A) eps32 = {resid_budget:.3e} "
          f"(kappa(A) <= {kappa:.3e}); with A through K3 {k3_resid:.3e}. "
          f"So the fp32 solve reaches about {true_resid:.0e}, not its "
          f"recursive {f_resid:.0e}; beta {ff['beta'].tolist()}")
    print(f"    predict_mean_matrix_free at m={MF_M}: {parts['predict']:.3f} "
          f"s; RMSE against the noiseless simulator {rmse:.4e} (< "
          f"{MF_RMSE:g}); peak allocated {peak:.2f} GiB (< "
          f"{MF_MEM_FRACTION * dense:.0f} GiB, {MF_MEM_FRACTION:g} of the "
          f"dense A)")
    print(f"    launches in (b): {launches} (K1 the subset MLE, K2 the "
          f"gradient passes, {n // MF_CFG['chunk']} an evaluation, K3 the "
          f"CG and Lanczos loops and the prediction)")
    if not all(math.isfinite(v) for v in trace):
        failures.append(f"(b) NLL trace not finite: {trace}")
    if resid > MF_TRAIN_TOL or f_resid > MF_FIT_TOL:
        failures.append(f"(b) CG columns off their tolerance: {resid:.2e}, "
                        f"{f_resid:.2e}")
    if not true_resid <= resid_budget:
        failures.append(f"(b) fit's true residual {true_resid:.3e} > "
                        f"{resid_budget:.3e}")
    if not (rmse < MF_RMSE and bool(torch.isfinite(mean).all())):
        failures.append(f"(b) served mean RMSE {rmse:.4e}")
    if peak > MF_MEM_FRACTION * dense:
        failures.append(f"(b) peak memory {peak:.2f} GiB")
    if min(launches["K1"], launches["K2"], launches["K3"]) <= 0:
        failures.append(f"(b) K1, K2 and K3 must launch: {launches}")
    mf_matvec_checks(x, p, dev, failures, "(b)")
    mf_k3_check("served mean", xs, x, p, ff["e"][:, None], "(b)", failures)
    mf_adam_witness(x, y, h, p0, p, cfg, dev, failures)
    mf_k3_costs(x, p, dev, card)
    # a finding, not held: PCG at the subset MLE's own nugget, below the
    # fp32 floor MF_MIN_NUGGET
    t1 = time.perf_counter()
    low = cgmod.fit_matrix_free(p0, x, y, h, chunk=MF_CFG["chunk"],
                                tol=MF_FIT_TOL, maxiter=100,
                                precond_rank=MF_CFG["precond_rank"])
    torch.cuda.synchronize()
    print(f"    finding: fit_matrix_free at the subset MLE's nugget "
          f"{float(p0.nugget):.3e}: PCG {low['info']['iters']} iterations "
          f"(at most 100), rel resid "
          f"{float(low['info']['rel_resid'].max()):.3e}, "
          f"{time.perf_counter() - t1:.2f} s")
    return launches


def nf_problem(n, d):
    """chip_smoke.py::problem's inputs and signal, with noise sd
    0.1 + 0.4 x0 (examples/noise-fit/run_noisefit.py's ramp) drawn from
    seed 1; fp64."""
    x, y = problem(n, d)
    x = x.astype(np.float64)
    sd = 0.1 + 0.4 * x[:, 0]
    rng = np.random.default_rng(1)
    return x, y.astype(np.float64) + sd * rng.standard_normal(n), sd


class _FitLog(_NllCalls):
    """Wraps noise_fit's mle_fit: seconds and objective calls a fit."""

    def __enter__(self):
        super().__enter__()
        self.runs = []
        self._fit = nf.mle_fit

        def fit(*args, **kwargs):
            calls0 = self.calls
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._fit(*args, **kwargs)
            torch.cuda.synchronize()
            self.runs.append((time.perf_counter() - t0, self.calls - calls0,
                              int(out[1]["iters"].max())))
            return out

        nf.mle_fit = fit
        return self

    def __exit__(self, *exc):
        nf.mle_fit = self._fit
        super().__exit__(*exc)


def nf_full_width(dev, card, failures):
    """(c) noisefit_arrays at n = NF_N, d = NF_D, fp64 on the card."""
    x, y, sd = nf_problem(NF_N, NF_D)
    print(f"  (c) noisefit_arrays at n={NF_N}, d={NF_D}, noise sd 0.1 + 0.4 "
          f"x0, design_size {NF_DESIGN}, stopat {NF_STOPAT}, fp64 (cuSOLVER, "
          f"cuBLAS and the plain fp64 build: no kernel) ({card})")
    stamps = []
    t0 = time.perf_counter()
    with _FitLog() as log:
        res = nf.noisefit_arrays(
            x, y, stopat=NF_STOPAT, design_size=NF_DESIGN, device=dev,
            iter_callback=lambda it, v: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    its = np.diff([t0] + stamps).tolist()
    print(f"    {total:.1f} s: iterations {[round(v, 2) for v in its]} s; "
          f"history {res.history}")
    print(f"    mle_fit calls (s, objective calls, iterations): "
          f"{[(round(s, 2), c, i) for s, c, i in log.runs]}")
    est = np.sqrt(res.noise_at_train)
    lo = x[:, 0] <= np.quantile(x[:, 0], 0.1)
    hi = x[:, 0] >= np.quantile(x[:, 0], 0.9)
    e_lo, e_hi = float(est[lo].mean()), float(est[hi].mean())
    t_lo, t_hi = float(sd[lo].mean()), float(sd[hi].mean())
    print(f"    recovered noise sd, bottom decile of x0 {e_lo:.4f} (true "
          f"{t_lo:.4f}, held within x/÷ {NF_BAND['bottom']}), top decile "
          f"{e_hi:.4f} (true {t_hi:.4f}, x/÷ {NF_BAND['top']}); ratio "
          f"{e_hi / e_lo:.2f} (> {NF_RATIO})")
    if not (np.all(np.isfinite(res.noise_at_train))
            and np.all(res.noise_at_train > 0)):
        failures.append("(c) noise_at_train not finite and positive")
    if not e_hi > NF_RATIO * e_lo:
        failures.append(f"(c) noise ramp not recovered: {e_lo}, {e_hi}")
    for e, t, band in ((e_lo, t_lo, NF_BAND["bottom"]),
                       (e_hi, t_hi, NF_BAND["top"])):
        if not t / band <= e <= t * band:
            failures.append(f"(c) noise sd {e:.4f} outside the band around "
                            f"{t:.4f}")
    # one data-GP evaluation (gp4ml, 4 restarts, the final noise) profiled
    cfg = lbfgs.MLEConfig(mode="gp4ml", tries=4, train_nugget=True,
                          nugget_bounds=(1e-8, 10.0))
    xt = torch.as_tensor(x, device=dev)
    ht = basis_matrix(xt, linear_basis(NF_D))
    lo_b, hi_b = lbfgs._default_bounds(cfg, NF_D)
    noise = torch.as_tensor(res.noise_at_train / float(res.data_state.sigma2),
                            device=dev)
    objective, _, from_logspace = lbfgs._make_objective(
        xt, torch.as_tensor(y, device=dev), ht, cfg, lo_b, hi_b, noise)
    u = from_logspace(lbfgs._lhc_starts(torch.Generator().manual_seed(0), 4,
                                        lo_b, hi_b, torch.float64).to(dev))
    evaluation_breakdown(f"(c) data GP, gp4ml value and gradient, 4 restarts "
                         f"x n={NF_N}, fp64", objective, u, card)
    return total


def nf_replay(dev, failures):
    """(d) noisefit_arrays at n = 200, d = 1, stopat 2 on the CPU, then on
    the card with the CPU run's fits replayed through the mle_fit seam."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, 200)
    y = 2.0 * np.sin(2 * np.pi * x) + (0.1 + 0.4 * x) * rng.standard_normal(200)
    real = nf.mle_fit
    fits, seen = [], {"cpu": [], "card": []}

    def record(generator, x_, y_, h_, cfg, **kwargs):
        # capped: the card replays whatever fits the CPU made
        out = real(generator, x_, y_, h_, dataclasses.replace(
            cfg, max_iters=NF_REPLAY_MAX_ITERS), **kwargs)
        fits.append(out)
        return out

    def replay(*args, **kwargs):
        params, info = fits[len(seen["replayed"])]
        seen["replayed"].append(1)
        return kernels.GPParams(*(t.to(dev) for t in params)), info

    grid = np.linspace(0.0, 1.0, 41)
    seen["replayed"] = []
    try:
        nf.mle_fit = record
        cres = nf.noisefit_arrays(x, y, stopat=2, device="cpu",
                                  iter_callback=lambda it, v: seen["cpu"].append(v))
        nf.mle_fit = replay
        gres = nf.noisefit_arrays(x, y, stopat=2, device=dev,
                                  iter_callback=lambda it, v: seen["card"].append(v))
    finally:
        nf.mle_fit = real
    def rel(g, c):
        g, c = np.asarray(g), np.asarray(c)
        return float(np.max(np.abs(g - c)) / np.max(np.abs(c)))

    errs = {"noise variances": max(rel(g, c) for g, c in
                                   zip(seen["card"], seen["cpu"])),
            "history": rel(gres.history, cres.history),
            "predict_noise": rel(nf.predict_noise(gres, grid),
                                 nf.predict_noise(cres, grid))}
    # the conditioning the fits' solves amplify rounding by
    d = cres.data_params
    a = kernels.corr_self(torch.as_tensor(x[:, None], device=dev),
                          kernels.GPParams(*(t.to(dev) for t in d)))
    a = a + torch.diag(torch.as_tensor(
        cres.noise_at_train / float(cres.data_state.sigma2), device=dev))
    kappa = float(kappa_fp64(a))
    worst = max(errs.values())
    ok = (len(seen["card"]) == len(seen["cpu"]) == 2
          and len(seen["replayed"]) == len(fits) == 5 and worst <= NF_REPLAY_RTOL)
    print(f"  (d) noisefit_arrays card against CPU from the same {len(fits)} "
          f"fits (n=200, d=1, fp64, stopat 2): worst differences relative "
          f"to each quantity's largest entry "
          f"{json.dumps(errs)} (held to {NF_REPLAY_RTOL:g}); kappa of the "
          f"final data GP's A {kappa:.3e}")
    if not ok:
        failures.append(f"(d) card off the CPU: {worst:.3e}")


def nf_files(dev, failures):
    """(e) noisefit on a copy of examples/noise-fit in a temporary
    directory: the -noise-it<k>, -noise and -f files."""
    src = Path(__file__).resolve().parent / "examples" / "noise-fit"
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp) / "noise-fit"
        shutil.copytree(src, work)
        t0 = time.perf_counter()
        res = nf.noisefit(work / "noisefit_data_config",
                          work / "noisefit_noise_config",
                          stopat=NF_FILES_STOPAT, device=dev)
        t = time.perf_counter() - t0
        names = sorted(p.name for p in work.iterdir()
                       if "-noise" in p.name or p.name.endswith("-f"))
        want = ([f"noisefit_output-noise-it{k}"
                 for k in range(len(res.history) + 1)]
                + ["noisefit_output-noise", "noisefit_data_beliefs-f",
                   "noisefit_noise_beliefs-f"])
        noise = (np.loadtxt(work / "noisefit_output-noise")
                 if (work / "noisefit_output-noise").exists() else None)
    print(f"  (e) noisefit(stopat={NF_FILES_STOPAT}) on examples/noise-fit: "
          f"{t:.1f} s, wrote "
          f"{names}; -noise positive: "
          f"{noise is not None and bool(np.all(noise > 0))}")
    if not set(want) <= set(names):
        failures.append(f"(e) missing files: {sorted(set(want) - set(names))}")
    if noise is None or not np.all(noise > 0):
        failures.append("(e) -noise not positive")


def utilities(dev, card, k1_ms, failures):
    """(f) roofline.measure, utils.timing.timed on K1, checked_fit, and
    tiny measure_hmc / measure_nuts runs."""
    res = roofline.measure(n=4096, device=dev)
    print(f"  (f) roofline.measure(n=4096) on {res['device']} ({card}):")
    for op, entry in res.items():
        if isinstance(entry, dict):
            print(f"    {op}: {json.dumps(entry)}")
    x_np, _ = problem(N_TRAIN)
    x = torch.as_tensor(x_np, device=dev)
    delta = torch.full((DIM,), DELTA, dtype=torch.float32, device=dev)
    nugget = torch.tensor(NUGGET, dtype=torch.float32, device=dev)
    out = torch.empty((N_TRAIN, N_TRAIN), dtype=torch.float32, device=dev)
    if k1_ms is None:
        k1_ms = launches_ms(self_entry(x, delta, nugget, out))
    t = 1e3 * timing.timed(
        lambda: km.gaussian_corr_self_fused(x, delta, nugget, out=out),
        lambda o: torch.cuda.synchronize())
    off = abs(t - k1_ms) / k1_ms
    print(f"    utils.timing.timed on K1 at n={N_TRAIN}: {t:.4f} ms against "
          f"phase 2's {k1_ms:.4f} ms ({100 * off:.1f}% apart, held to "
          f"{100 * TIMED_AGREE:.0f}%)")
    if off > TIMED_AGREE:
        failures.append(f"(f) timing.timed on K1 {t:.4f} against {k1_ms:.4f}")
    del out
    xf, yf = problem(N_FIT)
    xt = torch.as_tensor(xf, device=dev)
    yt = torch.as_tensor(yf, device=dev)
    ht = basis_matrix(xt, linear_basis(DIM))
    p = params_from_numpy(np.log(np.full(DIM, DELTA)), 0.0, np.log(NUGGET),
                          device=dev, dtype=torch.float32)
    err, state = sanitize.checked_fit(p, xt, yt, ht)
    bad = kernels.GPParams(p.log_delta.clone(), p.log_sigma2, p.log_nugget)
    bad.log_delta[0] = float("nan")
    err_bad, _ = sanitize.checked_fit(bad, xt, yt, ht)
    print(f"    sanitize.checked_fit at n={N_FIT}, fp32: clean fit -> "
          f"{err.get()!r} (NLL {float(state.nll):.3f}); NaN log delta -> "
          f"{err_bad.get()!r}")
    if err.get() is not None:
        failures.append(f"(f) checked_fit flags a clean fit: {err.get()}")
    if err_bad.get() is None or "kernel matrix" not in err_bad.get():
        failures.append(f"(f) checked_fit names {err_bad.get()!r} for a NaN "
                        "log delta")
    small = dict(n_chains=8, n=128, d=4, device=dev)
    print(f"    roofline.measure_hmc (tiny): {json.dumps(roofline.measure_hmc(n_samples=8, n_warmup=8, n_leapfrog=4, **small))}")
    print(f"    roofline.measure_nuts (tiny): {json.dumps(roofline.measure_nuts(n_warmup=8, segment_draws=4, n_segments=2, max_depth=4, **small))}")


def phase_matrix_free(dev, card, k1_ms=None):
    """Phase 7: the matrix-free path and the noise fit. Every check is
    collected and the phase fails at its end if any failed. Returns (b)'s
    launch window."""
    print(f"[phase 7] matrix-free path and noise fit ({card})")
    failures = []
    t0 = time.perf_counter()
    parts = {}
    mf_exact(dev, card, failures)
    parts["(a)"] = time.perf_counter()
    launches = mf_full_width(dev, card, failures)
    parts["(b)"] = time.perf_counter()
    nf_full_width(dev, card, failures)
    parts["(c)"] = time.perf_counter()
    nf_replay(dev, failures)
    parts["(d)"] = time.perf_counter()
    nf_files(dev, failures)
    parts["(e)"] = time.perf_counter()
    utilities(dev, card, k1_ms, failures)
    parts["(f)"] = time.perf_counter()
    t = t0
    spans = []
    for name, end in parts.items():
        spans.append(f"{name} {end - t:.1f} s")
        t = end
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s on the host "
          f"clock: {', '.join(spans)}")
    if failures:
        raise SmokeFailure("phase 7: " + "; ".join(failures))
    return launches


# phase 8, the multi-device path. (a) one rank over NCCL at BASELINE config
# 5's width (tools/multi_gpu_run.py's checks; the ring's t is (m, n) at one
# rank, so m is cut from 1M to 65536); (b) four gloo ranks sharing the card
# at phase 4's fit size: the same checks in fp64, each multi-device result
# also held against the same function on one rank, then in fp32; mle_fit
# and config 4's sampler over the ranks against one process. The launches
# are counted over the multi-device calls alone.
MD_RANKS = 4
MD_N, MD_M = 4096, 16384
# mle_fit over the ranks against one process running the same starts in
# the same batches of 2, fp32 (the same arithmetic). A batch of all 8 ends
# elsewhere: after 8 iterations 0.30 apart in NLL on the card, 6.7e-2 in
# fp32 and 5.8e-6 in fp64 on the CPU at n = 512 (the batched
# factorizations round by batch size)
# 4 iterations (cut from phase 4's 8 for phase 9's room)
MD_MLE_ITERS, MD_MLE_REL = 4, 1e-6
# config 4's sampler in fp64, 16 chains a rank, NUTS
MD_WARMUP, MD_SAMPLES, MD_DEPTH = 8, 4, 4
MD_SAMPLER_RTOL = 1e-10


def _md_nccl_probe(rank):
    """Two NCCL ranks on one card: an all-reduce."""
    t = torch.ones(1, device="cuda")
    torch.distributed.all_reduce(t)
    torch.cuda.synchronize()
    return float(t)


def md_nccl_refusal():
    """Does NCCL take two ranks on one card? Returns its error text."""
    try:
        got = spawn_ranks(_md_nccl_probe, 2, backend="nccl",
                          device_type="cuda", timeout=120)
    except RuntimeError as err:
        text = [ln.strip() for ln in str(err).splitlines()
                if "NCCL" in ln or "uplicate" in ln or "did not finish" in ln]
        return "; ".join(dict.fromkeys(text)) or str(err)[-400:]
    print(f"  FINDING: NCCL took two ranks on one card (all-reduce {got})")
    return None


def md_one_rank(dev):
    """(a): world size 1 over NCCL on a localhost store, the collectives
    issued on CUDA tensors (gloo on the CPU, for a rehearsal)."""
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        info = init_multihost(device_type=dev.type)
        backend = torch.distributed.get_backend()
        print(f"  (a) init_multihost: {info}, backend {backend}")
        if (backend != default_backend(dev.type)
                or not info["initialized_distributed"]):
            raise SmokeFailure(f"(a) expected an NCCL group, got {backend}")
        return multi_gpu_run.run(N_TRAIN, M_SERVE, device_type=dev.type)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        # (b)'s ranks share the card: hand back what (a) cached
        torch.cuda.empty_cache()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _md_mle(holds, chains, rank):
    """mle_fit with 8 restarts split over the ranks (fp32, K1) against one
    process running the same starts in the ranks' batches of 2 (the same
    arithmetic; one batch of 8 ended 0.30 apart in fp32, the card's
    batched factorizations rounding by batch size). Returns the mesh
    call's launches."""
    dev = mesh_device(chains)
    x_np, y_np = problem(MD_N)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    h = basis_matrix(x, linear_basis(DIM))
    cfg = lbfgs.MLEConfig(tries=FIT_TRIES, max_iters=MD_MLE_ITERS)
    t0 = time.perf_counter()
    reset_counters()
    _, info = lbfgs.mle_fit(torch.Generator().manual_seed(0), x, y, h, cfg,
                            mesh=chains)
    launches = counters()
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    if rank != 0:
        return launches
    lo, hi = lbfgs._default_bounds(cfg, DIM)
    objective, _, from_logspace = lbfgs._make_objective(x, y, h, cfg, lo, hi,
                                                        None)
    u0 = from_logspace(info["starts_logspace"])
    per = FIT_TRIES // MD_RANKS
    t0 = time.perf_counter()
    batches = torch.cat([
        lbfgs.run_restarts(objective, u0[k:k + per], cfg.max_iters,
                           cfg.tol)[1] for k in range(0, FIT_TRIES, per)])
    torch.cuda.synchronize()
    t_batches = time.perf_counter() - t0
    holds.close(f"mle_fit over the ranks: NLLs vs one process in batches of "
                f"{per}", info["nlls"], batches, MD_MLE_REL, 0.0)
    holds.say(f"  mle_fit, {FIT_TRIES} restarts: {t_mesh:.2f} s over "
              f"{MD_RANKS} ranks, {t_batches:.2f} s in one process in "
              f"batches of {per}")
    return launches


def _md_sampler(holds, chains, rank):
    """Config 4's sampler in fp64, 16 chains a rank, against one process
    fed the ranks' draws and evaluating the log density in the ranks'
    batches; the ranks' streams differ. Returns the mesh call's
    launches."""
    dev = mesh_device(chains)
    x, y, h, cfg = roofline.gp_test_posterior(BAYES_N, BAYES_D,
                                              torch.float64, dev)
    ld = hmc.make_gp_logdensity(x, y, h, cfg)
    z0 = BAYES_START_SD * torch.randn(
        (BAYES_CHAINS, BAYES_D), generator=torch.Generator().manual_seed(0),
        dtype=torch.float64).to(dev)
    per = BAYES_CHAINS // MD_RANKS
    hcfg = hmc.HMCConfig(n_warmup=MD_WARMUP, n_samples=MD_SAMPLES)
    group = chains.get_group("chains")

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    t0 = time.perf_counter()
    reset_counters()
    samples, stats = nuts.nuts_sample(gen(), ld, z0[rank * per:(rank + 1)
                                                    * per], hcfg,
                                      max_depth=MD_DEPTH,
                                      group=(chains, "chains"))
    launches = counters()
    torch.cuda.synchronize()
    t_mesh = time.perf_counter() - t0
    samples = all_gather(samples, group).reshape(BAYES_CHAINS,
                                                 *samples.shape[1:])
    first = torch.randn(3, generator=hmc.rank_generator(gen(), rank),
                        dtype=torch.float64, device=dev)
    firsts = all_gather(first, group)
    if rank != 0:
        return launches
    holds.true("the ranks' generators draw different streams",
               len({tuple(r.tolist()) for r in firsts}) == MD_RANKS)
    gens = [hmc.rank_generator(gen(), r) for r in range(MD_RANKS)]

    def ld_grad(z):
        # in the ranks' batches of 16 chains: the card's batched
        # factorizations round by batch size, and the trajectories amplify
        # that (one batch of 64 reads 3.6e-8 apart after 12 transitions)
        parts = [hmc.value_and_grad(ld, z[r * per:(r + 1) * per])
                 for r in range(MD_RANKS)]
        return tuple(torch.cat(f) for f in zip(*parts))

    def step(z, _unused, eps, inv_mass):
        parts = [nuts._nuts_draws(g, z[r * per:(r + 1) * per], MD_DEPTH)
                 for r, g in enumerate(gens)]
        draws = nuts.NutsDraws(*(torch.cat(f) for f in zip(*parts)))
        return nuts._nuts_transition(ld_grad, z, draws, eps, inv_mass,
                                     MD_DEPTH, hcfg.divergence_threshold)

    t0 = time.perf_counter()
    want, wstats = hmc.adaptive_mcmc(None, step, z0, hcfg)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    holds.say(f"  config 4 NUTS, fp64, {BAYES_CHAINS} chains: "
              f"{t_mesh:.2f} s over {MD_RANKS} ranks, {t_one:.2f} s in one "
              f"process fed the same draws")
    holds.close("sampler over the ranks: draws vs one process", samples,
                want, MD_SAMPLER_RTOL, 1e-12)
    for key in ("step_size", "inv_mass", "accept_rate"):
        holds.close(f"sampler over the ranks: {key} vs one process",
                    stats[key], wstats[key], MD_SAMPLER_RTOL, 1e-14)
    return launches


def _md_rank(rank, device_type):
    """(b) on one of four gloo ranks sharing cuda:0. The counters are set
    to 0 just before each multi-device call and read just after it (`run`
    counts its window the same way); the references run outside."""
    lines = []
    holds = multi_gpu_run.Holds(lines.append)
    chains = make_mesh({"chains": MD_RANKS}, device_type=device_type)
    launches = dict.fromkeys(_WRAPPERS, 0)
    peak, sent = {}, {}

    def add(counted):
        for k, v in counted.items():
            launches[k] += v

    t0 = time.perf_counter()
    for dtype in (torch.float64, torch.float32):
        out = multi_gpu_run.run(MD_N, MD_M, lines.append, device_type,
                                dtype=dtype,
                                one_rank=dtype == torch.float64)
        tag = "fp64" if dtype == torch.float64 else "fp32"
        holds.failures += out["failures"]
        add(out["launches"])
        peak[f"{tag} run"] = max(out["peak_gib"].values())
        sent.update({f"{tag} {k}": v for k, v in out["bytes"].items()})
    t_fits = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    add(_md_mle(holds, chains, rank))
    t_mle = time.perf_counter() - t0 - t_fits
    add(_md_sampler(holds, chains, rank))
    torch.cuda.synchronize()
    peak["mle_fit, sampler"] = torch.cuda.max_memory_allocated() / 2 ** 30
    holds.say(f"  (b) rank {rank}: run fp64 and fp32 {t_fits:.1f} s, mle_fit "
              f"{t_mle:.1f} s, sampler "
              f"{time.perf_counter() - t0 - t_fits - t_mle:.1f} s")
    if rank == 0:
        # K1 against its plain version at the mle_fit shape, not counted
        dev = mesh_device(chains)
        x = torch.as_tensor(problem(MD_N)[0], device=dev)
        delta = torch.full((DIM,), DELTA, device=dev)
        got = km.gaussian_corr_self_fused(x, delta, NUGGET)
        want = km.gaussian_corr_self_plain(x, delta, NUGGET)
        holds.close(f"K1 at the mle_fit shape n={MD_N} vs plain", got, want,
                    multi_gpu_run.BUILD_RTOL, multi_gpu_run.BUILD_ATOL)
        holds.true("K1 bitwise equal to the plain version",
                   torch.equal(got, want))
    return {"lines": lines, "failures": holds.failures, "launches": launches,
            "peak_gib": peak, "bytes": sent}


def phase_multi_device(dev, card):
    """Phase 8: the multi-device path. Every check is collected and the
    phase fails at its end if any failed. Returns the multi-device
    launches (K1-K4), (a)'s window and (b)'s summed over the ranks."""
    print(f"[phase 8] multi-device path ({card})")
    torch.cuda.empty_cache()
    failures = []
    t0 = time.perf_counter()
    a = md_one_rank(dev)
    failures += [f"(a) {f}" for f in a["failures"]]
    t_a = time.perf_counter()
    refusal = md_nccl_refusal() if dev.type == "cuda" else None
    print(f"  NCCL with two ranks on one card: "
          f"{'refused: ' + refusal if refusal else 'accepted'}")
    t_probe = time.perf_counter()
    print(f"  (b) {MD_RANKS} gloo ranks sharing the card, n={MD_N}, "
          f"m={MD_M}, d={DIM}, fp64 (and against one rank) and fp32")
    ranks = spawn_ranks(_md_rank, MD_RANKS, (dev.type,), backend="gloo",
                        device_type=dev.type, timeout=600)
    for line in ranks[0]["lines"]:
        print(line)
    for r, out in enumerate(ranks):
        failures += [f"(b) rank {r}: {f}" for f in out["failures"]]
        peak = ", ".join(f"{k} {v:.2f}" for k, v in out["peak_gib"].items())
        print(f"  (b) rank {r}: peak GiB {peak}; launches "
              f"{out['launches']}, bytes sent {out['bytes']}")
    launches = {k: a["launches"].get(k, 0)
                + sum(out["launches"][k] for out in ranks)
                for k in _WRAPPERS}
    print(f"  multi-device launches ((a) and the ranks of (b)): {launches}")
    if launches["K1"] <= 0 or launches["K2"] <= 0:
        failures.append(f"K1 or K2 never launched on the path: {launches}")
    print(f"  phase 8 took {time.perf_counter() - t0:.1f} s on the host "
          f"clock: (a) {t_a - t0:.1f} s, the NCCL probe {t_probe - t_a:.1f}"
          f" s, (b) {time.perf_counter() - t_probe:.1f} s")
    if failures:
        raise SmokeFailure("phase 8: " + "; ".join(failures))
    return launches


# ----- phase 9: the example workflows --------------------------------------

EX_M = 1_000_000         # config 5's queries (run_large.py's published m)
EX_BLOCK = 256           # run_large.py's block
EX_CHUNK = 65536         # config 5's ring: queries a rank in one call
EX_REF_M = 4096          # config 5's fp64 CPU reference: the first queries
EX_REF_THREADS = 2       # its CPU threads, beside the workers
# the fp64 workflows are host-bound (small L-BFGS and sampler steps): they
# run in spawned workers on the card, one torch thread each, after config 5
EX_WORKERS = 4
# phase 3b's budgets: an fp32 mean against fp64, of max |mean|
EX_MEAN_REL = 1e-3
EX_RHAT = 1.1            # config 4: split R-hat on every dimension
# examples/matrix-free at its n = 800: the serving RMSE against the
# noiseless simulator under half the data's noise sd (0.05). Phase 7's 3e-3
# (n = 131072) does not carry over: at n = 800 the JAX script itself
# prints 6.8e-3 (its subset-MLE starts and probes), and the port fed the
# same draws ends where it does to 1e-7; the port's own CPU draws give
# 1.03e-2 (8 probes: the fit varies with them)
EX_MF_RMSE = 0.025


def _ex_run(name, fn, card, failures, times):
    """fn() in a window of its own: the launch counters and the peak
    memory set to 0 just before, read just after; the seconds on the host
    clock, synchronized. A failure is collected and gives (None, {})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    try:
        out = fn()
        torch.cuda.synchronize()
    except Exception:
        text = traceback.format_exc()
        print(text)
        failures.append(f"{name}: {text.strip().splitlines()[-1]}")
        return None, {}
    t = time.perf_counter() - t0
    got = counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    times[name] = (t, peak)
    print(f"  {name}: {t:.1f} s, peak allocated {peak:.2f} GiB, launches "
          f"{got} ({card})")
    return out, got


def _ex_hold(failures, name, ok, detail):
    print(f"    {name}: {detail} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: {detail}")


def _ex_close(failures, name, got, want, rtol, atol):
    try:
        check_close(name, got, want, rtol, atol)
    except SmokeFailure as err:
        failures.append(str(err))


def ex_reference():
    """Config 5's fp64 CPU reference: an fp64 fit of the same (fp32-rounded)
    data and its mean at the first EX_REF_M queries (the same draws as
    large_scale.run's); (queries, means, seconds). Runs in a worker while
    config 5 runs on the card."""
    torch.set_num_threads(EX_REF_THREADS)
    t0 = time.perf_counter()
    x, _, _, xq, _ = large_scale.problem(N_TRAIN, EX_REF_M, DIM,
                                         torch.float32, "cpu")
    x, xq = x.double(), xq.double()
    y = torch.sin(3 * x[:, 0]) + x[:, 1] * x[:, 2]
    spec = linear_basis(DIM)
    p64 = params_from_numpy(np.log(np.full(DIM, large_scale.DELTA)), 0.0,
                            np.log(large_scale.NUGGET), device="cpu",
                            dtype=torch.float64)
    st = gp.fit(p64, x, y, basis_matrix(x, spec))
    m64 = basis_matrix(xq, spec) @ st.beta + kernels.corr(xq, x, p64) @ st.e
    return xq, m64, time.perf_counter() - t0


def hold_reference(subset, reference, failures):
    """Every config 5 mean at the first EX_REF_M queries (`subset`, from
    ex_config5) against the fp64 CPU reference (phase 3b's budget,
    relative to max |mean|)."""
    xq, m64, seconds = reference
    _ex_hold(failures, "config 5 reference queries are the run's",
             torch.equal(subset.pop("queries").float(), xq.float()), "")
    scale = float(m64.abs().max())
    for name, mean in subset.items():
        rel = float((mean - m64).abs().max()) / scale
        _ex_hold(failures, f"config 5 {name} mean vs fp64 CPU "
                 f"(first {EX_REF_M})", rel < EX_MEAN_REL,
                 f"{rel:.3e} of max |mean| (< {EX_MEAN_REL:g})")
    print(f"    the fp64 CPU reference took {seconds:.1f} s in a worker "
          f"({EX_REF_THREADS} threads)")


def ex_config5(dev, card, failures, times):
    """BASELINE config 5 at n=16384, m=1M through `large_scale.run` (one
    NCCL rank); the fused tier against the ring. Returns the launches and
    the queries and means at the first EX_REF_M queries, on the host in
    fp64, for `hold_reference`."""
    out, got = _ex_run(
        "large_scale (config 5, n=16384, m=1M, fp32)",
        lambda: large_scale.run(N_TRAIN, EX_M, DIM, EX_BLOCK,
                                chunk=EX_CHUNK, device=dev), card, failures,
        times)
    if out is None:
        return got, None
    _ex_hold(failures, "config 5: K2, K3 and K4 \"high\" launched",
             min(got["K2"], got["K3"], got["K4"]) > 0, str(got))
    (rm, rv), (fm, fv), fmo = out.ring, out.fused, out.fused_mean
    for name, v in (("ring mean", rm), ("ring var", rv), ("fused mean", fm),
                    ("fused var", fv), ("fused mean-only", fmo)):
        finite = bool(torch.isfinite(v).all())
        _ex_hold(failures, f"config 5 {name}",
                 tuple(v.shape) == (EX_M,) and finite,
                 f"shape {tuple(v.shape)}, finite {finite}")
    _ex_hold(failures, "config 5 variances >= 0",
             float(rv.min()) >= 0 and float(fv.min()) >= 0,
             f"min ring {float(rv.min()):.3e}, fused {float(fv.min()):.3e}")
    s2 = float(out.state.sigma2)
    # tests/test_serve_facade.py:35-38, fused tier against the other tier
    for name, mean in (("mean", fm), ("mean-only", fmo)):
        _ex_close(failures, f"config 5 fused {name} vs ring (m=1M)", mean,
                  rm, 1e-4, 1e-4 * max(1.0, s2))
    _ex_close(failures, "config 5 fused var vs ring (m=1M)", fv, rv, 2e-3,
              1e-4 * s2)
    sec = out.seconds
    print(f"    config 5 rates: ring {EX_M / sec['ring_predict']:,.0f} "
          f"mean+var points/s; fused {EX_M / sec['fused mean+var']:,.0f} "
          f"mean+var, {EX_M / sec['fused mean']:,.0f} mean-only; fit_large "
          f"{sec['fit_large'] * 1e3:.1f} ms, predictor_large "
          f"{sec['predictor_large'] * 1e3:.1f} ms ({card})")
    subset = {name: v[:EX_REF_M].double().cpu() for name, v in (
        ("queries", out.xs), ("ring", rm), ("fused", fm),
        ("fused mean-only", fmo))}
    del out
    torch.cuda.empty_cache()
    return got, subset


def ex_branin(dev, card, failures, times, work):
    """BASELINE config 2 at n=80, 8 tries (tests/test_acceptance_configs.py
    :20-38's bounds)."""
    out, got = _ex_run("branin_2d (config 2, n=80, fp64)",
                       lambda: branin_2d.main(device=dev, verbose=False),
                       card, failures, times)
    if out is None:
        return got
    emul, sens = out
    noise_var = float(torch.exp(emul.params.log_nugget) * emul.state.sigma2)
    _ex_hold(failures, "branin noise variance", 0.2 < noise_var < 80.0,
             f"{noise_var:.3f} in (0.2, 80)")
    xt = np.random.default_rng(1).uniform([-5, 0], [10, 15], size=(200, 2))
    mean, _ = emul.predict(xt)
    truth = branin_2d.branin(xt[:, 0], xt[:, 1])
    rel = float(np.sqrt(np.mean((mean.cpu().numpy() - truth) ** 2))
                / np.std(truth))
    _ex_hold(failures, "branin relative RMSE on the truth", rel < 0.25,
             f"{rel:.4f} (< 0.25)")
    si = sens.sensitivity()["S_i"].cpu().numpy()
    _ex_hold(failures, "branin S_i", bool(np.all(si > -0.01))
             and si.sum() < 1.15, f"{np.round(si, 4)}, sum {si.sum():.4f}")
    return got


def ex_10d(dev, card, failures, times, work):
    """BASELINE config 3 at n=500, 8 tries (tests/test_acceptance_configs.py
    :40-75's ordering and Monte-Carlo check on the emulator)."""
    out, got = _ex_run("synthetic_10d (config 3, n=500, fp64)",
                       lambda: synthetic_10d.main(device=dev, verbose=False),
                       card, failures, times)
    if out is None:
        return got
    emul, _, si, _ = out
    s_i = si["S_i"].cpu().numpy()
    _ex_hold(failures, "10-D S_i ordering", s_i[0] > s_i[2] > s_i[4]
             and s_i[0] > 0.15 and bool(np.all(s_i[8:] < 0.02)),
             f"{np.round(s_i, 4)}")
    rng = np.random.default_rng(2)
    z = 0.5 + np.sqrt(0.02) * rng.standard_normal((8000, 10))
    mean_z, var_z = emul.predict(z)
    mc = float(mean_z.cpu().numpy().var() + var_z.cpu().numpy().mean())
    v_total = float(si["V_total"])
    _ex_hold(failures, "10-D V_total vs Monte Carlo on the emulator",
             abs(v_total - mc) / mc < 0.15,
             f"{v_total:.5g} vs {mc:.5g} (within 15%)")
    return got


def ex_hmc(dev, card, failures, times, work):
    """BASELINE config 4: 64 chains, HMC, n=120, 400 + 400 draws."""
    name = "hmc_bayes (config 4, 64 chains, 400 + 400, fp64)"
    out, got = _ex_run(name, lambda: hmc_bayes.main(device=dev), card,
                       failures, times)
    if out is None:
        return got
    samples, stats = out
    rhat = hmc.split_rhat(samples).cpu().numpy()
    _ex_hold(failures, "config 4 split R-hat", bool(np.all(rhat < EX_RHAT))
             and bool(torch.isfinite(samples).all()),
             f"{np.round(rhat, 4)} (< {EX_RHAT})")
    draws = samples.shape[0] * samples.shape[1]
    print(f"    config 4: {draws / times[name][0]:.0f} post-warmup draws/s "
          f"over the whole run, accept {float(stats['accept_rate']):.3f} "
          f"({card})")
    return got


def ex_toy(dev, card, failures, times, work):
    """BASELINE config 1: setup -> train -> final_build, LOO, a 201-point
    grid (phase 4 (g)'s bound)."""
    out, got = _ex_run("toy_sim (config 1, fp64)",
                       lambda: toy_sim.main(device=dev, workdir=work,
                                            verbose=False), card, failures,
                       times)
    if out is None:
        return got
    _, (_, _, se), (xg, mean, var) = out
    written = sorted(p.name for p in (work / "toy-sim").glob("*-f"))
    _ex_hold(failures, "toy-sim final_build files", written == [
        "toy-sim_beliefs-f", "toy-sim_input-f", "toy-sim_output-f"],
        str(written))
    rmse = float(np.sqrt(np.mean((mean.cpu().numpy()
                                  - toy_sim.toy_sim(xg)) ** 2)))
    _ex_hold(failures, "toy-sim grid RMSE against the simulator",
             rmse < 0.05 and float(var.min()) >= 0
             and bool(torch.isfinite(se).all()),
             f"{rmse:.3e} (< 0.05) on {len(xg)} points; LOO max |std err| "
             f"{float(se.abs().max()):.3f}")
    return got


def ex_sensitivity(dev, card, failures, times, work):
    """examples/sensitivity-2d's file workflow (tests/test_acceptance_
    configs.py:78-101's bounds, read from the written table)."""
    out, got = _ex_run("sensitivity_2d (fp64)",
                       lambda: sensitivity_2d.main(device=dev, workdir=work,
                                                   verbose=False),
                       card, failures, times)
    if out is None:
        return got
    tree = out[2]
    lines = (tree / "sens2d_indices").read_text().strip().splitlines()
    rows = [ln.split() for ln in lines[4:]]
    s_i = np.array([float(r[2]) for r in rows])
    s_ti = np.array([float(r[4]) for r in rows])
    _ex_hold(failures, "sensitivity-2d indices table",
             lines[0].startswith("E*[E(Y)]") and s_i[0] > s_i[1] > 0
             and 0.9 < s_i.sum() < 1.1 and bool(np.all(s_ti >= s_i - 0.02))
             and (tree / "sens2d_beliefs-f").exists(),
             f"S_i {s_i}, S_Ti {s_ti}")
    return got


def ex_noise(dev, card, failures, times, work):
    """examples/noise-fit, both scripts (tests/test_acceptance_configs.py
    :104-129: the files written, the estimated sd rising)."""
    out, got = _ex_run("noise_fit (arrays, n=200, stopat=5, fp64)",
                       lambda: noise_fit.main(device=dev, verbose=False),
                       card, failures, times)
    if out is not None:
        est = out[1]
        _ex_hold(failures, "noise fit (arrays) sd rising",
                 bool(np.all(np.isfinite(est))) and est[-1] > est[0],
                 f"{est[0]:.3f} at 0.05 -> {est[-1]:.3f} at 0.95 (truth "
                 f"0.12 -> 0.48)")
    out, got_files = _ex_run(
        "noise_fit (files, stopat=5, olhcmult=100, fp64)",
        lambda: noise_fit.main_files(device=dev, workdir=work,
                                     verbose=False), card, failures, times)
    if out is not None:
        tree = out[2]
        names = ("noisefit_output-noise-it0", "noisefit_output-noise",
                 "noisefit_data_beliefs-f", "noisefit_noise_beliefs-f")
        it0 = np.loadtxt(tree / names[0])
        rise = np.sqrt(nf.predict_noise(out[0], np.array([0.1, 0.9])))
        _ex_hold(failures, "noise fit (files) written and rising",
                 all((tree / f).exists() for f in names)
                 and it0.shape == (150,) and bool(np.all(it0 > 0))
                 and rise[1] > rise[0],
                 f"sd {rise[0]:.3f} at 0.1 -> {rise[1]:.3f} at 0.9")
    return {k: got.get(k, 0) + got_files.get(k, 0) for k in _WRAPPERS}


def ex_matrix_free(dev, card, failures, times, work):
    """examples/matrix-free at its n=800, 60 Adam steps: the serving RMSE."""
    out, got = _ex_run("matrix_free (n=800, 60 steps, fp64)",
                       lambda: matrix_free.main(device=dev, verbose=False),
                       card, failures, times)
    if out is not None:
        _ex_hold(failures, "matrix-free serving RMSE", out[2] < EX_MF_RMSE,
                 f"{out[2]:.3e} (< {EX_MF_RMSE:g}; phase 7's {MF_RMSE:g} is "
                 f"at n = 131072)")
    return got


# the workflows the workers run, the longest first (phase 9 alone on an H100
# 80GB HBM3 at 700 W: 86, 58, 57, 27 + 26, 9, 6 and 4 s one after another)
EXAMPLE_RUNS = {"toy_sim": ex_toy, "hmc_bayes": ex_hmc,
                "sensitivity_2d": ex_sensitivity, "noise_fit": ex_noise,
                "synthetic_10d": ex_10d, "matrix_free": ex_matrix_free,
                "branin_2d": ex_branin}


def _ex_job(name, device_type, card, work):
    """One workflow of EXAMPLE_RUNS in a worker: (its printed lines,
    failures, (seconds, peak GiB) by window, launches)."""
    torch.set_num_threads(1)
    failures, times = [], {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = EXAMPLE_RUNS[name](torch.device(device_type), card, failures,
                                 times, Path(work))
    return buf.getvalue(), failures, times, got


def phase_examples(dev, card):
    """Phase 9: every module of `gp_emu_uqsa_torch.examples` at its
    published size, each in a launch window of its own: config 5 in this
    process alone on the card (its fp64 CPU reference in a worker
    meanwhile), then the fp64 workflows in EX_WORKERS spawned workers
    sharing the card. Every check is collected and the phase fails at its
    end if any failed. Returns the launches (K1-K4) summed over the
    windows."""
    print(f"[phase 9] the example workflows ({card})")
    torch.cuda.empty_cache()
    failures, times = [], {}
    launches = dict.fromkeys(_WRAPPERS, 0)

    def add(got):
        for k in launches:
            launches[k] += got.get(k, 0)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ProcessPoolExecutor(
                EX_WORKERS,
                mp_context=multiprocessing.get_context("spawn")) as pool:
        reference = pool.submit(ex_reference)
        got, subset = ex_config5(dev, card, failures, times)
        add(got)
        t_config5 = time.perf_counter() - t0
        jobs = {name: pool.submit(_ex_job, name, dev.type, card,
                                  str(Path(tmp) / name))
                for name in EXAMPLE_RUNS}
        if subset is not None:
            hold_reference(subset, reference.result(), failures)
        for name, job in jobs.items():
            try:
                text, failed, took, got = job.result()
            except Exception as err:       # a worker that died
                failures.append(f"{name}: worker failed: {err!r}")
                continue
            print(text, end="")
            failures += failed
            times.update(took)
            add(got)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s on the host "
          f"clock: config 5 {t_config5:.1f} s, then the workers; by window "
          f"(s, peak GiB; the workers' seconds shared the card and the "
          f"host with each other): "
          + "; ".join(f"{k} {t:.1f}, {p:.2f}" for k, (t, p) in times.items()))
    print(f"  launches in phase 9's windows: {launches}")
    if failures:
        raise SmokeFailure("phase 9: " + "; ".join(failures))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    peak_name, peaks = _peaks(kind)
    print(f"[phase 1] card: {card}; {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; bound peaks: "
          f"H100 {peak_name} {peaks[0] / 1e12:g} TB/s, {peaks[1] / 1e12:g} "
          f"TFLOP/s fp32, {peaks[2] / 1e12:g} TFLOP/s TF32, "
          f"{peaks[3] / 1e12:g} TFLOP/s bf16")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"  built {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s into {_build.build_dir()}")
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                       "arning")):
                print(f"  {src}: {line.strip()}")
    log = _build.build_log.get(km._SOURCE)
    plan = (ctypes.c_int * 3)()
    for name, self_, (m, n), body in (
            ("K1", 1, (N_TRAIN, N_TRAIN), "corr_build_kernelILb1E"),
            ("K2", 0, (N_VALID, N_TRAIN), "corr_build_kernelILb0E")):
        _build.kernel(km._SOURCE, "gp_corr_build_plan",
                      (ctypes.c_int,) * 3 + (ctypes.c_void_p,))(
            self_, m, n, ctypes.addressof(plan))
        report = ("not rebuilt in this run" if log is None
                  else "; ".join(ptxas_report(log, body)))
        print(f"  {name} body ptxas: {report}; at {m} x {n}: {plan[0]} tiles "
              f"on {plan[1]} blocks, {plan[2]} bytes of dynamic shared "
              f"memory a block")

    rows = phase_kernels(dev, peaks, card)
    launches, launches_highest = phase_serve(dev, card)
    phase_reference(dev)
    launches_train = phase_train(dev, card)
    launches_uqsa = phase_uqsa(dev, card)
    launches_bayes = phase_bayes(dev, card)
    launches_mf = phase_matrix_free(dev, card, k1_ms=rows["K1"][1])
    launches_md = phase_multi_device(dev, card)
    launches_ex = phase_examples(dev, card)

    where = {
        "K1": ("gaussian_corr_self", "gp_emu_uqsa_torch/csrc/corr_build.cu",
               "gp_emu_uqsa_tpu/ops/kernel_matrix.py:181"),
        "K2": ("gaussian_corr", "gp_emu_uqsa_torch/csrc/corr_build.cu",
               "gp_emu_uqsa_tpu/ops/kernel_matrix.py:122"),
        "K3": ("corr_matvec", "gp_emu_uqsa_torch/csrc/corr_matvec.cu",
               "gp_emu_uqsa_tpu/ops/serve.py:103"),
        "K4 high": ("corr_quad (high, 3xTF32 wgmma)",
                    "gp_emu_uqsa_torch/csrc/corr_quad.cu",
                    "gp_emu_uqsa_tpu/ops/serve.py:371"),
        "K4 highest": ("corr_quad (highest, fp32)",
                       "gp_emu_uqsa_torch/csrc/corr_quad.cu",
                       "gp_emu_uqsa_tpu/ops/serve.py:371"),
    }
    launches = {**launches, "K4 high": launches["K4"],
                "K4 highest": launches_highest}
    launches_train = {**launches_train, "K4 high": launches_train["K4"],
                      "K4 highest": launches_train["K4"]}
    launches_uqsa = {**launches_uqsa, "K4 high": launches_uqsa["K4"],
                     "K4 highest": launches_uqsa["K4"]}
    launches_bayes = {**launches_bayes, "K4 high": launches_bayes["K4"],
                      "K4 highest": launches_bayes["K4"]}
    launches_mf = {**launches_mf, "K4 high": launches_mf["K4"],
                   "K4 highest": launches_mf["K4"]}
    launches_md = {**launches_md, "K4 high": launches_md["K4"],
                   "K4 highest": launches_md["K4"]}
    # phase 9 serves with quad_precision "high" only
    launches_ex = {**launches_ex, "K4 high": launches_ex["K4"],
                   "K4 highest": 0}
    entries = []
    for key, (name, source, replaces) in where.items():
        err, t, t_wrap, tp, (b, by), lib = rows[key]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[key],
                        "training_launches": launches_train[key],
                        "uqsa_launches": launches_uqsa[key],
                        "sampling_launches": launches_bayes[key],
                        "matrix_free_launches": launches_mf[key],
                        "multi_device_launches": launches_md[key],
                        "examples_launches": launches_ex[key],
                        "max_abs_err": err, "ms": t, "wrapper_ms": t_wrap,
                        "plain_ms": tp, "bound_ms": b, "bound_by": by,
                        "library_ms": lib})
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
