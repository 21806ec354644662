"""The repo's example workflows on the port, one module a script of
`examples/`:

    large_scale     examples/large-scale/run_large.py    BASELINE config 5
    branin_2d       examples/branin-2d/run_branin.py     BASELINE config 2
    synthetic_10d   examples/synthetic-10d/run_10d.py    BASELINE config 3
    hmc_bayes       examples/hmc-bayes/run_hmc.py        BASELINE config 4
    toy_sim         examples/toy-sim (data only)         BASELINE config 1
    sensitivity_2d  examples/sensitivity-2d/run_sensitivity.py
    noise_fit       examples/noise-fit/run_noisefit.py, run_noisefit_files.py
    matrix_free     examples/matrix-free/run_matrix_free.py

Each module has a `main(...)` with the script's parameters and published
defaults, plus `device` (None: the CUDA card; "cpu" for the plain
PyTorch path), `dtype` (the script's: fp64 where it enables x64; config
5 fp32 on the card) and `workdir`, and returns what the script's `main`
returns. Each runs as `python -m gp_emu_uqsa_torch.examples.<name>
[--device cpu] [--workdir DIR]`. The file-driven workflows copy their
source tree (`examples/<name>/` beside the package, or `src=`) into
`workdir` and run there; nothing writes into the repo. The modules import
neither jax nor gp_emu_uqsa_tpu: the scripts' simulators are copied here.
"""
