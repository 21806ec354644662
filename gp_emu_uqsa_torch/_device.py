"""Device policy of the port: CUDA unless the caller asks for the CPU.

Entry points that create tensors (`make_params`, `params_from_numpy`,
`Emulator`, `load_emulator`) take `device=`. `None` means the CUDA card;
without one they raise rather than run quietly on the CPU. Functions on
tensors run where their tensors are.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None -> "cuda". Raises without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
