"""Published peaks of the H100 parts: NVIDIA's data sheets, dense rates
without sparsity, at the full power limit.

  fp32   FLOP/s on the CUDA cores
  tf32   FLOP/s on the tensor cores with TF32 inputs: the card's top rate
         for float32 data, the denominator of every `mfu` metric
  bytes  HBM bytes/s

Matched in order on `torch.cuda.get_device_name()`, the plain "H100"
(the SXM part) last. An unknown card has no peaks, and then no roofline
or mfu metric is reported.
"""
from __future__ import annotations

PEAKS = {
    "H100 PCIe": {"fp32": 51e12, "tf32": 378e12, "bytes": 2.0e12},
    "H100 NVL": {"fp32": 60e12, "tf32": 417.5e12, "bytes": 3.9e12},
    "H100": {"fp32": 67e12, "tf32": 495e12, "bytes": 3.35e12},
}


def for_card(name: str):
    low = name.lower()
    for key, peaks in PEAKS.items():
        if key.lower() in low:
            return peaks
    return None
