"""The port's default device: the CUDA card, never a silent CPU fallback."""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``torch.device(device)``; raises when a CUDA device is asked for
    (the default) and none is present. The CPU runs the plain PyTorch
    versions of the kernels and is asked for with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the plain PyTorch version on the CPU")
    return dev
