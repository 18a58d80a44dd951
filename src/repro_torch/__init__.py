"""PyTorch/CUDA port of the paged-KV serving stack in :mod:`repro`.

The package mirrors the module names of the JAX package so that each
counterpart is easy to find, but imports nothing of it: the JAX package is
the reference the tests hold this one to. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; on the CPU every hand-written
kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when a card is asked for and
    there is none (the CPU is used only when the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU"
        )
    return dev
