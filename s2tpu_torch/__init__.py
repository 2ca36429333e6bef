"""s2tpu_torch: the PyTorch + CUDA port of s2tpu for NVIDIA Hopper.

The JAX package ``s2tpu`` stays the reference. This package imports neither
JAX nor anything of ``s2tpu``; it keeps its own copies of what it needs.
Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name: str | None = None) -> torch.device:
    """Device for an entry point: ``cuda`` by default; ``cpu`` only on request.

    Raises when CUDA is asked for (explicitly or by default) and absent, so a
    run meant for the card never falls back to the CPU silently.
    """
    device = torch.device(name if name is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
