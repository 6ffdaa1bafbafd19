"""Device selection for the port's entry points.

Every entry point runs on the GPU unless its caller asks for the CPU.
There is no probing and no fallback: asking for CUDA on a machine
without a usable card is an error, so a run never silently measures or
computes on the wrong device.
"""
from __future__ import annotations

import torch


def resolve_device(requested=None) -> torch.device:
    """``cuda`` unless ``requested`` says ``"cpu"``; raises when CUDA is
    asked for (explicitly or by default) and is not available."""
    dev = torch.device("cuda" if requested is None else requested)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (use 'cuda' or 'cpu')"
                         % (requested,))
    return dev
