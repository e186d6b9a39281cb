"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for the CPU.  A
missing GPU is an error, never a quiet fall back to the CPU: a run that was
meant for the card and silently ran on the host would report host numbers
under the card's name.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise ``RuntimeError`` if CUDA is asked for and
    no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: --opts device cpu) to run on the CPU"
        )
    return dev


def set_fp32_parity_mode() -> dict:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls.

    cuDNN runs float32 convolutions in TF32 by default, which alone breaks
    the float32 parity bounds the port is held to.  Returns the two flags so
    the caller can print them.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
    }
