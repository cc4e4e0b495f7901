"""The device a stage runs on.

Every stage entry point of the port takes ``device`` and runs on the card
(``"cuda"``) unless the caller asks for another device; asking for the
card with no GPU present raises here instead of running on the CPU.
"""

from __future__ import annotations

import torch


def full_precision() -> None:
    """Full float32 matmuls and convolutions (no TF32) on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def checked_device(device) -> torch.device:
    """``device`` as a torch.device, with full float32 precision set; a
    CUDA device with no GPU present raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' asked for, but no CUDA device "
                           "is available")
    full_precision()
    return device
