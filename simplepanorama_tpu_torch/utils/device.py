"""The device a stage runs on.

Every stage entry point of the port takes ``device`` and runs on the card
(``"cuda"``) unless the caller asks for another device; asking for the
card with no GPU present raises here instead of running on the CPU.

Stitches may run in several threads of one process. The CUDA graph
captures of the port (ba.LMProgram) take ``CAPTURE_LOCK``, one at a
time, as PyTorch allows one capture underway in a process; so do the
port's releases of the caching allocator's blocks (``empty_cache``),
which the allocator, shared by every thread, must not make while a
capture runs. The card's linear algebra is set to cuSOLVER for the
process at the port's first use of the card, and never put back
(``cusolver_linalg``), so that no thread's result depends on what
another thread runs at the same time.
"""

from __future__ import annotations

import threading

import torch

CAPTURE_LOCK = threading.Lock()


def empty_cache() -> None:
    """torch.cuda.empty_cache(), never while a capture runs."""
    with CAPTURE_LOCK:
        torch.cuda.empty_cache()


def full_precision() -> None:
    """Full float32 matmuls and convolutions (no TF32) on the GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def cusolver_linalg() -> None:
    """The card's linear algebra on cuSOLVER, for the whole process.
    The BA's solve must run on the device to be captured (a small getrf
    may otherwise go to MAGMA, which works on the host), and
    torch.backends.cuda.preferred_linalg_library is one setting for the
    process: set once and kept, it gives every thread's linear algebra
    on the card (the BA's solves, adjacency's inverses, the rotations'
    SVDs) one backend whatever runs beside it."""
    torch.backends.cuda.preferred_linalg_library("cusolver")


def checked_device(device) -> torch.device:
    """``device`` as a torch.device, with full float32 precision set, and
    on the card the linear algebra on cuSOLVER (cusolver_linalg); a CUDA
    device with no GPU present raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' asked for, but no CUDA "
                               "device is available")
        cusolver_linalg()
    full_precision()
    return device
