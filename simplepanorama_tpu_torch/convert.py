"""Carry pipeline state across from the JAX package.

The parity tests run one stage of the port on the JAX package's output
of the stage before (the port's compositing on the JAX BA result, say).
These helpers take duck-typed objects whose array fields convert with
``np.asarray``, so this module needs no JAX import.
"""

from __future__ import annotations

import numpy as np
import torch

from simplepanorama_tpu_torch.render.compose import ComposeState
from simplepanorama_tpu_torch.stitch import StitchResult
from simplepanorama_tpu_torch.utils.device import checked_device


def stitch_result_from_numpy(res) -> StitchResult:
    """StitchResult of the port from the JAX package's StitchResult."""
    return StitchResult(
        rot=np.array(res.rot, np.float64), K=np.array(res.K, np.float64),
        adj=np.array(res.adj), connectivity=np.array(res.connectivity),
        order=[tuple(map(int, o)) for o in res.order],
        nodes=[int(g) for g in res.nodes], center=int(res.center),
        sizes=[tuple(map(int, s)) for s in res.sizes])


def compose_state_from_numpy(state, device="cuda") -> ComposeState:
    """ComposeState of the port (tensors on ``device``, the card unless
    the caller asks for another) from the JAX package's ComposeState, or
    from any object with its fields."""
    device = checked_device(device)

    def T(a, dtype):
        return None if a is None else torch.as_tensor(
            np.array(a), dtype=dtype, device=device)
    return ComposeState(
        imgs=T(state.imgs, torch.float32), masks=T(state.masks, torch.bool),
        offs=T(state.offs, torch.int32),
        rois=[tuple(map(int, r)) for r in state.rois],
        canvas_hw=tuple(map(int, state.canvas_hw)),
        min_xy=tuple(map(int, state.min_xy)),
        seam_masks=T(state.seam_masks, torch.bool),
        gains=None if state.gains is None else np.asarray(state.gains),
        intensity=T(state.intensity, torch.float32))
