"""Checkpoint/resume: serialize the post-BA stitch state.

Port of simplepanorama_tpu/utils/checkpoint.py, numpy only. A
StitchResult (rot/K/adjacency/order/center/sizes/nodes) and the source
image list go to one compressed .npz with JSON metadata (``version: 1``),
so compositing, including full-resolution re-renders with other blend,
seam or projection settings, resumes without features, matching or
bundle adjustment. The layout is the JAX package's: a file written by
either package loads in the other.
"""

from __future__ import annotations

import json
import pathlib
from typing import Union

import numpy as np


def save_stitch_state(path: Union[str, pathlib.Path], res,
                      paths=None) -> None:
    """Write a StitchResult to an .npz (+ JSON metadata inside).
    ``paths``: the source image list (res.nodes indexes into it), stored
    so a resume needs no external bookkeeping."""
    meta = {
        "order": [[int(n), int(c)] for n, c in res.order],
        "nodes": [int(n) for n in res.nodes],
        "center": int(res.center),
        "sizes": [[int(h), int(w)] for h, w in res.sizes],
        "paths": [str(p) for p in paths] if paths is not None else None,
        "version": 1,
    }
    np.savez_compressed(
        str(path),
        rot=np.asarray(res.rot), K=np.asarray(res.K),
        adj=np.asarray(res.adj),
        connectivity=np.asarray(res.connectivity),
        meta=json.dumps(meta))


def load_stitch_state(path: Union[str, pathlib.Path], with_paths=False):
    """The port's StitchResult from a checkpoint (and, with
    ``with_paths``, the stored image list)."""
    from simplepanorama_tpu_torch.stitch import StitchResult
    with np.load(str(path), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        res = StitchResult(
            rot=z["rot"], K=z["K"], adj=z["adj"],
            connectivity=z["connectivity"],
            order=[tuple(p) for p in meta["order"]],
            nodes=list(meta["nodes"]),
            center=int(meta["center"]),
            sizes=[tuple(s) for s in meta["sizes"]])
    if with_paths:
        return res, meta.get("paths")
    return res
