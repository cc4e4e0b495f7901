"""Column-sharded grid min-cut: push-relabel over the ranks of a mesh.

Port of simplepanorama_tpu/parallel/dist_mincut.py. The same solver core
as ops/maxflow.grid_mincut_ref (``_mincut_core``, the same phase schedule
and arithmetic) runs on each rank's slab of grid columns: every
neighbour access across a slab boundary becomes a one-column halo swap
(parallel.tiled_compose.halo_exchange), every loop predicate an
all_reduce(MAX), and the BFS is the lock-step sweep (_dist_to_sink),
whose shifts reach one cell. So the two return the same cut, bit for bit.

This is the port of XLA code: the JAX package's sharded path launches no
Pallas kernel, and this one runs as PyTorch ops on every device. It is a
library function, not a stand-in for a kernel: the seam finder takes
kernels 1 and 2 (ops/maxflow.grid_mincut_auto) on the card in a world of
any size, each rank solving the whole graph it holds
(render/graphcut._solve_cut). Its sweep BFS reads one predicate from the
device every 8 sweeps, so it is slower than the scan BFS of the plain
solver, itself some 50 times slower than kernel 1 on an H100.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simplepanorama_tpu_torch.ops import maxflow as mf
from simplepanorama_tpu_torch.parallel.mesh import (Mesh, all_gather_cat,
                                                    any_ranks, pad_leading)
from simplepanorama_tpu_torch.parallel.tiled_compose import halo_exchange


def _make_shift_sharded(mesh: Mesh):
    """A drop-in for maxflow._shift on column slabs: row shifts are local;
    column shifts swap one halo column with the neighbouring ranks."""

    def shift(x, dy, dx, fill):
        W = x.shape[1]
        if dx != 0:
            xp = halo_exchange(x, 1, mesh, fill=float(fill))
            x = xp[:, 1 + dx:1 + dx + W]
        if dy != 0:
            x = mf._shift(x, dy, 0, fill)
        return x

    return shift


def grid_mincut_sharded(cap_h, cap_v, excess0, node, mesh: Mesh,
                        max_outer: int = 400, inner_iters: int = 30,
                        sweep_iters: int = 0):
    """ops.maxflow.grid_mincut_ref with the (H, W) grid column-sharded over
    ``mesh``. Same arguments (whole grids, the same on every rank, on the
    rank's device) and result (the whole (H, W) source side on every
    rank); W is padded to a multiple of the mesh size (padding cells are
    not nodes)."""
    H, W = cap_h.shape
    n = mesh.size
    Wp = pad_leading(W, n)
    Ws = Wp // n
    if sweep_iters <= 0:
        sweep_iters = H + Wp + 4

    def slab(x, dtype):
        x = F.pad(x.to(dtype), (0, Wp - W))
        return x[:, mesh.rank * Ws:(mesh.rank + 1) * Ws].contiguous()

    side = mf._mincut_core(
        slab(cap_h, torch.float32), slab(cap_v, torch.float32),
        slab(excess0, torch.float32), slab(node, torch.float32) > 0.5,
        max_outer, inner_iters, sweep_iters,
        shift=_make_shift_sharded(mesh), gany=lambda b: any_ranks(b, mesh))
    return all_gather_cat(side, mesh, dim=1)[:, :W]
