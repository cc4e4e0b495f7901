"""Parity of the port's tiled min-cut (ops/maxflow.py) with the JAX
package, and the size dispatch of grid_mincut_auto, on the CPU.

grid_mincut_tiled_ref is the plain PyTorch version of the row-tiled TPU
kernel and the CPU path of grid_mincut_tiled; it is held against that
kernel in interpret mode (as tests/test_graphcut.py:273-301 runs it),
scipy's exact max flow and the whole-grid plain solver. The CUDA kernel
itself runs only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from simplepanorama_tpu.ops.maxflow import grid_mincut_pallas_tiled
from simplepanorama_tpu_torch.fixtures import cut_grid
from simplepanorama_tpu_torch.ops import maxflow as tmf
from test_torch_mincut import _scipy_value

torch.set_num_threads(2)


def _grid(H, W, seed):
    hole = (10, 20, 40, 70) if (H, W) == (48, 160) else (5, 9, 10, 14)
    return cut_grid(H, W, seed, hole)


def test_tiled_ref_matches_pallas_interpret_and_scipy():
    """grid_mincut_tiled_ref against grid_mincut_pallas_tiled(tile_rows=16,
    interpret=True) on the 48x160 grid of tests/test_graphcut.py (3 row
    tiles: cross-tile pushes and multi-round BFS), and against scipy's
    exact cut. Tolerance: cut values within 1e-3 relative (scipy works on
    capacities rounded to 1e-4), sides equal on >= 99.9% of nodes.
    Measured: identical sides and equal cut values (14.8172572), scipy
    14.8173."""
    wh, wv, exc, node = _grid(48, 160, 7)
    side_t = tmf.grid_mincut_tiled_ref(
        *(torch.from_numpy(a) for a in (wh, wv, exc, node)),
        tile_rows=16).numpy()
    side_p = np.asarray(grid_mincut_pallas_tiled(
        *(jnp.asarray(a) for a in (wh, wv, exc, node)), tile_rows=16,
        interpret=True))
    v_t = tmf.cut_value(wh, wv, exc, node, side_t)
    v_p = tmf.cut_value(wh, wv, exc, node, side_p)
    exact = _scipy_value(wh, wv, exc, node)
    assert abs(v_t - v_p) <= 1e-3 * max(1.0, v_p), (v_t, v_p)
    assert abs(v_t - exact) <= 1e-3 * max(1.0, exact), (v_t, exact)
    assert (side_t == side_p)[node].mean() >= 0.999


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_tiled_ref_matches_whole_grid(seed):
    """grid_mincut_tiled_ref with tile_rows=8 (3 tiles) against
    grid_mincut_ref at 24x32. Tolerance: cut values within 1e-3
    relative, sides equal on >= 99.9% of nodes (measured: identical)."""
    t = [torch.from_numpy(a) for a in _grid(24, 32, seed)]
    side_t = tmf.grid_mincut_tiled_ref(*t, tile_rows=8)
    side_w = tmf.grid_mincut_ref(*t)
    v_t = tmf.cut_value(*t, side_t)
    v_w = tmf.cut_value(*t, side_w)
    assert abs(v_t - v_w) <= 1e-3 * max(1.0, v_w), (v_t, v_w)
    node = t[3].numpy()
    assert (side_t.numpy() == side_w.numpy())[node].mean() >= 0.999


@pytest.mark.parametrize("limit,want", [(24 * 32, "whole"),
                                        (24 * 32 - 1, "tiled")])
def test_auto_dispatches_on_cells_without_crop(monkeypatch, limit, want):
    """grid_mincut_auto takes the whole-grid solver at or under
    WHOLE_GRID_MAX_CELLS and the tiled one over it, on H*W alone: the
    chosen solver gets the full grid, even where the nodes fill only a
    small box of it (no bounding-box crop)."""
    wh, wv, exc, node = _grid(24, 32, 3)
    node[:, 20:] = False                 # nodes fill 20 of 32 columns
    exc[:, 19] = -5000.0
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (wh, wv, exc, node)]
    calls = []
    whole, tiled = tmf.grid_mincut_ref, tmf.grid_mincut_tiled_ref
    monkeypatch.setattr(tmf, "WHOLE_GRID_MAX_CELLS", limit)
    monkeypatch.setattr(tmf, "grid_mincut_ref", lambda *a, **k: (
        calls.append(("whole", tuple(a[0].shape))) or whole(*a, **k)))
    monkeypatch.setattr(tmf, "grid_mincut_tiled_ref", lambda *a, **k: (
        calls.append(("tiled", tuple(a[0].shape))) or tiled(*a, **k)))
    side = tmf.grid_mincut_auto(*t)
    assert calls == [(want, (24, 32))]
    assert side.shape == (24, 32) and not side[:, 20:].any()


@pytest.mark.parametrize("solver", ["whole", "tiled"])
def test_plain_stats_count_the_work_without_changing_the_cut(solver):
    """With a ``stats`` dict the plain solvers return the same sides and
    count their work: outer rounds, cells holding excess in the push
    phases (at most every node in each of the 30 phases of a round) and
    node cells of the BFS scan passes (whole grid: a whole number of
    passes over the nodes, at least one per BFS)."""
    t = [torch.from_numpy(a) for a in _grid(24, 32, 1)]
    run = (tmf.grid_mincut_ref if solver == "whole" else
           lambda *a, **k: tmf.grid_mincut_tiled_ref(*a, tile_rows=8, **k))
    stats = {}
    side = run(*t, stats=stats)
    assert torch.equal(side, run(*t))
    nodes = int(t[3].sum())
    assert stats["outer"] >= 1
    assert 0 < stats["push_cells"] <= stats["outer"] * 30 * nodes
    assert all(isinstance(stats[k], int) for k in ("push_cells",
                                                     "scan_cells"))
    if solver == "whole":
        assert stats["scan_cells"] % nodes == 0
        assert stats["scan_cells"] >= (stats["outer"] + 1) * nodes
    else:
        assert stats["scan_cells"] > 0


def test_tiled_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors grid_mincut_tiled runs grid_mincut_tiled_ref (same
    sides) and counts no kernel launch; bad inputs raise as for
    grid_mincut."""
    wh, wv, exc, node = (torch.from_numpy(a) for a in _grid(24, 32, 2))
    before = tmf.grid_mincut_tiled.launches
    side = tmf.grid_mincut_tiled(wh, wv, exc, node)
    assert tmf.grid_mincut_tiled.launches == before
    assert torch.equal(side, tmf.grid_mincut_tiled_ref(wh, wv, exc, node))
    with pytest.raises(TypeError):
        tmf.grid_mincut_tiled(wh.double(), wv, exc, node)
    with pytest.raises(ValueError):
        tmf.grid_mincut_tiled(wh, wv[:, :-1], exc, node)
