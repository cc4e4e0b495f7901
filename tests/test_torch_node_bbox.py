"""The node-box crop of large seam grids in the port's min-cut dispatch
(ops/maxflow._node_bbox and grid_mincut_auto), against the JAX package on
the CPU.

The JAX package crops a concrete grid over its whole-grid limit to the
node bounding box before it solves (maxflow.py:723-777); the port does
the same. Cells outside the box are not nodes, so the crop's cut is the
whole grid's: held here against the JAX package's full-grid solve, scipy's
exact max flow and the JAX package's graph_cut_state. The limit is
monkeypatched small so that grids of a few thousand cells count as over
it. The card's route: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from simplepanorama_tpu.ops import maxflow as jmf
from simplepanorama_tpu.render import graphcut as jgc
from simplepanorama_tpu.render.compose import ComposeState as JState
from simplepanorama_tpu_torch.convert import compose_state_from_numpy
from simplepanorama_tpu_torch.fixtures import cut_grid, max_flow_value
from simplepanorama_tpu_torch.ops import maxflow as tmf
from simplepanorama_tpu_torch.render import graphcut as tgc

torch.set_num_threads(2)


def _mask(case, H, W, seed):
    """A seeded node mask for _node_bbox."""
    rng = np.random.default_rng(seed)
    m = np.zeros((H, W), bool)
    if case == "one_cell":
        m[rng.integers(1, H - 1), rng.integers(1, W - 1)] = True
    elif case in ("top", "bottom", "left", "right"):
        y, x = rng.integers(H // 4, H // 2), rng.integers(W // 4, W // 2)
        rows = slice(0, y) if case == "top" else (
            slice(H - y, H) if case == "bottom" else slice(y // 2, y))
        cols = slice(0, x) if case == "left" else (
            slice(W - x, W) if case == "right" else slice(x // 2, x))
        m[rows, cols] = True
    elif case == "band":
        x0 = rng.integers(W // 5, W // 3)
        m[3:H - 5, x0:x0 + W // 4] = True
    elif case == "ragged":
        for y in range(2, H - 3):
            a = rng.integers(W // 3, W // 2)
            m[y, a:a + rng.integers(1, W // 4)] = True
    elif case == "scattered":
        m = rng.uniform(size=(H, W)) < 0.002
    return m


_CASES = ["empty", "one_cell", "top", "bottom", "left", "right", "band",
          "ragged", "scattered"]


@pytest.mark.parametrize("shape", [(24, 32), (61, 300), (130, 777)])
@pytest.mark.parametrize("case", _CASES)
def test_node_bbox_matches_jax(case, shape):
    """The port's _node_bbox equals the JAX package's exactly, None for
    an empty mask; W of 300 and 777 make the 128-column alignment bite
    inside the grid."""
    H, W = shape
    m = _mask(case, H, W, seed=H + W)
    want = jmf._node_bbox(m, H, W)
    got = tmf._node_bbox(torch.from_numpy(m), H, W)
    assert got == want
    assert (want is None) == (case == "empty")
    if want is not None:
        r0, r1, c0, c1 = want
        assert m[r0:r1, c0:c1].sum() == m.sum()


def _band_grid(H, W, seed, lo=(180, 220), hi=(310, 340)):
    """A seam graph whose nodes are a ragged vertical band (each row from
    a left edge in ``lo`` to a right edge in ``hi``): capacities of
    cut_grid, t-links of 5000 to the source at each row's left end and to
    the sink at its right end."""
    wh, wv, _, _ = cut_grid(H, W, seed, (0, 0, 0, 0))
    rng = np.random.default_rng(seed + 100)
    node = np.zeros((H, W), bool)
    exc = np.zeros((H, W), np.float32)
    for y in range(H):
        a, b = rng.integers(*lo), rng.integers(*hi)
        node[y, a:b] = True
        exc[y, a] = 5000.0
        exc[y, b - 1] = -5000.0
    return wh, wv, exc, node


def _record(monkeypatch):
    """Record which plain solver each grid_mincut_auto call reaches, with
    the shape it was given."""
    calls = []
    whole, tiled = tmf.grid_mincut_ref, tmf.grid_mincut_tiled_ref
    monkeypatch.setattr(tmf, "grid_mincut_ref", lambda *a, **k: (
        calls.append(("whole", tuple(a[0].shape))) or whole(*a, **k)))
    monkeypatch.setattr(tmf, "grid_mincut_tiled_ref", lambda *a, **k: (
        calls.append(("tiled", tuple(a[0].shape))) or tiled(*a, **k)))
    return calls


@pytest.mark.parametrize("case,limit,want", [
    # the box is 40 x 256 = 10,240 of 16,000 cells (0.64)
    ("band", 10_240, ("whole", (40, 256))),
    ("band", 10_239, ("tiled", (40, 256))),
    # the box is the whole grid
    ("wide", 10_240, ("tiled", (40, 400))),
    ("empty", 10_240, ("tiled", (40, 400))),
])
def test_auto_crops_to_node_box(monkeypatch, case, limit, want):
    """Over WHOLE_GRID_MAX_CELLS, a box of at most 0.9 of the grid is
    solved on the crop, by the whole-grid solver at or under the limit
    and by the tiled one over it, and the side is False outside the box
    and equal to the uncropped solve inside; a box over 0.9, or no nodes,
    sends the full grid to the tiled solver."""
    H, W = 40, 400
    lo, hi = ((150, 151), (260, 261)) if case == "band" else \
        ((10, 11), (390, 391))
    wh, wv, exc, node = _band_grid(H, W, 2, lo, hi)
    if case == "empty":
        node[:] = False
        exc[:] = 0.0
    t = [torch.from_numpy(a) for a in (wh, wv, exc, node)]
    monkeypatch.setattr(tmf, "WHOLE_GRID_MAX_CELLS", limit)
    calls = _record(monkeypatch)
    side = tmf.grid_mincut_auto(*t)
    assert calls == [want]
    assert side.shape == (H, W) and side.dtype == torch.bool
    assert not side[~t[3]].any()
    full = tmf.grid_mincut_tiled_ref(*t).numpy()
    v_c = tmf.cut_value(wh, wv, exc, node, side.numpy())
    v_f = tmf.cut_value(wh, wv, exc, node, full)
    assert abs(v_c - v_f) <= 1e-3 * max(1.0, v_f), (v_c, v_f)
    if node.any():
        assert (side.numpy() == full)[node].mean() >= 0.999


@pytest.mark.parametrize("limit,solver", [(20_000, "whole"),
                                          (16_000, "tiled")])
def test_cropped_cut_matches_jax_full_grid_and_scipy(monkeypatch, limit,
                                                     solver):
    """The port's cropped cut of a 64x512 band grid (32,768 cells, box
    64x256) against the JAX package's grid_mincut_auto on the CPU, which
    solves the full grid, and against scipy's exact max flow. Tolerance:
    cut values within 1e-3 relative, sides equal on >= 99.9% of nodes."""
    wh, wv, exc, node = _band_grid(64, 512, 5)
    monkeypatch.setattr(tmf, "WHOLE_GRID_MAX_CELLS", limit)
    calls = _record(monkeypatch)
    side_t = tmf.grid_mincut_auto(
        *(torch.from_numpy(a) for a in (wh, wv, exc, node))).numpy()
    assert calls == [(solver, (64, 256))]
    side_j = np.asarray(jmf.grid_mincut_auto(
        *(jnp.asarray(a) for a in (wh, wv, exc, node))))
    v_t = tmf.cut_value(wh, wv, exc, node, side_t)
    v_j = tmf.cut_value(wh, wv, exc, node, side_j)
    exact = max_flow_value(wh, wv, exc, node)
    assert abs(v_t - v_j) <= 1e-3 * max(1.0, v_j), (v_t, v_j)
    assert abs(v_t - exact) <= 1e-3 * max(1.0, exact), (v_t, exact)
    assert (side_t == side_j)[node].mean() >= 0.999


def _blocks(seed=3):
    """The synthetic 3-image block set of tests/test_graphcut.py:231-244."""
    rng = np.random.default_rng(seed)
    n, Hb, Wb = 3, 48, 128
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    masks = np.zeros((n, Hb, Wb), bool)
    offs = np.array([[0, 0], [10, 60], [20, 120]], np.int32)
    rois = []
    for i in range(n):
        h, w = 40 + i, 100 + 5 * i
        masks[i, 1:h - 1, 1:w - 1] = True
        rois.append((int(offs[i, 1]), int(offs[i, 0]), w, h))
    return JState(imgs=jnp.asarray(imgs), masks=jnp.asarray(masks),
                  offs=jnp.asarray(offs), rois=rois, canvas_hw=(80, 256),
                  min_xy=(0, 0))


def test_graph_cut_state_on_cropped_blocks_matches_jax(monkeypatch):
    """graph_cut_state with the limit patched below the 48x128 blocks,
    so each cut is solved on its node box, against the JAX package's
    graph_cut_state (full blocks) on the CPU: seams equal on >= 99.9% of
    each image's pixels."""
    jstate = _blocks()
    seq = [0, 1, 2]
    seams_j = np.asarray(jgc.graph_cut_state(jstate, seq))
    monkeypatch.setattr(tmf, "WHOLE_GRID_MAX_CELLS", 1000)
    calls = _record(monkeypatch)
    seams_t = tgc.graph_cut_state(
        compose_state_from_numpy(jstate, device="cpu"), seq).numpy()
    assert len(calls) == 2
    assert all(shape[0] < 48 and shape[1] == 128 for _, shape in calls), \
        calls
    for i, r in enumerate(jstate.rois):
        agree = (seams_t[i, :r[3], :r[2]] == seams_j[i, :r[3], :r[2]]).mean()
        assert agree >= 0.999, (i, agree)
