"""Tests that need a CUDA card; they skip without one.

The hand-written kernels (both min-cuts and the BA normal-equation
assembly) against their plain PyTorch versions, and the port on the card
(the stereographic remap, a whole render) against the port on the
CPU. This file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from simplepanorama_tpu_torch import Config, Panorama
from simplepanorama_tpu_torch.adjacency import torch_pair_draws
from simplepanorama_tpu_torch.fixtures import (cut_grid, fkh360_views,
                                               max_flow_value, maze_grid)
from simplepanorama_tpu_torch.stitch import StitchResult
from simplepanorama_tpu_torch.ops import ba_kernel, maxflow
from simplepanorama_tpu_torch.render import graphcut
from simplepanorama_tpu_torch.render.compose import ComposeState

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("H,W,seed", [(24, 32, 0), (48, 160, 7),
                                      (200, 328, 3)])
def test_kernel_matches_plain_version(cuda, H, W, seed):
    """grid_mincut (the CUDA kernel) against grid_mincut_ref on the same
    card: cut values within 1e-3 relative (float64 recount) and sides
    equal on >= 99.9% of nodes; one launch counted per call."""
    host = cut_grid(H, W, seed, (H // 5, H // 5 + H // 4, W // 4,
                                 W // 4 + W // 5))
    t = [torch.from_numpy(a).to(cuda) for a in host]
    before = maxflow.grid_mincut.launches
    side_k = maxflow.grid_mincut(*t)
    assert maxflow.grid_mincut.launches == before + 1
    stats = maxflow.grid_mincut.last_stats
    assert stats["resident"] == 1
    assert stats["host_reads"] == stats["outer"] + 1   # one per BFS
    side_r = maxflow.grid_mincut_ref(*t)
    torch.cuda.synchronize()
    v_k = maxflow.cut_value(*host, side_k)
    v_r = maxflow.cut_value(*host, side_r)
    assert abs(v_k - v_r) <= 1e-3 * max(1.0, v_r)
    assert (side_k.cpu().numpy() == side_r.cpu().numpy())[host[3]].mean() \
        >= 0.999


def test_graph_cut_state_card_matches_cpu(cuda):
    """Graph-cut seams of synthetic packed blocks on the card (CUDA
    kernel) and on the CPU (plain solver): seam masks equal on >= 99.9%
    of each block."""
    rng = np.random.default_rng(3)
    n, Hb, Wb = 3, 48, 128
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    masks = np.zeros((n, Hb, Wb), bool)
    offs = np.array([[0, 0], [10, 60], [20, 120]], np.int32)
    for i in range(n):
        masks[i, 1:39 + i, 1:99 + 5 * i] = True

    def state(dev):
        T = lambda a: torch.as_tensor(a, device=dev)
        return ComposeState(imgs=T(imgs), masks=T(masks), offs=T(offs),
                            rois=[], canvas_hw=(80, 256), min_xy=(0, 0))
    before = maxflow.grid_mincut.launches
    on_card = graphcut.graph_cut_state(state(cuda), [0, 1, 2]).cpu().numpy()
    assert maxflow.grid_mincut.launches == before + 2
    on_cpu = graphcut.graph_cut_state(state("cpu"), [0, 1, 2]).numpy()
    assert (on_card == on_cpu).mean(axis=(1, 2)).min() >= 0.999


def test_default_pair_draws_same_on_card(cuda):
    """The pipeline's RANSAC draws come from the CPU generator on every
    device, so the card samples what the CPU samples."""
    on_card = torch_pair_draws(0, 4, cuda)(1, 2, 300, 64)
    assert on_card.device.type == "cuda"
    on_cpu = torch_pair_draws(0, 4, "cpu")(1, 2, 300, 64)
    assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.parametrize("H,W,seed", [(24, 32, 0), (48, 160, 7),
                                      (200, 328, 3)])
def test_tiled_kernel_matches_plain_version(cuda, H, W, seed):
    """grid_mincut_tiled (the CUDA kernel, 2-D tiles) against
    grid_mincut_tiled_ref (row tiles of 16) on the same card: cut values
    within 1e-3 relative (float64 recount) and sides equal on >= 99.9% of
    nodes; one launch counted per call."""
    host = cut_grid(H, W, seed, (H // 5, H // 5 + H // 4, W // 4,
                                 W // 4 + W // 5))
    t = [torch.from_numpy(a).to(cuda) for a in host]
    before = maxflow.grid_mincut_tiled.launches
    side_k = maxflow.grid_mincut_tiled(*t)
    assert maxflow.grid_mincut_tiled.launches == before + 1
    stats = maxflow.grid_mincut_tiled.last_stats
    assert stats["host_reads"] == stats["outer"] + 1   # one per BFS
    side_r = maxflow.grid_mincut_tiled_ref(*t, tile_rows=16)
    torch.cuda.synchronize()
    v_k = maxflow.cut_value(*host, side_k)
    v_r = maxflow.cut_value(*host, side_r)
    assert abs(v_k - v_r) <= 1e-3 * max(1.0, v_r)
    assert (side_k.cpu().numpy() == side_r.cpu().numpy())[host[3]].mean() \
        >= 0.999


_BFS_GRIDS = {
    "random24x32": lambda: cut_grid(24, 32, 0, (4, 10, 8, 14)),
    "random48x160": lambda: cut_grid(48, 160, 7, (10, 20, 40, 70)),
    "random200x328": lambda: cut_grid(200, 328, 3, (40, 90, 82, 148)),
    "maze96x200": lambda: maze_grid(96, 200, 1),
    "maze512x1024": lambda: maze_grid(512, 1024, 2),
    # more 128x128 BFS tiles than CTAs: kernel 2 reloads a tile's
    # distances at every visit
    "random1600x1600": lambda: cut_grid(1600, 1600, 5, (400, 700, 300, 900)),
}


@pytest.mark.parametrize("kernel", ["grid_mincut", "grid_mincut_tiled"])
@pytest.mark.parametrize("grid", sorted(_BFS_GRIDS))
def test_bfs_distances_exact(cuda, kernel, grid):
    """The kernels' bit-parallel tile BFS (maxflow.dist_to_sink on the
    card) gives exactly _dist_to_sink_scan's distances on every cell,
    INF included. The maze's sink distances run to ~130k and cross every
    BFS tile of its rows; at 1600x1600 (both kernels take the tiled
    route) there are more BFS tiles than resident CTAs."""
    host = _BFS_GRIDS[grid]()
    t = [torch.from_numpy(a).to(cuda) for a in host]
    got = maxflow.dist_to_sink(*t, kernel=kernel)
    caps, e = maxflow._init_state(*t)
    want = maxflow._dist_to_sink_scan(caps, e < 0, t[3], host[0].size + 1)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


# ragged shapes: one row, one column, narrower and shorter than one tile
# of either kernel, exact multiples of kernel 2's push (32x128) and BFS
# (128x128) tiles, and a maze whose one path crosses every tile
_SOLVE_GRIDS = {
    "row1x300": lambda: cut_grid(1, 300, 5, (0, 0, 0, 0)),
    "col300x1": lambda: _column(300, 5),
    "small20x100": lambda: cut_grid(20, 100, 6, (5, 9, 30, 40)),
    "tiles128x256": lambda: cut_grid(128, 256, 8, (30, 60, 100, 150)),
    "tiles64x384": lambda: cut_grid(64, 384, 9, (10, 30, 130, 250)),
    "maze64x160": lambda: maze_grid(64, 160, 3),
}


def _column(H, seed):
    """A one-column grid with the source on top and the sink below."""
    wh, wv, exc, node = cut_grid(H, 1, seed, (0, 0, 0, 0))
    exc[:] = 0.0
    exc[0, 0] = 5000.0
    exc[-1, 0] = -5000.0
    return wh, wv, exc, node


@pytest.mark.parametrize("kernel", ["grid_mincut", "grid_mincut_tiled"])
@pytest.mark.parametrize("grid", sorted(_SOLVE_GRIDS))
def test_kernels_on_ragged_shapes_and_maze(cuda, kernel, grid):
    """Each kernel against its plain version and scipy's exact max-flow
    value: cut values within 1e-3 relative (float64 recount; scipy on
    capacities rounded to 1e-4), sides equal on >= 99.9% of nodes, and
    the solve ended by its termination test, before max_outer."""
    host = _SOLVE_GRIDS[grid]()
    t = [torch.from_numpy(a).to(cuda) for a in host]
    fn = getattr(maxflow, kernel)
    plain = (maxflow.grid_mincut_ref if kernel == "grid_mincut" else
             lambda *a: maxflow.grid_mincut_tiled_ref(*a, tile_rows=16))
    side_k = fn(*t, max_outer=400)
    stats = dict(fn.last_stats)
    side_r = plain(*t)
    torch.cuda.synchronize()
    v_k = maxflow.cut_value(*host, side_k)
    v_r = maxflow.cut_value(*host, side_r)
    exact = max_flow_value(*host)
    assert stats["outer"] < 400, stats
    assert abs(v_k - v_r) <= 1e-3 * max(1.0, abs(v_r)), (v_k, v_r)
    assert abs(v_k - exact) <= 1e-3 * max(1.0, exact), (v_k, exact)
    assert (side_k.cpu().numpy() == side_r.cpu().numpy())[host[3]].mean() \
        >= 0.999


def test_kernel1_takes_tiled_route_when_tiles_do_not_fit(cuda):
    """A 1000x1100 grid (1.1M cells, under WHOLE_GRID_MAX_CELLS) is too
    large for kernel 1's tiles to stay resident in shared memory: it takes
    kernel 2's tiled route and gives kernel 2's cut value."""
    host = cut_grid(1000, 1100, 4, (300, 500, 400, 700))
    t = [torch.from_numpy(a).to(cuda) for a in host]
    side_1 = maxflow.grid_mincut(*t)
    stats = dict(maxflow.grid_mincut.last_stats)
    side_2 = maxflow.grid_mincut_tiled(*t)
    torch.cuda.synchronize()
    assert stats["resident"] == 0 and stats["outer"] < 400, stats
    v1 = maxflow.cut_value(*host, side_1)
    v2 = maxflow.cut_value(*host, side_2)
    assert abs(v1 - v2) <= 1e-3 * max(1.0, abs(v2)), (v1, v2)


def _ncc(a, b):
    a = a.astype(np.float64).ravel() - a.mean()
    b = b.astype(np.float64).ravel() - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def test_get_panorama_card_matches_cpu(cuda, tmp_path):
    """get_preview and get_panorama of two 640-px views (preview 320 px)
    with their true geometry put in place of the BA result, graph-cut
    seams and gain compensation, on the card and on the CPU: the same
    shapes, NCC >= 0.98 for both."""
    paths, yaws, f = fkh360_views(2, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                                  out_dir=str(tmp_path))
    fp = f * 320 / 640
    K = np.array([[fp, 0, 160], [0, fp, 160], [0, 0, 1.0]])
    Rs = []
    for yaw in yaws:
        a = np.radians(yaw)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    res = StitchResult(rot=np.stack(Rs), K=np.stack([K, K]),
                       adj=np.array([[0, 0.5], [0, 0]]),
                       connectivity=np.array([1, 1]),
                       order=[(0, -1), (1, 0)], nodes=[0, 1], center=0,
                       sizes=[(320, 320), (320, 320)])
    cfg = Config(cut=True, init_size=320, gain_compensation=True)
    out = {}
    for dev in ("cpu", cuda):
        p = Panorama(paths, device=dev)
        p.result = res
        p.set_config(cfg)
        out[str(dev)] = (p.get_preview(), p.get_panorama())
    (prev_c, full_c), (prev_g, full_g) = out["cpu"], out["cuda"]
    assert prev_c.shape == prev_g.shape and full_c.shape == full_g.shape
    assert _ncc(prev_c, prev_g) >= 0.98 and _ncc(full_c, full_g) >= 0.98


def test_radial_remap_card_matches_cpu(cuda, tmp_path):
    """The stereographic fix's batched radial remap (sten_fix.disk_reproj
    -> _radial_remap) of a 12-view 300-px loop's warp, on the card and on
    the CPU: the same corners, anchor and block shapes; masks equal on
    >= 99.9% of pixels; pixels where both hold within a mean of 0.05
    levels (CUDA's and the CPU's f32 atan2/cos/sin differ in the last
    ulp)."""
    import cv2
    from simplepanorama_tpu_torch.render import compose, sten_fix
    paths, yaws, f = fkh360_views(12, 300, out_dir=str(tmp_path))
    imgs = [cv2.imread(p) for p in paths]
    Ks = [np.array([[f, 0, 150], [0, f, 150], [0, 0, 1.0]])] * 12
    Rs = [np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]) for a in np.radians(yaws)]
    st = compose.warp_all("stereographic", f, imgs, Rs, Ks, [1.0] * 12)
    lists = [[st.imgs[b, :rh, :rw] for b, (_, _, rw, rh) in
              enumerate(st.rois)],
             [st.masks[b, :rh, :rw] for b, (_, _, rw, rh) in
              enumerate(st.rois)]]
    corners = [(r[0], r[1]) for r in st.rois]
    (cx, cy), r = sten_fix.estimate_circle(lists[1], corners)
    out = {}
    for dev in ("cpu", cuda):
        ims, mks = ([t.to(dev) for t in ts] for ts in lists)
        out[str(dev)] = sten_fix.disk_reproj(ims, mks, corners, (cx, cy), r)
    (ic, mc, cc, ac), (ig, mg, cg, ag) = out["cpu"], out["cuda"]
    assert cc == cg and ac == ag
    flips = total = 0
    diffs = []
    for a, b, ma, mb in zip(ic, ig, mc, mg):
        assert a.shape == b.shape and ma.shape == mb.shape
        mb, b = mb.cpu(), b.cpu()
        flips += int((ma != mb).sum())
        total += ma.numel()
        both = ma & mb
        diffs.append((a[both] - b[both]).abs())
    assert flips / total <= 1e-3
    assert float(torch.cat(diffs).mean()) <= 0.05


def _ba_streams(M, N, seed, dev):
    """Random BA streams (the shapes of ops/ba_kernel.assemble_streams),
    with a tenth of the camera ids outside [0, N) and some mi == mj."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    mi = rng.integers(0, N, M)
    mj = rng.integers(0, N, M)
    mi[::10] = N + 1
    mj[5::10] = -1
    host = [f32(M, 2, 6), f32(M, 2, 6), f32(M, 2, 2), f32(M, 2),
            rng.uniform(0.5, 1, M).astype(np.float32), f32(M),
            rng.uniform(0.5, 1, M).astype(np.float32), f32(M), f32(M),
            mi.astype(np.int64), mj.astype(np.int64)]
    return [torch.from_numpy(a).to(dev) for a in host]


@pytest.mark.parametrize("with_schur", [True, False])
@pytest.mark.parametrize("N,M,seed", [(8, 1024, 0), (16, 384, 1),
                                      (40, 20480, 2)])
def test_ba_kernel_matches_plain_version(cuda, N, M, seed, with_schur):
    """assemble_streams (the CUDA kernel) against assemble_streams_ref on
    the same card: every output within 1e-3 * max|plain| + 1e-4 (the TPU
    kernel's test bound; the sums run in another order); one launch
    counted per call. M = 384 is not a multiple of 512 but is one of
    min(512, M)."""
    args = _ba_streams(M, N, seed, cuda)
    before = ba_kernel.assemble_streams.launches
    got = ba_kernel.assemble_streams(*args, N, with_schur=with_schur)
    assert ba_kernel.assemble_streams.launches == before + 1
    want = ba_kernel.assemble_streams_ref(*args, N, with_schur=with_schur)
    torch.cuda.synchronize()
    for name, g, w in zip(["U", "eA", "YW", "yeb"], got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err = float((g - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()) + 1e-4, (name, err)
    if not with_schur:
        assert not got[2].any() and not got[3].any()
