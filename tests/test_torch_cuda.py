"""Tests that need a CUDA card; they skip without one.

The hand-written kernels (both min-cuts, the BA normal-equation
assembly and the LM trial's kernels 4 and 5) against their plain PyTorch
versions, and the port on the card
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
                                               lm_trial_problem,
                                               max_flow_value, maze_grid)
from simplepanorama_tpu_torch.stitch import StitchResult
from simplepanorama_tpu_torch.ops import ba_kernel, ba_trial, maxflow
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


@pytest.mark.parametrize("kernel", ["grid_mincut", "grid_mincut_tiled"])
def test_solve_adds_its_stats_to_the_counters(cuda, kernel):
    """One card solve adds its outer rounds, push and BFS nanoseconds, BFS
    tile runs, push phases and neighbour checks and waits (its
    ``last_stats``) to the timer's ``mincut.*`` counters. Kernel 1's
    resident BFS, driven by events, counts no rounds and runs every tile
    at least once a BFS, and its resident launches count their push
    phases; the tiled route counts rounds, and no tile runs or resident
    push phases."""
    from simplepanorama_tpu_torch.utils.timing import global_timer
    host = cut_grid(200, 328, 3, (40, 90, 82, 148))
    t = [torch.from_numpy(a).to(cuda) for a in host]
    counters = global_timer().counters
    keys = ("outer", "push_ns", "bfs_ns", "bfs_tile_runs", "push_phases",
            "push_checks", "push_waits")
    before = {k: counters.get("mincut." + k, 0) for k in keys}
    solver = getattr(maxflow, kernel)
    solver(*t)
    stats = solver.last_stats
    assert stats["outer"] > 0 and stats["push_ns"] > 0 and stats["bfs_ns"] > 0
    assert {k: counters["mincut." + k] - before[k] for k in keys} == {
        k: stats[k] for k in keys}
    if kernel == "grid_mincut":
        assert stats["resident"] == 1 and stats["bfs_rounds"] == 0, stats
        assert stats["bfs_tile_runs"] >= stats["outer"] + 1, stats
        assert stats["push_phases"] == 30 * stats["outer"], stats
    else:
        assert stats["bfs_tile_runs"] == 0 and stats["bfs_rounds"] > 0, stats
        assert stats["push_phases"] == stats["push_checks"] == 0, stats


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


@pytest.mark.parametrize("grid", sorted(_SOLVE_GRIDS) + ["seam700"])
def test_resident_bfs_distances_exact(cuda, grid, tmp_path):
    """Kernel 1's resident BFS, its tiles run as their neighbours'
    edges drop with no grid barrier between runs, gives exactly
    _dist_to_sink_scan's distances on every cell, INF included: on the
    ragged shapes and the maze, and on the seam graph of two 700-px
    views at the 640x640 block of a 700-px loop (kernel 1's 50x64
    tiles, what slice 1's and the benchmark's cuts run)."""
    if grid == "seam700":
        from chip_smoke import _seam_graph
        t = _seam_graph(torch, str(tmp_path), 700)
        assert tuple(t[0].shape) == (640, 640)
    else:
        t = [torch.from_numpy(a).to(cuda) for a in _SOLVE_GRIDS[grid]()]
    n = t[0].numel()
    _, got, stats = maxflow._launch("grid_mincut", *t, 0, 0, n + 1,
                                    dist=True)
    caps, e = maxflow._init_state(*t)
    want = maxflow._dist_to_sink_scan(caps, e < 0, t[3], n + 1)
    torch.cuda.synchronize()
    assert stats["resident"] == 1 and stats["bfs_tile_runs"] >= 1, stats
    assert torch.equal(got, want), int((got != want).sum())


_PUSH_GRIDS = {
    "seam700": None,   # the 640x640 block of a 700-px loop: 50x64 tiles
    "grid1232x640": lambda: cut_grid(1232, 640, 3, (308, 616, 160, 320)),
    "maze64x160": lambda: maze_grid(64, 160, 3),
}


@pytest.mark.parametrize("grid", sorted(_PUSH_GRIDS))
def test_resident_push_phases_wait_on_neighbours(cuda, grid, tmp_path):
    """Kernel 1's resident push phases, the tile's cells in registers and
    each tile waiting only on its neighbours' phase words, against
    grid_mincut_ref: cut values within 1e-3 relative (float64 recount),
    sides equal on >= 99.9% of nodes. Its counters: every launch after
    the first ran the 30 phases of inner_iters (push_phases = outer x
    30); a tile checks each neighbour's word twice a phase, once in the
    last (push_checks a multiple of outer x 59), and no more checks
    waited than were made."""
    if grid == "seam700":
        from chip_smoke import _seam_graph
        t = _seam_graph(torch, str(tmp_path), 700)
        assert tuple(t[0].shape) == (640, 640)
    else:
        t = [torch.from_numpy(a).to(cuda) for a in _PUSH_GRIDS[grid]()]
    host = [a.cpu().numpy() for a in t]
    side_k = maxflow.grid_mincut(*t)
    stats = dict(maxflow.grid_mincut.last_stats)
    side_r = maxflow.grid_mincut_ref(*t)
    torch.cuda.synchronize()
    assert stats["resident"] == 1 and 0 < stats["outer"] < 400, stats
    assert stats["push_phases"] == 30 * stats["outer"], stats
    assert stats["push_checks"] > 0, stats
    assert stats["push_checks"] % (59 * stats["outer"]) == 0, stats
    assert 0 <= stats["push_waits"] <= stats["push_checks"], stats
    v_k = maxflow.cut_value(*host, side_k)
    v_r = maxflow.cut_value(*host, side_r)
    assert abs(v_k - v_r) <= 1e-3 * max(1.0, abs(v_r)), (v_k, v_r)
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


def test_kernel1_takes_tiled_route_when_bands_are_too_tall(cuda):
    """A 400x2242 grid fits kernel 1's resident tiles (37x192), but their
    push phase would hold bands of 19 rows a thread, past the tallest
    strip kept in registers (16): it takes kernel 2's tiled route and
    gives kernel 2's cut value, and runs no resident push phase."""
    host = cut_grid(400, 2242, 3, (100, 200, 560, 1121))
    t = [torch.from_numpy(a).to(cuda) for a in host]
    side_1 = maxflow.grid_mincut(*t)
    stats = dict(maxflow.grid_mincut.last_stats)
    side_2 = maxflow.grid_mincut_tiled(*t)
    torch.cuda.synchronize()
    assert stats["resident"] == 0 and stats["outer"] < 400, stats
    assert stats["push_phases"] == 0, stats
    v1 = maxflow.cut_value(*host, side_1)
    v2 = maxflow.cut_value(*host, side_2)
    assert abs(v1 - v2) <= 1e-3 * max(1.0, abs(v2)), (v1, v2)


@pytest.mark.parametrize("lo,hi,box,route", [
    # box 1272x512: kernel 1 with its tiles resident
    ((300, 340), (740, 760), (0, 1272, 256, 768), "kernel1"),
    # box 1272x1024 (1.30M cells, 0.80 of the grid): kernel 2 on the crop
    ((140, 160), (1040, 1060), (0, 1272, 128, 1152), "kernel2"),
    # box the whole grid: kernel 2 on the full grid
    ((10, 20), (1260, 1270), (0, 1272, 0, 1280), "kernel2"),
])
def test_auto_crops_large_seam_grid(cuda, lo, hi, box, route):
    """A 1272x1280 grid (slice 2's block, over WHOLE_GRID_MAX_CELLS) whose
    nodes are a ragged vertical band, t-links of 5000 at each row's ends:
    grid_mincut_auto crops it to its node box (the same box on the card
    as on the CPU) and launches the kernel of the crop rule once, none of
    the other; against kernel 2 on the full grid, cut values within 1e-3
    relative and sides equal on >= 99.9% of nodes."""
    H, W = 1272, 1280
    rng = np.random.default_rng(lo[0])
    wh = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    wv = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    a = rng.integers(*lo, size=H)[:, None]
    b = rng.integers(*hi, size=H)[:, None]
    cols = np.arange(W)[None]
    node = (cols >= a) & (cols < b)
    exc = (5000.0 * (cols == a) - 5000.0 * (cols == b - 1)).astype(
        np.float32)
    host = (wh, wv, exc, node)
    t = [torch.from_numpy(x).to(cuda) for x in host]
    assert maxflow._node_bbox(t[3], H, W) == box
    assert maxflow._node_bbox(torch.from_numpy(node), H, W) == box
    before = (maxflow.grid_mincut.launches,
              maxflow.grid_mincut_tiled.launches)
    side = maxflow.grid_mincut_auto(*t)
    launched = (maxflow.grid_mincut.launches - before[0],
                maxflow.grid_mincut_tiled.launches - before[1])
    assert launched == ((1, 0) if route == "kernel1" else (0, 1))
    if route == "kernel1":
        assert maxflow.grid_mincut.last_stats["resident"] == 1
    full = maxflow.grid_mincut_tiled(*t)
    torch.cuda.synchronize()
    v_c = maxflow.cut_value(*host, side)
    v_f = maxflow.cut_value(*host, full)
    assert abs(v_c - v_f) <= 1e-3 * max(1.0, abs(v_f)), (v_c, v_f)
    assert (side.cpu().numpy() == full.cpu().numpy())[node].mean() >= 0.999
    r0, r1, c0, c1 = box
    outside = torch.ones((H, W), dtype=torch.bool, device=cuda)
    outside[r0:r1, c0:c1] = False
    assert not side[outside].any()


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


def test_prefetched_stack_on_card_renders_as_synchronous(cuda, tmp_path,
                                                          monkeypatch):
    """The full-res prefetch on the card (the two views of
    test_get_panorama_card_matches_cpu): set_config starts it; the
    stack it hands get_panorama lies on the card and was packed in
    pinned host memory; the panorama rendered from it equals, bit for
    bit, the synchronous render (stitcher.render_full_from_imageset, its
    chunks uploaded from pinned memory too)."""
    from simplepanorama_tpu_torch import stitcher
    from simplepanorama_tpu_torch.render import fullres
    paths, yaws, f = fkh360_views(2, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                                  out_dir=str(tmp_path))
    fp = f * 320 / 640
    K = np.array([[fp, 0, 160], [0, fp, 160], [0, 0, 1.0]])
    Rs = [np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
          for a in np.radians(yaws)]
    res = StitchResult(rot=np.stack(Rs), K=np.stack([K, K]),
                       adj=np.array([[0, 0.5], [0, 0]]),
                       connectivity=np.array([1, 1]),
                       order=[(0, -1), (1, 0)], nodes=[0, 1], center=0,
                       sizes=[(320, 320), (320, 320)])
    pinned, stacks = [], []
    host_stack = fullres._host_stack
    prefetch = fullres.prefetch_sources

    def recording_host(*a, **kw):
        out = host_stack(*a, **kw)
        pinned.append(out.is_pinned())
        return out

    def recording_prefetch(*a, **kw):
        stacks.append(prefetch(*a, **kw))
        return stacks[-1]
    monkeypatch.setattr(fullres, "_host_stack", recording_host)
    monkeypatch.setattr(fullres, "prefetch_sources", recording_prefetch)
    p = Panorama(paths, device=cuda)
    p.result = res
    p.set_config(Config(cut=True, init_size=320, gain_compensation=True))
    p.get_preview()
    full = p.get_panorama()
    assert len(stacks) == 1 and stacks[0].device.type == "cuda"
    assert tuple(stacks[0].shape) == (2, 640, 640, 3)
    assert p.prefetch_stats["decode_s"] > 0 and pinned == [True]
    want = stitcher.render_full_from_imageset(p.stitch_params, p.config,
                                              p.images)
    assert pinned == [True, True]
    assert np.array_equal(full, want)


def test_prefetch_out_of_memory_renders_chunked_on_card(cuda, tmp_path,
                                                       monkeypatch):
    """The prefetch of test_prefetched_stack_on_card_renders_as_synchronous
    with its upload out of device memory (fullres.prefetch_sources
    raising torch.OutOfMemoryError): get_panorama renders the decoded
    images through the chunked route on the card, equal bit for bit to
    the synchronous render, and prefetch_stats says so."""
    from simplepanorama_tpu_torch import stitcher
    from simplepanorama_tpu_torch.render import fullres
    paths, yaws, f = fkh360_views(2, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                                  out_dir=str(tmp_path))
    fp = f * 320 / 640
    K = np.array([[fp, 0, 160], [0, fp, 160], [0, 0, 1.0]])
    Rs = [np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
          for a in np.radians(yaws)]
    res = StitchResult(rot=np.stack(Rs), K=np.stack([K, K]),
                       adj=np.array([[0, 0.5], [0, 0]]),
                       connectivity=np.array([1, 1]),
                       order=[(0, -1), (1, 0)], nodes=[0, 1], center=0,
                       sizes=[(320, 320), (320, 320)])

    def out_of_memory(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (test)")
    monkeypatch.setattr(fullres, "prefetch_sources", out_of_memory)
    p = Panorama(paths, device=cuda)
    p.result = res
    p.set_config(Config(cut=True, init_size=320, gain_compensation=True))
    p.get_preview()
    full = p.get_panorama()
    assert p.prefetch_stats["upload_oom"] is True
    assert p.stitch_params.state.imgs.device.type == "cuda"
    want = stitcher.render_full_from_imageset(p.stitch_params, p.config,
                                              p.images)
    assert np.array_equal(full, want)


def test_fresh_process_first_and_second_stitch_equal(cuda, tmp_path):
    """fresh_trace.py in a process of its own: two cut=True stitches of a
    12-view 400-px loop in turn give equal cameras and preview bytes,
    the second captures no CUDA graph, and kernel 3 launches once per
    trial executed in each."""
    import json
    import pathlib
    import subprocess
    import sys
    fkh360_views(12, 400, out_dir=str(tmp_path))
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, str(root / "fresh_trace.py"),
                           str(tmp_path)], cwd=root, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    first, second = [json.loads(x) for x in proc.stdout.splitlines()
                     if x.startswith('{"stitch"')]
    assert first["connected"] == second["connected"] == [12, 12]
    assert first["cameras"] == second["cameras"]
    assert first["preview"] == second["preview"]
    assert first["lm"]["graphs"] >= 1 and second["lm"]["graphs"] == 0
    for row in (first, second):
        assert row["launches"]["assemble_streams"] == row["lm"]["executed"]


@pytest.mark.parametrize("small", [False, True])
def test_pair_jacobian_card_matches_cpu(cuda, small):
    """ba._pair_H_jac_batch (the pair Jacobian written out by hand) on
    4,096 pairs on the card against the CPU's, 2e-5 of each (3, 3, 6)
    block's largest entry (tests/test_torch_pair_jac.py holds the CPU's
    against jacfwd and the JAX package); rotations up to pi - 0.1, or
    inside rodrigues' small-angle branch. Captured in a CUDA graph, as
    every graphed LM trial runs it, its replay equals the eager call bit
    for bit."""
    from simplepanorama_tpu_torch import ba
    rng = np.random.default_rng(31 + small)
    c = np.empty((2, 4096, 6), np.float32)
    c[..., 0] = rng.uniform(300.0, 1800.0, (2, 4096))
    c[..., 1:3] = rng.uniform(0.0, 400.0, (2, 4096, 2))
    d = rng.normal(size=(2, 4096, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mag = (rng.uniform(0.0, 0.99e-4, (2, 4096, 1)) if small
           else rng.uniform(0.0, np.pi - 0.1, (2, 4096, 1)))
    c[..., 3:6] = d * mag
    want = ba._pair_H_jac_batch(*torch.from_numpy(c))
    ci, cj = torch.from_numpy(c).to(cuda)
    got = ba._pair_H_jac_batch(ci, cj)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.shape == (4096, 3, 3, 6)
        w = w.double()
        err = (g.cpu().double() - w).abs().amax((1, 2, 3)) \
            / w.abs().amax((1, 2, 3))
        assert float(err.max()) <= 2e-5
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ba._pair_H_jac_batch(ci, cj)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ba._pair_H_jac_batch(ci, cj)
    graph.replay()
    torch.cuda.synchronize()
    for o, g in zip(out, got):
        assert torch.equal(o, g)


def test_render_flat_runs_on_card_by_default(cuda):
    """render/flat.render_flat and pairwise_stitch with no device warp on
    the card; their panoramas equal the CPU's within 1 level (a float32
    sample may round to the other side of .5)."""
    from simplepanorama_tpu_torch.geometry.canvas import \
        calc_stitch_from_adj
    from simplepanorama_tpu_torch.render import flat
    devices = []
    warp = flat.warp_perspective

    def recording(img, *a, **kw):
        devices.append(img.device.type)
        return warp(img, *a, **kw)
    rng = np.random.default_rng(3)
    imgs = [rng.integers(40, 255, (40, 50, 3)).astype(np.uint8)
            for _ in range(2)]
    hom = np.zeros((2, 2, 3, 3))
    hom[:] = np.eye(3)
    hom[0, 1, 0, 2] = 30.0
    hom[1, 0, 0, 2] = -30.0
    tr = calc_stitch_from_adj(np.array([[0, 1.0], [0, 0]]),
                              np.array([1.0, 0.5]), [(40, 50), (40, 50)],
                              hom, focal=700.0, fast=False)
    H = np.eye(3)
    H[0, 2] = 40.0
    flat.warp_perspective = recording
    try:
        card = (flat.render_flat(tr, imgs),
                flat.pairwise_stitch(imgs[0], imgs[1], H))
    finally:
        flat.warp_perspective = warp
    assert devices == ["cuda"] * 3
    cpu = (flat.render_flat(tr, imgs, device="cpu"),
           flat.pairwise_stitch(imgs[0], imgs[1], H, device="cpu"))
    for a, b in zip(card, cpu):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


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
    st = compose.warp_all("stereographic", f, imgs, Rs, Ks, [1.0] * 12,
                          device="cpu")
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
@pytest.mark.parametrize("N,M,seed", [
    (8, 1024, 0), (16, 384, 1), (40, 20480, 2),
    *[(N, M, 3 + i) for i, (N, M) in enumerate(
        (N, M) for N in (8, 16, 40) for M in (2048, 6144, 20480))]])
def test_ba_kernel_matches_plain_version(cuda, N, M, seed, with_schur):
    """assemble_streams (the CUDA kernel) against assemble_streams_ref on
    the same card: every output within 1e-3 * max|plain| + 1e-4 (the TPU
    kernel's test bound; the sums run in another order); one launch
    counted per call; a second call with a reused workspace gives the
    same bits (fixed-order sums, no float atomics). N = 8 and 16 camera
    slots and M = 2,048-20,480 are the LM trial's buckets; N = 40 takes
    the pair blocks through device memory. M = 384 is not a multiple of
    512 but is one of min(512, M)."""
    args = _ba_streams(M, N, seed, cuda)
    before = ba_kernel.assemble_streams.launches
    got = ba_kernel.assemble_streams(*args, N, with_schur=with_schur)
    assert ba_kernel.assemble_streams.launches == before + 1
    want = ba_kernel.assemble_streams_ref(*args, N, with_schur=with_schur)
    ws = ba_kernel.workspace(M, N, cuda)
    again = ba_kernel.assemble_streams(*args, N, with_schur=with_schur,
                                       ws=ws)
    torch.cuda.synchronize()
    for name, g, w, g2 in zip(["U", "eA", "YW", "yeb"], got, want, again):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        err = float((g - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()) + 1e-4, (name, err)
        assert torch.equal(g, g2), name
    if not with_schur:
        assert not got[2].any() and not got[3].any()


def _trial_problem(N, M, fast, seed=5, reach=2):
    """lm_trial_problem on the card with an inactive camera (from N = 16)
    and camera ids outside the table: (ba.LMState at the start, its
    ba.LMProblem with kernel 3's workspace, kernels 4 and 5's)."""
    from simplepanorama_tpu_torch import ba
    cams, data, active = lm_trial_problem(N, M, seed=seed, device="cuda",
                                           inactive=N // 16, outside=True,
                                           reach=reach)
    pb = ba.lm_problem(data, active, max_iter=50,
                       ws=ba_kernel.workspace(M, N, "cuda"))
    return (ba.lm_init(cams, pb, 0.05, fast), pb,
            ba_trial.workspace(M, N, data.pi.shape[0], "cuda"))


def _copy_state(st):
    from simplepanorama_tpu_torch import ba
    return ba.LMState(ba.CamState(*(t.clone() for t in st.cams)),
                      *(t.clone() for t in st[1:]))


def _close(got, want, rel, what):
    """max |got - want| within ``rel`` of max(max |want|, 1)."""
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= rel * scale, (what, err, scale)


def _step_close(got, want, start, rel, what):
    """max |got - want| within ``rel`` of the trial's step max |want -
    start|, plus 4 float32 roundings of max |want| (the trial value is
    start + step, rounded)."""
    step = float((want - start).abs().max())
    err = float((got - want).abs().max())
    bound = rel * step + 4 * 2.0 ** -24 * float(want.abs().max())
    assert err <= bound, (what, err, step, bound)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("N,M,reach,route", [
    (8, 2048, 2, "shared"), (16, 6144, 2, "shared"),
    (40, 20480, 2, "shared"), (48, 4096, 2, "global system"),
    (40, 20480, 8, "global tables")])
def test_trial_kernels_match_plain_versions(cuda, N, M, reach, route, fast):
    """Kernel 4 (ops/ba_trial.trial_streams) against
    ba.trial_streams_ref from the start of a problem with an inactive
    camera and ids outside the camera table: every stream within 1e-4
    of its largest entry (the chain rule's products in float32, sin and
    cos of the card's libm; the residual rows, a difference of ~200 px
    terms, read 8e-6 in a CPU run of the kernel's arithmetic). Kernel 5
    (ops/ba_trial.solve_accept) against ba.solve_accept_ref on kernel 4's
    streams and kernel 3's sums: the same accept decision, counters,
    lambda and termination flag, the error within 1e-4 relative (the
    kernel sums in float64, the plain version in float32 over up to
    20,480 matches: 1.5e-5 apart on the card) and every camera tensor
    within 1e-4 of the trial's step (_step_close: an LU against
    cuSOLVER's, on a system of condition ~1e3). One launch of
    each counted; the two kernels again from the same state give the
    same bits. N = 8, 16 and 40 camera slots are the LM's buckets, 40
    the one whose system fills a CTA's shared memory; at 48 the system
    takes kernel 5's global route, and 40 cameras each matched with
    their next 8 (~570 pair rows) take kernel 4's."""
    from simplepanorama_tpu_torch import ba
    st, pb, tw = _trial_problem(N, M, fast, reach=reach)
    assert (tw.tables is not None, tw.system is not None) == (
        route == "global tables", route == "global system")
    outs = []
    for _ in range(2):
        got = _copy_state(st)
        live = torch.zeros((), dtype=torch.bool, device="cuda")
        before = (ba_trial.trial_streams.launches,
                  ba_trial.solve_accept.launches)
        ts = ba_trial.trial_streams(got, pb, fast, tw)
        streams = [t.clone() for t in ts]
        sums = ba_kernel.assemble_streams(*ts[:9], pb.mi, pb.mj, N,
                                          with_schur=not fast, ws=pb.ws)
        ba_trial.solve_accept(got, pb, fast, ts, sums, live, tw)
        torch.cuda.synchronize()
        assert (ba_trial.trial_streams.launches,
                ba_trial.solve_accept.launches) == (before[0] + 1,
                                                    before[1] + 1)
        outs.append((got, live, streams, sums))
    got, live, streams, sums = outs[0]
    for a, b in zip((*outs[1][0].cams, *outs[1][0][1:], outs[1][1]),
                    (*got.cams, *got[1:], live)):
        assert torch.equal(a, b)
    want_ts = ba.trial_streams_ref(st, pb, fast)
    for name, g, w in zip(ba_trial.TrialStreams._fields, streams, want_ts):
        if w is not None:
            _close(g, w, 1e-4, name)
    ts = ba_trial.TrialStreams(*streams)
    if fast:
        ts = ts._replace(eB=None, vinv=None)
    want, err_new = ba.solve_accept_ref(st, pb, fast, ts, sums)
    for k in ("it", "strikes", "n_acc", "lam"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert bool(live) == bool(ba._live(want, pb.max_iter))
    assert abs(float(got.err) - float(want.err)) <= 1e-4 * float(want.err)
    for name, g, w, s0 in zip(ba.CamState._fields, got.cams, want.cams,
                              st.cams):
        _step_close(g, w, s0, 1e-4, name)


def _scaled_cond(st, pb, fast, sums):
    """Condition number (float64) of the trial's camera system in the
    Jacobi scaling of ba._solve_preconditioned."""
    from simplepanorama_tpu_torch import ba
    S, _ = ba._system(sums, ba._aug_scales(st.cams.focal), st.lam,
                      pb.cam_active, fast)
    S = S.double()
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(S).abs(), min=1e-12))
    return float(torch.linalg.cond(S * d[:, None] * d[None, :]))


def _lm_run_f64(cams, data, active, fast, max_iter, monkeypatch):
    """The LM run in float64 on the CPU (ba.lm_trial until the run ends,
    kernel 3's plain version summing float64 streams): the reference a
    float32 LM run is held to."""
    from simplepanorama_tpu_torch import ba
    d = lambda t: t.cpu().double() if t.is_floating_point() else t.cpu()
    with monkeypatch.context() as m:
        m.setattr(ba_kernel, "assemble_streams",
                  lambda *a, ws=None, **kw:
                  ba_kernel.assemble_streams_ref(*a, **kw))
        pb = ba.lm_problem(ba.BAData(*map(d, data)), active.cpu(),
                           max_iter=max_iter)
        st = ba.lm_init(ba.CamState(*map(d, cams)), pb, 0.05, fast)
        while bool(ba._live(st, pb.max_iter)):
            st = ba.lm_trial(st, pb, fast)
        return ba._result(st)


@pytest.mark.parametrize("fast", [False, True])
def test_fused_program_follows_the_eager_lm(cuda, fast, monkeypatch):
    """On a 16-camera, 6,144-match problem (the cell's largest bucket):
    30 trials along ba.lm_trial's path, each also run from the same state
    by ba.fused_trial (kernels 4, 3 and 5). Wherever the trial's
    Jacobi-scaled system has a condition number c below 1e4 (float64),
    the two make the same accept decision and their trial errors agree
    within 1e-4 relative; an accepted trial's cameras and b differ by at
    most 100 c 2^-24 of the step, the forward error of a float32 LU
    solve. Above it, as lambda falls and the BA's gauge is held by the
    augment alone (c reaches 1e7-1e9 below lambda ~ 1e-6), any two
    float32 LU solves, kernel 5's and cuSOLVER's, give steps that differ
    in their leading digits, as each does from a float64 solve (PERF.md
    section 6), and the runs part: those decisions are not compared.
    At every trial, conditioned or not, kernel 5's camera step (the trial
    accepted whatever its error) is held to the float64 solve of the
    system kernels 4 and 3 built: its largest difference, beyond four
    float32 roundings of the state, at most ten times cuSOLVER's on the
    same float32 system plus 1e-5 of the step. Then whole runs to the
    LM's end, up to 300 trials, against the same run in float64
    (_lm_run_f64): the program's captured run and ba.lm_run (a program
    of its own, made, run and closed) each end within 2% of its error
    (on the card over six problems: the program within 2.3e-5 but one
    run that stopped on six rejections in a row at 80 trials, 1.15e-2),
    rotations within 2e-3 rad and focal, principal point and b within
    1e-2 px (4.5e-4 rad and 1e-4 px). A run of wrong steps stops far
    short of that optimum."""
    from simplepanorama_tpu_torch import ba
    cams, data, active = lm_trial_problem(16, 6144, seed=5, device="cuda",
                                           inactive=1, outside=True)
    prog = ba.LMProgram(data, 16, fast, max_iter=300)
    try:
        pb = ba.lm_problem(data, active, ws=prog.pb.ws)
        st = ba.lm_init(cams, pb, 0.05, fast)
        compared, steps = 0, []
        for k in range(30):
            new, e_eager = ba.lm_step(st, pb, fast)
            ts = ba.trial_streams_ref(st, pb, fast)
            cond = _scaled_cond(st, pb, fast, ba._camera_sums(
                ts[:9], pb, 16, fast))
            # the system kernels 4 and 3 build, solved by cuSOLVER
            # and in float64
            kts = ba_trial.trial_streams(_copy_state(st), pb, fast,
                                         prog.tw)
            S, rhs = ba._system(ba_kernel.assemble_streams(
                *kts[:9], pb.mi, pb.mj, 16, with_schur=not fast,
                ws=pb.ws), ba._aug_scales(st.cams.focal), st.lam,
                pb.cam_active, fast)
            da_c = ba._solve_preconditioned(S, rhs).double()
            da_64 = ba._solve_preconditioned(S.double(), rhs.double())
            got = _copy_state(st)._replace(
                err=torch.full_like(st.err, float("inf")))
            live = torch.zeros((), dtype=torch.bool, device="cuda")
            ba.fused_trial(got, pb, fast, live, prog.tw)
            six = lambda c: torch.cat([c.focal[:, None], c.ppal,
                                       c.rotvec], 1).double()
            keep = pb.cam_active[:, None].expand(16, 6).clone()
            keep[:, 3:] &= (st.cams.rotvec.norm(dim=1) >= 1e-6)[:, None]
            on = lambda x: torch.where(keep, x.reshape(16, 6), 0.0)
            e_c = float((on(da_c) - on(da_64)).abs().max())
            e_k = float(((on(six(got.cams) - six(st.cams))
                          - on(da_64)).abs() - 4 * 2.0 ** -24
                         * six(st.cams).abs()).clamp(min=0).max())
            steps.append((k, cond, e_k, e_c,
                          float(on(da_64).abs().max())))
            ok_f = bool(torch.isfinite(got.err) & (got.err < st.err))
            ok_e = bool(new.n_acc > st.n_acc)
            if cond < 1e4:
                compared += 1
                assert ok_f == ok_e, (k, cond)
                assert abs(float(got.err) - float(e_eager)) <= \
                    1e-4 * float(e_eager), (k, cond)
                if ok_e:
                    for g, w, s0 in zip(got.cams, new.cams, st.cams):
                        step = float((w - s0).norm())
                        diff = float((g - w).norm())
                        assert diff <= 100 * cond * 2 ** -24 * step \
                            + 1e-6 * float(w.norm()), (k, cond)
            st = new
        assert compared >= 2
        assert all(e_k <= 10 * e_c + 1e-5 * step
                   for _, _, e_k, e_c, step in steps), steps
        res_f = prog.run(cams, active, 0.05)[0]
    finally:
        prog.close()
    res_l = ba.lm_run(cams, data, active, 0.05, fast=fast, max_iter=300)
    ref = _lm_run_f64(cams, data, active, fast, 300, monkeypatch)
    assert int(ref.n_iter) < 300
    for name, res in (("program", res_f), ("lm_run", res_l)):
        assert abs(float(res.error) - float(ref.error)) <= \
            2e-2 * float(ref.error), (name, float(res.error),
                                      float(ref.error))
        for k, g, w in zip(ba.CamState._fields, res.cams, ref.cams):
            diff = float((g.cpu().double() - w).abs().max())
            assert diff <= (2e-3 if k == "rotvec" else 1e-2), (name, k,
                                                                diff)


def _replay_ops(graph):
    """The operations one replay of ``graph`` runs on the card, by name,
    from torch.profiler (the ranges the host marks left out)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    cuda_t = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() != cuda_t}
    return [e.name() for e in events
            if e.device_type() == cuda_t and e.name() not in host]


def test_fused_trial_graph_holds_three_kernels(cuda, slice1_ba):
    """The single-card trial captured on slice 1's last bucket records
    one launch each of kernels 4, 3 and 5 and nothing else of the
    wrappers; one replay runs three operations on the card by the
    profiler (at most 6 allowed, memsets included), against ~585 before
    the trial had kernels of its own."""
    prog, _, _ = _program(slice1_ba)
    try:
        prog._capture()
        assert prog.per_trial == {ba_kernel.assemble_streams: 1,
                                  ba_trial.trial_streams: 1,
                                  ba_trial.solve_accept: 1}
        ops = _replay_ops(prog.graph)
        assert 3 <= len(ops) <= 6, ops
        for k in ("trial_streams_kernel", "assemble_kernel",
                  "solve_accept_kernel"):
            assert sum(k + "(" in o for o in ops) == 1, (k, ops)
    finally:
        prog.close()


@pytest.mark.parametrize("N,reach,nodes", [(40, 2, 3), (48, 2, 3),
                                             (40, 8, 4)])
def test_program_takes_kernels_4_5_in_every_bucket(cuda, N, reach, nodes):
    """A single-card LMProgram replays kernels 4, 3 and 5 in every
    bucket: 40 camera slots (the system in a CTA's shared memory), 48
    (288 x 289 floats, no CTA's shared memory holds it: kernel 5's
    global route) and 40 cameras each matched with their next 8 (~570
    pair rows: kernel 4's global route, pair_tables_kernel first, a
    fourth graph node). The captured trial records one launch of each
    wrapper and runs ``nodes`` operations on the card by the profiler;
    the run ends below its start's error, kernel 3 launched once per
    trial executed."""
    from simplepanorama_tpu_torch import ba
    cams, data, active = lm_trial_problem(N, 2048, seed=6, device="cuda",
                                           reach=reach)
    prog = ba.LMProgram(data, N, False, max_iter=12)
    try:
        assert prog.trial_kernels and prog.tw is not None
        start = float(ba.lm_init(cams, ba.lm_problem(data, active), 0.05,
                                 False).err)
        before = ba_kernel.assemble_streams.launches
        res, executed, _ = prog.run(cams, active, 0.05)
        torch.cuda.synchronize()
        assert ba_kernel.assemble_streams.launches - before == executed
        assert prog.per_trial == {ba_kernel.assemble_streams: 1,
                                  ba_trial.trial_streams: 1,
                                  ba_trial.solve_accept: 1}
        assert float(res.error) < start
        ops = _replay_ops(prog.graph)
        assert len(ops) == nodes, ops
    finally:
        prog.close()


def _recorded_ba(out_dir, size, cfg):
    """The BA problem of a 12-view loop of ``size``-px views, recorded
    from a stitch under ``cfg`` on the card: (comp, adjres, sizes,
    focal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from simplepanorama_tpu_torch import stitch
    paths, _, _ = fkh360_views(12, size, out_dir=out_dir)
    seen = {}
    ba_stitching = stitch.bundle_adjust_stitching

    def recording(comp, adjres, sizes, focal, *a, **kw):
        seen["args"] = (comp, adjres, sizes, focal)
        return ba_stitching(comp, adjres, sizes, focal, *a, **kw)
    stitch.bundle_adjust_stitching = recording
    try:
        Panorama(paths, device="cuda").stitch(cfg)
    finally:
        stitch.bundle_adjust_stitching = ba_stitching
    return seen["args"]


@pytest.fixture(scope="module")
def slice1_ba(tmp_path_factory):
    """The BA problem of slice 1 (12 views of 700 px, a 360-degree loop,
    relaxed objective)."""
    return _recorded_ba(str(tmp_path_factory.mktemp("s1")), 700, Config())


@pytest.fixture(scope="module")
def slice3_ba(tmp_path_factory):
    """The BA problem of slice 3 (12 views of 1400 px at init_size 700,
    Lowe objective)."""
    return _recorded_ba(str(tmp_path_factory.mktemp("s3")), 1400,
                        Config(fast=True))


def _run_ba(args, fast=False, device="cuda"):
    """bundle_adjust_stitching on ``device`` with the chunk driver's
    counts summed: (result, {runs, trials, accepted, executed, fused,
    reads, graphs})."""
    from simplepanorama_tpu_torch import stitch
    counts = dict(runs=0, trials=0, accepted=0, executed=0, fused=0,
                  reads=0, graphs=0)
    chunk = stitch._lm_chunk

    def counted(*a, **kw):
        cams, c = chunk(*a, **kw)
        for k in counts:
            counts[k] += int(getattr(c, k))
        return cams, c
    stitch._lm_chunk = counted
    try:
        res = stitch.bundle_adjust_stitching(*args, Config(fast=fast),
                                             device=device)
    finally:
        stitch._lm_chunk = chunk
    return res, counts


class _Uncaptured:
    """A stand-in for a program's CUDA graph: each replay runs the
    program's trial eagerly, its kernels (and collectives) launched one
    by one."""

    def __init__(self, prog):
        self.prog = prog

    def replay(self):
        self.prog.trial()

    def reset(self):
        pass


def _capture_uncaptured(self):
    """A stand-in for LMProgram._capture: the warm-up trial, then an
    _Uncaptured graph, so that the program's runs take its trial
    uncaptured between the reads."""
    self.trial()
    self.graph = _Uncaptured(self)
    self.capture_s = 0.0


@pytest.mark.parametrize("fast", [False, True])
def test_ba_graphs_capture_every_bucket_and_match_eager(cuda, slice1_ba,
                                                        fast, monkeypatch):
    """Slice 1's BA on the card captures one CUDA graph per capacity
    bucket of its schedule (a host sync inside the trial would have
    failed the capture: the capturing thread may make none), and
    launches kernel 3 once per trial executed, every one of them through
    kernels 4 and 5; against the same programs with the trial uncaptured
    (_capture_uncaptured: kernels 4, 3 and 5 launched one by one) the
    same trials and accepted steps, kernel 3 again once per trial
    executed, and cameras within 1e-5 relative. On the CPU (ba.lm_step,
    no graph) the same BA captures nothing and runs the same LM runs
    with no trial through kernels 4 and 5. The process's kept programs
    are released first (the recording stitch left its own), so every
    bucket is captured in this call, and after the uncaptured run, whose
    programs hold stand-in graphs."""
    from simplepanorama_tpu_torch import ba, stitch
    comp, adjres, sizes, focal = slice1_ba
    ba.release_programs()
    before = ba_kernel.assemble_streams.launches
    res_f, c_f = _run_ba(slice1_ba, fast)
    launches = ba_kernel.assemble_streams.launches - before
    ba.release_programs()
    try:
        with monkeypatch.context() as m:
            m.setattr(ba.LMProgram, "_capture", _capture_uncaptured)
            before = ba_kernel.assemble_streams.launches
            res_e, c_e = _run_ba(slice1_ba, fast)
            launches_e = ba_kernel.assemble_streams.launches - before
    finally:
        ba.release_programs()
    _, c_s = _run_ba(slice1_ba, fast, device="cpu")
    n = len(comp.nodes)
    data, prefix = stitch.build_ba_data(
        comp, adjres, order=stitch.order_nodes_by_connection(
            comp.adj + comp.adj.T))
    buckets = {(nc, mc) for _, _, nc, mc in stitch._chunk_plan(
        prefix, n, stitch._round_up(n, 8), data.mi.shape[0])}
    assert c_f["graphs"] == c_e["graphs"] == len(buckets)
    assert launches == c_f["executed"] == c_f["fused"]
    assert launches_e == c_e["executed"] == c_e["fused"]
    assert (c_f["runs"], c_f["trials"], c_f["accepted"]) == \
        (c_e["runs"], c_e["trials"], c_e["accepted"])
    np.testing.assert_allclose(res_f.K, res_e.K, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res_f.rot, res_e.rot, atol=1e-5)
    assert c_s["graphs"] == c_s["fused"] == 0 and c_s["runs"] == c_f["runs"]


def _last_bucket(args):
    """The last bucket of the schedule of ``args`` and the start of its
    last LM run (cameras at the focal estimate, rotations spread over the
    loop): (data cropped to the bucket, n_cap, cams, active, n)."""
    from simplepanorama_tpu_torch import ba, stitch
    comp, adjres, sizes, focal = args
    n = len(comp.nodes)
    order = stitch.order_nodes_by_connection(comp.adj + comp.adj.T)
    data, prefix = stitch.build_ba_data(comp, adjres, device="cuda",
                                        order=order)
    lo, hi, n_cap, m_cap = stitch._chunk_plan(
        prefix, n, stitch._round_up(n, 8), data.mi.shape[0])[-1]
    data_c = ba.BAData(*(t if k in ("pi", "pj") else t[:m_cap]
                         for k, t in data._asdict().items()))
    cams = ba.CamState(
        focal=torch.full((n_cap,), focal, device="cuda"),
        ppal=torch.zeros((n_cap, 2), device="cuda"),
        rotvec=torch.zeros((n_cap, 3), device="cuda"), b=data_c.t.clone())
    cams.rotvec[1:n, 1] = torch.linspace(0.5, 5.8, n - 1)
    active = torch.arange(n_cap, device="cuda") < n
    return data_c, n_cap, cams, active, n


def _program(args, fast=False):
    """An LMProgram of the last bucket of the schedule of ``args``, loaded
    with the start of that bucket's last LM run: (program, cams,
    active)."""
    from simplepanorama_tpu_torch import ba
    data_c, n_cap, cams, active, n = _last_bucket(args)
    prog = ba.LMProgram(data_c, n_cap, fast)
    prog._load(cams, active, 0.05, n - 1)
    return prog, cams, active


@pytest.mark.parametrize("fast", [False, True])
def test_replayed_trial_equals_eager_trial(cuda, slice1_ba, fast):
    """One replay of the captured trial against the same trial run
    eagerly from the same state on the card (ba.fused_trial: the same
    kernels 4, 3 and 5 in the same order, on a copy of the state): every
    state tensor and the termination flag equal, bit for bit. The eager
    trial runs with host syncs raising (torch.cuda.set_sync_debug_mode)."""
    from simplepanorama_tpu_torch import ba
    prog, cams, active = _program(slice1_ba, fast)
    mode = torch.cuda.get_sync_debug_mode()
    try:
        prog._capture()   # runs the state's first trial, then captures
        want = ba.LMState(ba.CamState(*(t.clone() for t in prog.st.cams)),
                          *(t.clone() for t in prog.st[1:]))
        live = prog.live.clone()
        torch.cuda.set_sync_debug_mode("error")
        ba.fused_trial(want, prog.pb, fast, live, prog.tw)
        torch.cuda.set_sync_debug_mode(mode)
        prog.graph.replay()
        torch.cuda.synchronize()
        for w, g in zip(prog._tensors(want), prog._tensors(prog.st)):
            assert torch.equal(w, g)
        assert torch.equal(live, prog.live)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        prog.close()


def test_replays_do_not_grow_memory(cuda, slice1_ba):
    """Peak device memory after 1 replay and after 100 more: equal (the
    graph's allocations live in its private pool, made at capture)."""
    prog, _, _ = _program(slice1_ba)
    try:
        prog._capture()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prog.graph.replay()
        torch.cuda.synchronize()
        peak1 = torch.cuda.max_memory_allocated()
        for _ in range(100):
            prog.graph.replay()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() == peak1
        assert torch.isfinite(prog.st.err)
    finally:
        prog.close()


@pytest.mark.parametrize("fast", [False, True])
def test_kept_program_replays_another_problem_of_its_bucket(cuda, fast):
    """ba.program on two BA problems of one bucket (the same shapes, other
    matches and cameras), A then B then A: one capture, and each run
    equal bit for bit to a fresh LMProgram's run of that problem
    (trials, accepted steps, error, lambda, cameras); kernel 3 launched
    once per trial executed on the kept program."""
    from simplepanorama_tpu_torch import ba
    ba.release_programs()
    problems = {seed: _ba_problem_card(seed=seed) for seed in (2, 3)}
    (ca, da), (cb, db) = problems[2], problems[3]
    assert ba._program_key(da, 4, fast, 50) == \
        ba._program_key(db, 4, fast, 50)
    assert not torch.equal(da.q, db.q)
    active = torch.ones(4, dtype=torch.bool, device="cuda")
    kept, graph = {}, None
    try:
        for seed in (2, 3, 2):
            cams, data = problems[seed]
            with ba.program(data, 4, fast) as prog:
                assert graph is None or prog.graph is graph
                before = ba_kernel.assemble_streams.launches
                got, executed, _ = prog.run(cams, active, 0.05)
                torch.cuda.synchronize()
            assert ba_kernel.assemble_streams.launches - before == executed
            graph = prog.graph
            fresh = ba.LMProgram(data, 4, fast)
            try:
                want = fresh.run(cams, active, 0.05)[0]
            finally:
                fresh.close()
            assert _same_run(got, want), seed
            if seed in kept:
                assert _same_run(got, kept[seed])
            kept[seed] = got
        assert not _same_run(kept[2], kept[3])
        assert len(ba._PROGRAMS) == 1
    finally:
        ba.release_programs()


@pytest.mark.parametrize("fast", [False, True])
def test_threads_share_a_kept_program(cuda, fast):
    """Two threads, each with its own problem of one bucket (one kept
    program), take the program through ba.program and run it, at
    once, four times over (the first after ba.release_programs(), so one
    of them captures while the other waits or works): every run equals
    a fresh LMProgram's run of its problem bit for bit, and kernel 3
    launched once per trial executed in the two threads together."""
    import concurrent.futures
    import threading
    from simplepanorama_tpu_torch import ba
    problems = [_ba_problem_card(seed=seed) for seed in (2, 3)]
    active = torch.ones(4, dtype=torch.bool, device="cuda")
    want = []
    for cams, data in problems:
        fresh = ba.LMProgram(data, 4, fast)
        try:
            want.append(fresh.run(cams, active, 0.05)[0])
        finally:
            fresh.close()
    assert not _same_run(*want)

    def run(k, meet):
        cams, data = problems[k]
        meet.wait()
        with ba.program(data, 4, fast) as prog:
            got, executed, _ = prog.run(cams, active, 0.05)
        torch.cuda.synchronize()
        return got, executed
    ba.release_programs()
    try:
        for _ in range(4):
            meet = threading.Barrier(2, timeout=60)
            before = ba_kernel.assemble_streams.launches
            with concurrent.futures.ThreadPoolExecutor(2) as ex:
                futs = [ex.submit(run, k, meet) for k in (0, 1)]
                out = [f.result(timeout=300) for f in futs]
            assert ba_kernel.assemble_streams.launches - before == \
                sum(n for _, n in out)
            for (got, _), w in zip(out, want):
                assert _same_run(got, w)
        assert len(ba._PROGRAMS) == 1
    finally:
        ba.release_programs()


def test_card_linalg_stays_on_cusolver_beside_a_ba_thread(cuda):
    """checked_device("cuda") puts the card's linear algebra on cuSOLVER
    for the process, and LM runs in another thread (ba.lm_run: a program
    of its own, captured and closed; then a kept program's capture and
    replays) leave it so: while they run and after, this thread's
    batched 3x3 inverses (adjacency's shape) give the bits they gave
    before the runs."""
    import threading
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.utils.device import checked_device
    cusolver = torch._C._LinalgBackend.Cusolver
    checked_device("cuda")
    assert torch.backends.cuda.preferred_linalg_library() == cusolver
    rng = np.random.default_rng(7)
    H = torch.as_tensor(rng.normal(size=(64, 3, 3)) + 3.0 * np.eye(3),
                        dtype=torch.float32, device="cuda")
    want = torch.linalg.inv(H)
    cams, data = _ba_problem_card(seed=2)
    active = torch.ones(4, dtype=torch.bool, device="cuda")
    done, errors = threading.Event(), []

    def run():
        try:
            ba.lm_run(cams, data, active, 0.05)
            with ba.program(data, 4, False) as prog:
                prog.run(cams, active, 0.05)
            torch.cuda.synchronize()
        except BaseException as e:      # raised in the test's thread
            errors.append(e)
        finally:
            done.set()
    ba.release_programs()
    worker = threading.Thread(target=run)
    worker.start()
    try:
        seen = 0
        while not done.is_set():
            assert torch.backends.cuda.preferred_linalg_library() == \
                cusolver
            assert torch.equal(torch.linalg.inv(H), want)
            seen += 1
        worker.join()
        assert not errors, errors
        assert seen > 0
        assert torch.backends.cuda.preferred_linalg_library() == cusolver
        assert torch.equal(torch.linalg.inv(H), want)
    finally:
        worker.join()
        ba.release_programs()


def test_release_programs_frees_the_pools(cuda, slice1_ba):
    """A stitch's BA leaves its buckets' programs kept, their graphs'
    private memory pools held; ba.release_programs() closes them, and
    after torch.cuda.empty_cache() the private pools hold what they held
    before the stitch, and the memory reserved drops by what the stitch
    added to them. (After a process's first capture one 32 MiB segment
    stays in a private pool through every release: on the H100 it was
    there before this stitch and after the release alike.)"""
    from chip_smoke import _private_pool_bytes
    from simplepanorama_tpu_torch import ba
    ba.release_programs()
    torch.cuda.empty_cache()
    before = _private_pool_bytes(torch)
    _run_ba(slice1_ba)
    held = _private_pool_bytes(torch)
    reserved = torch.cuda.memory_reserved()
    assert held > before and len(ba._PROGRAMS) >= 1
    ba.release_programs()
    torch.cuda.empty_cache()
    assert _private_pool_bytes(torch) == before and not ba._PROGRAMS
    assert torch.cuda.memory_reserved() <= reserved - (held - before)


def test_sift_chunk_halves_under_a_memory_cap(cuda, tmp_path, monkeypatch):
    """features.extract_features on 4 views at init_size 1400 with a
    budget for 4 images a chunk (SPT_SIFT_MEM_BUDGET 40 GB), under
    torch.cuda.set_per_process_memory_fraction for 16 GB: the chunk of 4
    runs out of memory, halves until it fits and the features equal,
    bit for bit, those of the same budget without the cap."""
    import cv2
    from simplepanorama_tpu_torch import ba, features
    paths, _, _ = fkh360_views(4, 1400, out_dir=str(tmp_path))
    imgs = [cv2.imread(p) for p in paths]
    cfg = Config(init_size=1400)
    monkeypatch.setenv("SPT_SIFT_MEM_BUDGET", "40000000000")
    monkeypatch.setattr(features, "_SIFT_CHUNK_CACHE", {})
    assert features._sift_chunk_size(4, 1400, 1400, cfg) == 4
    want = features.extract_features(imgs, cfg, device="cuda")
    ba.release_programs()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(16e9 / total)
    try:
        got = features.extract_features(imgs, cfg, device="cuda")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    ran = features._SIFT_CHUNK_CACHE[features._shape_key(1400, 1400, cfg)]
    assert ran < 4
    for a, b in zip(got, want):
        for name in ("xy", "size", "response", "desc", "valid"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), name)


def test_compose_state_from_numpy_defaults_to_the_card(cuda):
    """convert.compose_state_from_numpy puts the state on the card unless
    the caller asks for another device."""
    from types import SimpleNamespace
    from simplepanorama_tpu_torch.convert import compose_state_from_numpy
    state = SimpleNamespace(
        imgs=np.zeros((2, 8, 128, 3), np.float32),
        masks=np.ones((2, 8, 128), bool), offs=np.zeros((2, 2), np.int32),
        rois=[(0, 0, 128, 8)] * 2, canvas_hw=(8, 256), min_xy=(0, 0),
        seam_masks=None, gains=None, intensity=None)
    st = compose_state_from_numpy(state)
    assert st.imgs.device.type == st.masks.device.type == "cuda"
    assert compose_state_from_numpy(state, device="cpu").imgs.device.type \
        == "cpu"


# ---------------------------------------------------------------- world 1


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A world of one rank over NCCL on cuda:0, through a FileStore, and
    its mesh; the process group is destroyed after the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on the card")
    import torch.distributed as dist
    from simplepanorama_tpu_torch.parallel.mesh import make_mesh
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"),
                           1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()


def _ba_problem_card(n_cams=4, M=512, seed=2):
    """tests/test_parallel.py's BA problem, on the card."""
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.stitch import _rodrigues_np
    rng = np.random.default_rng(seed)
    f = 700.0
    rv = [np.array([0.0, 0.2 * i, 0.01 * i]) for i in range(n_cams)]
    K = np.diag([f, f, 1.0])
    mi = rng.integers(0, n_cams - 1, M)
    mj = mi + 1
    t = rng.uniform(-200, 200, (M, 2)).astype(np.float32)
    q = np.zeros_like(t)
    for m in range(M):
        H = K @ _rodrigues_np(rv[mi[m]]).T @ _rodrigues_np(rv[mj[m]]) \
            @ np.linalg.inv(K)
        p = H @ np.array([t[m, 0], t[m, 1], 1.0])
        q[m] = p[:2] / p[2]
    T = lambda a: torch.as_tensor(a, device="cuda")
    data = ba.with_pair_tables(ba.BAData(
        mi=T(mi), mj=T(mj), q=T(q), t=T(t),
        m_valid=torch.ones(M, dtype=torch.bool, device="cuda"),
        pi=None, pj=None, mp=None))
    rot0 = np.stack([np.zeros(3)] + [r + 0.02 for r in rv[1:]])
    cams = ba.CamState(T(np.full(n_cams, f * 1.05, np.float32)),
                       T(np.zeros((n_cams, 2), np.float32)),
                       T(rot0.astype(np.float32)), data.t.clone())
    return cams, data


@pytest.mark.parametrize("fast", [False, True])
def test_sharded_trial_equals_unsharded_at_world_1(world1, fast):
    """ba.lm_trial with the mesh's process group (the match-sharded
    trial: kernel 3 on this rank's matches, the camera system and the
    error all-reduced over NCCL) against the trial without one, at world
    1 on the card: every state tensor equal, bit for bit (a sum over one
    rank is the identity), with kernel 3 launched once in the sharded
    trial; then 12 trials of lm_run_sharded against a single-card
    program whose trial is ba.lm_trial (_lm_trial_program), the same
    bits again."""
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.parallel.dist_ba import lm_run_sharded
    cams, data = _ba_problem_card()
    active = torch.ones(4, dtype=torch.bool, device="cuda")
    out = {}
    for name, group in (("plain", None), ("sharded", world1.group)):
        pb = ba.lm_problem(data, active, group=group)
        st = ba.lm_init(cams, pb, 0.05, fast)
        before = ba_kernel.assemble_streams.launches
        out[name] = ba.lm_trial(st, pb, fast)
        torch.cuda.synchronize()
        assert ba_kernel.assemble_streams.launches == before + 1
    for a, b in zip(*(list(out[k].cams) + list(out[k][1:])
                      for k in ("plain", "sharded"))):
        assert torch.equal(a, b)
    single = _lm_trial_program(data, 4, fast, max_iter=12)
    try:
        r_e = single.run(cams, active, 0.05)[0]
    finally:
        single.close()
    r_s = lm_run_sharded(cams, data, active, 0.05, world1, fast=fast,
                         max_iter=12)
    for a, b in zip(r_e.cams, r_s.cams):
        assert torch.equal(a, b)
    assert torch.equal(r_e.error, r_s.error)
    assert int(r_e.n_iter) == int(r_s.n_iter) == 12


def _lm_trial_program(data, n_cams, fast, max_iter=50):
    """A single-card ba.LMProgram whose captured trial is ba.lm_trial,
    as a sharded program's is (the trial before kernels 4 and 5)."""
    from simplepanorama_tpu_torch import ba

    class LmTrialProgram(ba.LMProgram):
        trial_kernels = False

        def trial(self):
            self._store(ba.lm_trial(self.st, self.pb, self.fast))
    return LmTrialProgram(data, n_cams, fast, max_iter)


def _same_run(a, b):
    """Two LMResults equal bit for bit: cameras, error, lambda, trials
    and accepted steps."""
    return (all(torch.equal(x, y) for x, y in zip(a.cams, b.cams))
            and all(torch.equal(getattr(a, k), getattr(b, k))
                    for k in ("error", "lam", "n_iter", "n_accepted")))


@pytest.mark.parametrize("problem", ["slice1_relaxed", "slice3_lowe"])
def test_graphed_sharded_lm_equals_eager_and_single_card(world1, problem,
                                                         request,
                                                         monkeypatch):
    """ba.LMProgram with the mesh's process group (the sharded trial, its
    two NCCL all_reduces captured in the graph) at world 1, on the last
    bucket of slice 1's BA (relaxed) and of slice 3's (Lowe), against
    the same sharded program with its trial uncaptured
    (_capture_uncaptured: kernel 3 and the all_reduces issued one by
    one) and ba.LMProgram without a group (its
    trial captured as ba.lm_trial, _lm_trial_program: a program without
    a group replays kernels 4, 3 and 5, held to a float64 run in
    test_fused_program_follows_the_eager_lm), from the same start:
    trials, accepted steps, error, lambda and every camera tensor equal
    bit for bit (a sum over one rank is the identity). The sharded
    program replays ba.lm_step (kernel 3 recorded in its trial, kernels
    4 and 5 not). Kernel 3 launches once per trial executed; every run
    reads the termination flag from all-reduced values, so the reads
    agree with the trials; a second run on the same program reuses its
    graph (no warm-up, no capture) and gives the same bits; and
    parallel.dist_ba.lm_run_sharded, the entry point, takes the graph
    and gives them too."""
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.parallel.dist_ba import lm_run_sharded
    from simplepanorama_tpu_torch.parallel.mesh import shard_matches
    fast = problem == "slice3_lowe"
    args = request.getfixturevalue(problem.split("_")[0] + "_ba")
    data_c, n_cap, cams, active, n = _last_bucket(args)
    runs, counts = {}, {}
    sharded, eager = (ba.LMProgram(shard_matches(data_c, world1), n_cap,
                                   fast, group=world1.group)
                      for _ in range(2))
    single = _lm_trial_program(data_c, n_cap, fast)

    def uncaptured():
        with monkeypatch.context() as m:
            m.setattr(ba.LMProgram, "_capture", _capture_uncaptured)
            return eager.run(cams, active, 0.05, n - 1)
    try:
        for name, run in (
                ("graph_sharded", lambda: sharded.run(cams, active, 0.05,
                                                      n - 1)),
                ("eager_sharded", uncaptured),
                ("graph_single", lambda: single.run(cams, active, 0.05,
                                                    n - 1))):
            before = ba_kernel.assemble_streams.launches
            runs[name], executed, reads = run()
            torch.cuda.synchronize()
            counts[name] = (executed, reads,
                            ba_kernel.assemble_streams.launches - before)
        graph = sharded.graph
        again, executed, reads = sharded.run(cams, active, 0.05, n - 1)
        assert sharded.graph is graph and executed == 8 * reads
        assert _same_run(again, runs["graph_sharded"])
    finally:
        sharded.close()
        eager.close()
        single.close()
    assert not sharded.trial_kernels
    assert sharded.per_trial == {ba_kernel.assemble_streams: 1,
                                 ba_trial.trial_streams: 0,
                                 ba_trial.solve_accept: 0}
    for name in ("eager_sharded", "graph_single"):
        assert _same_run(runs["graph_sharded"], runs[name]), name
    trials = int(runs["graph_sharded"].n_iter)
    assert trials >= 8
    for name, (executed, reads, launches) in counts.items():
        assert launches == executed >= trials, name
        assert executed - 8 * reads in (0, 1), name   # 1: the warm-up
    assert counts["graph_sharded"] == counts["graph_single"]
    res = lm_run_sharded(cams, data_c, active, 0.05, world1, fast=fast,
                         vaug_idx=n - 1)
    assert lm_run_sharded.last_stats["graphed"]
    assert lm_run_sharded.last_stats["capture_s"] > 0
    for a, b in zip(res.cams[:3], runs["graph_sharded"].cams[:3]):
        assert torch.equal(a, b)
    assert torch.equal(res.error, runs["graph_sharded"].error)


def test_halo_exchange_world_1_fills_both_ends(world1):
    """At world 1 the slab has no neighbour: halo_exchange pads both ends
    with ``fill`` and keeps the slab."""
    from simplepanorama_tpu_torch.parallel.tiled_compose import \
        halo_exchange
    x = torch.arange(32, dtype=torch.float32, device="cuda").reshape(4, 8)
    out = halo_exchange(x, 2, world1, fill=-1.0)
    assert out.shape == (4, 12) and out.device.type == "cuda"
    assert torch.equal(out[:, 2:10], x)
    assert bool((out[:, :2] == -1).all() and (out[:, 10:] == -1).all())


def _host_loop_inputs():
    """Three overlapping blocks for the seam finder: (images, masks,
    offsets (y, x)), numpy."""
    rng = np.random.default_rng(3)
    n, Hb, Wb = 3, 48, 128
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    masks = np.zeros((n, Hb, Wb), bool)
    offs = np.array([[0, 0], [10, 60], [20, 120]], np.int32)
    for i in range(n):
        masks[i, 1:39 + i, 1:99 + 5 * i] = True
    return imgs, masks, offs


def _host_loop(imgs, masks, offs):
    """render/graphcut.graph_cut on the card over _host_loop_inputs."""
    T = lambda a: torch.as_tensor(a, device="cuda")
    return graphcut.graph_cut([T(im) for im in imgs], [T(m) for m in masks],
                              [(int(x), int(y)) for y, x in offs],
                              [0, 1, 2])


def test_graph_cut_host_loop_launches_kernel_1(world1):
    """render/graphcut.graph_cut (the host loop) on CUDA tensors in a
    world of one rank: _solve_cut takes grid_mincut_auto, so kernel 1 is
    launched once per cut; the seams match those of the device chain
    (graph_cut_state) on the same blocks on >= 99.9% of each block."""
    imgs, masks, offs = _host_loop_inputs()
    T = lambda a: torch.as_tensor(a, device="cuda")
    before = maxflow.grid_mincut.launches
    seams = _host_loop(imgs, masks, offs)
    assert maxflow.grid_mincut.launches == before + 2
    st = ComposeState(imgs=T(imgs), masks=T(masks), offs=T(offs), rois=[],
                      canvas_hw=(80, 256), min_xy=(0, 0))
    chain = graphcut.graph_cut_state(st, [0, 1, 2]).cpu().numpy()
    for s, c in zip(seams, chain):
        assert s.device.type == "cuda"
        assert (s.cpu().numpy() == c).mean() >= 0.999


_HOST_LOOP_WORKER = """
import os
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import torch.distributed as dist
from simplepanorama_tpu_torch.ops import maxflow
from simplepanorama_tpu_torch.parallel.mesh import pipeline_mesh
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
from test_torch_cuda import _host_loop, _host_loop_inputs

# gloo, so that both ranks may share one card (NCCL takes a card a rank)
dist.init_process_group(
    "gloo", init_method="tcp://" + os.environ["SPT_COORDINATOR"],
    world_size=int(os.environ["SPT_NUM_PROCS"]),
    rank=int(os.environ["SPT_PROC_ID"]))
mesh = pipeline_mesh()
assert mesh is not None and mesh.size == 2
torch.cuda.set_device(0)
seams = _host_loop(*_host_loop_inputs())
torch.cuda.synchronize()
np.save(sys.argv[2] % mesh.rank, np.stack([s.cpu().numpy() for s in seams]))
print("launches", maxflow.grid_mincut.launches,
      maxflow.grid_mincut_tiled.launches, flush=True)
dist.destroy_process_group()
"""


def test_graph_cut_host_loop_launches_kernel_1_in_world_of_2(cuda,
                                                             tmp_path):
    """The host loop on CUDA tensors in a world of 2 ranks (gloo, both
    ranks on card 0): each rank solves its whole graphs with kernel 1,
    once per cut (2 cuts, no kernel-2 launch), and its seams equal, bit
    for bit, those of the host loop in this process, which has no
    world."""
    import os
    from simplepanorama_tpu_torch.parallel.launch import run_world
    want = np.stack([s.cpu().numpy()
                     for s in _host_loop(*_host_loop_inputs())])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_HOST_LOOP_WORKER)
    outs = run_world([str(script), repo, str(tmp_path / "seams%d.npy")], 2,
                     timeout_s=300, cwd=repo)
    for rank, (rc, log) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{log[-3000:]}"
        assert "launches 2 0" in log, log[-3000:]
        np.testing.assert_array_equal(
            np.load(tmp_path / f"seams{rank}.npy"), want)
