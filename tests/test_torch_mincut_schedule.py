"""Plain-PyTorch models of the schedules the two min-cut kernels run on
the card (csrc/mincut_bfs.cuh, csrc/mincut_tile.cuh, csrc/mincut.cu,
csrc/mincut_tiled.cu), held on the CPU against the plain solvers, the
scan BFS and scipy's exact max flow. The kernels may push in another
order than the plain versions; these tests show that the orders they use
reach the same cut and the same distances.

* The tile BFS: level-synchronous inside a tile and incremental from
  round to round (the sinks enter at level 0 in the first round, then
  every halo cell whose distance dropped enters at its new distance),
  rounds over all tiles until no edge distance drops. Held against
  _dist_to_sink_scan: equal on every cell.
* Kernel 1's BFS driven by events: each tile runs once on its sinks,
  then again whenever a neighbour published a lower distance on their
  shared edge, with the kernel's count of runs owed deciding the end; in
  event order and in seeded random interleavings where a run reads its
  halo, other tiles run, and it publishes later. Held against
  _dist_to_sink_scan: equal on every cell.
* Kernel 2: four colours of tiles, each tile running k push/relabel
  phases in a row with its halo cells only receiving; cells at height INF
  do not push. Held against grid_mincut_ref and scipy.
* Kernel 1: lock-step phases over the whole grid, a flow that leaves its
  tile applied only after the phase's four sub-steps, before the relabel.
  Held against grid_mincut_ref and scipy.
* Kernel 1's resident tiles without grid barriers in their push phases:
  each tile waits only on its neighbours' phase words, with one inflow
  plane per direction and one height plane. In seeded random
  interleavings its c, e, h and sides equal the lock-step order's bit for
  bit; without the wait on the heights they do not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplepanorama_tpu.ops import maxflow as jmf
from simplepanorama_tpu_torch.fixtures import (cut_grid, max_flow_value,
                                               maze_grid)
from simplepanorama_tpu_torch.ops import maxflow as tmf

torch.set_num_threads(2)

_INF = tmf._INF
_BIG = 1 << 40   # int "no path" of the BFS model


def _grids():
    return {
        "random24x32": cut_grid(24, 32, 0, (5, 9, 10, 14)),
        "random48x160": cut_grid(48, 160, 7, (10, 20, 40, 70)),
        "maze24x64": maze_grid(24, 64, 0),
        "maze40x96": maze_grid(40, 96, 1),
    }


def _state(host):
    t = [torch.from_numpy(a) for a in host]
    caps, e = tmf._init_state(*t)
    return t, caps, e


def _tile_bfs(opn, sink, d, halo, halo_old, first):
    """One incremental round of the level BFS of one tile, in place on its
    distances ``d`` (int64 (h, w), exact for ``halo_old``). opn: 4 bool
    (h, w) planes (may step right, left, down, up); halo, halo_old: int64
    (h + 2, w + 2) with the halo distances on the border (corners and
    inside unused). Seeds: the sinks at level 0 in the first round, and
    the halo cells whose distance dropped, each at its new distance. A
    level lowers the cells next to the frontier whose distance is above
    the level + 1. Returns whether a distance on the tile's edge dropped."""
    h, w = sink.shape
    border = torch.where(halo < halo_old, halo, torch.full_like(halo, _BIG))
    border[1:-1, 1:-1] = _BIG
    front = torch.zeros((h + 2, w + 2), dtype=torch.bool)
    if first:
        front[1:-1, 1:-1] = sink
    edge = torch.ones((h, w), dtype=torch.bool)
    edge[1:-1, 1:-1] = False
    dropped = False
    L = 0 if bool(front.any()) else int(border.min())
    while L < _BIG:
        f = front | (border == L)     # halo cells join at their own level
        cand = ((opn[0] & f[1:-1, 2:]) | (opn[1] & f[1:-1, :-2])
                | (opn[2] & f[2:, 1:-1]) | (opn[3] & f[:-2, 1:-1]))
        new = cand & (d > L + 1)
        d[new] = L + 1
        dropped |= bool((new & edge).any())
        front = torch.zeros_like(front)
        front[1:-1, 1:-1] = new
        if bool(new.any()):
            L += 1
        else:   # the frontier is empty: the next halo level, if any
            later = border[border > L]
            L = int(later.min()) if later.numel() else _BIG
    return dropped


def _bfs_model(caps, e, node, BH, BW):
    """Rounds of incremental tile BFSs over BH x BW tiles until no edge
    distance drops. Returns (float distances with _INF, rounds)."""
    H, W = e.shape
    opn = [c > 0 for c in caps]
    sink = node & (e < 0)
    d = torch.where(sink, 0, _BIG).to(torch.int64)
    pad = torch.full((H + 2, W + 2), _BIG, dtype=torch.int64)
    seen = {}
    rounds = 0
    while True:
        dropped = False
        for y0 in range(0, H, BH):
            for x0 in range(0, W, BW):
                y1, x1 = min(y0 + BH, H), min(x0 + BW, W)
                pad[1:-1, 1:-1] = d
                halo = pad[y0:y1 + 2, x0:x1 + 2].clone()
                old = seen.get((y0, x0), torch.full_like(halo, _BIG))
                sl = (slice(y0, y1), slice(x0, x1))
                dt = d[sl].clone()
                dropped |= _tile_bfs([o[sl] for o in opn], sink[sl], dt,
                                     halo, old, rounds == 0)
                d[sl] = dt
                seen[(y0, x0)] = halo
        rounds += 1
        if not dropped:
            break
    return torch.where(d < _BIG, d.to(torch.float32),
                       torch.full_like(e, _INF)), rounds


@pytest.mark.parametrize("grid", ["random24x32", "random48x160",
                                  "maze24x64", "maze40x96"])
@pytest.mark.parametrize("BH,BW", [(8, 32), (5, 17)])
def test_tile_bfs_model_matches_scan(grid, BH, BW):
    """The incremental tile BFS (halo cells entering at their own level,
    rounds until no edge distance drops) gives exactly _dist_to_sink_scan's
    distances on every cell, INF included, for tiles that divide the grid
    and tiles that do not."""
    t, caps, e = _state(_grids()[grid])
    got, rounds = _bfs_model(caps, e, t[3], BH, BW)
    want = tmf._dist_to_sink_scan(caps, e < 0, t[3], e.numel() + 1)
    assert torch.equal(got, want)
    assert rounds >= 1


def _event_bfs_model(caps, e, node, BH, BW, order="events", n_pass=None):
    """Kernel 1's event-driven BFS (csrc/mincut.cu, bfs_events) over BH x BW
    tiles, one state machine a tile as its CTA runs it: ready (a run
    taken), running (its halo read, its result not yet published),
    waiting (for a run asked of it, or for no run owed anywhere), done.
    A run that lowered a distance on a side with a neighbour counts a run
    owed and asks the neighbour for it, then uncounts its own. ``order``
    "events" takes the state that was entered first; an int seeds a
    random choice among the tiles that can move. A tile runs at most
    ``n_pass`` times. Returns (float distances with _INF, runs a tile)."""
    H, W = e.shape
    opn = [c > 0 for c in caps]
    sink = node & (e < 0)
    d = torch.where(sink, 0, _BIG).to(torch.int64)
    pad = torch.full((H + 2, W + 2), _BIG, dtype=torch.int64)
    nty, ntx = -(-H // BH), -(-W // BW)
    n = nty * ntx
    n_pass = n_pass or H * W + 1
    rng = None if order == "events" else np.random.default_rng(order)
    owed, asked, taken = n, [0] * n, [1] * n
    state, since = ["ready"] * n, list(range(n))
    runs, seen, result = [0] * n, {}, {}

    def box(t):
        y0, x0 = (t // ntx) * BH, (t % ntx) * BW
        return y0, x0, min(y0 + BH, H), min(x0 + BW, W)

    def step(t):
        nonlocal owed
        y0, x0, y1, x1 = box(t)
        sl = (slice(y0, y1), slice(x0, x1))
        if state[t] == "ready" and runs[t] < n_pass:
            pad[1:-1, 1:-1] = d
            halo = pad[y0:y1 + 2, x0:x1 + 2].clone()
            dt = d[sl].clone()
            before = dt.clone()
            _tile_bfs([o[sl] for o in opn], sink[sl], dt, halo,
                      seen.get(t, torch.full_like(halo, _BIG)), runs[t] == 0)
            seen[t] = halo
            runs[t] += 1
            low = dt < before
            result[t] = (dt, [bool(low[0].any()), bool(low[-1].any()),
                              bool(low[:, 0].any()), bool(low[:, -1].any())])
            state[t] = "running"
        elif state[t] in ("ready", "running"):
            dt, sides = result.pop(t, (None, [False] * 4))
            if dt is not None:
                d[sl] = dt
            ty, tx = t // ntx, t % ntx
            nbs = [t - ntx if ty > 0 else -1, t + ntx if ty + 1 < nty else -1,
                   t - 1 if tx > 0 else -1, t + 1 if tx + 1 < ntx else -1]
            ask = [nb for nb, s in zip(nbs, sides) if s and nb >= 0]
            owed += len(ask)
            for nb in ask:
                asked[nb] += 1
            owed -= taken[t]
            taken[t] = 0
            state[t] = "waiting"
        elif asked[t]:
            taken[t], asked[t] = asked[t], 0
            state[t] = "ready"
        else:
            state[t] = "done"
        assert owed == sum(asked) + sum(taken)

    clock = n
    while True:
        live = [t for t in range(n) if state[t] != "done" and not (
            state[t] == "waiting" and not asked[t] and owed)]
        if not live:
            break
        if rng is None:
            t = min(live, key=lambda u: since[u])
        else:
            t = live[rng.integers(len(live))]
        step(t)
        since[t] = clock
        clock += 1
    assert owed == 0 and all(s == "done" for s in state)
    return torch.where(d < _BIG, d.to(torch.float32),
                       torch.full_like(e, _INF)), runs


@pytest.mark.parametrize("grid", ["random24x32", "random48x160",
                                  "maze24x64", "maze40x96"])
@pytest.mark.parametrize("BH,BW", [(8, 32), (5, 17)])
@pytest.mark.parametrize("order", ["events", 0, 1, 2])
def test_event_bfs_model_matches_scan(grid, BH, BW, order):
    """Kernel 1's BFS without a grid barrier between tile runs (a tile
    runs on its sinks, then whenever a neighbour's edge distance drops;
    the count of runs owed ends it) gives exactly _dist_to_sink_scan's
    distances on every cell, INF included, in event order and in seeded
    random interleavings of the tiles' reads and publishes, for tiles
    that divide the grid and tiles that do not; every tile ran."""
    t, caps, e = _state(_grids()[grid])
    got, runs = _event_bfs_model(caps, e, t[3], BH, BW, order)
    want = tmf._dist_to_sink_scan(caps, e < 0, t[3], e.numel() + 1)
    assert torch.equal(got, want)
    assert min(runs) >= 1


@pytest.mark.parametrize("n_pass", [1, 2])
def test_event_bfs_model_stops_at_n_pass(n_pass):
    """With n_pass runs a tile, the event-driven BFS still ends (a run
    asked beyond them is uncounted unrun), no tile runs more, and the
    maze's distances, whose waves cross many tiles, are not yet reached."""
    t, caps, e = _state(_grids()["maze40x96"])
    got, runs = _event_bfs_model(caps, e, t[3], 8, 32, 0, n_pass=n_pass)
    want = tmf._dist_to_sink_scan(caps, e < 0, t[3], e.numel() + 1)
    assert max(runs) == n_pass
    assert not torch.equal(got, want)


@pytest.mark.parametrize("grid", ["random48x160", "maze40x96"])
def test_dist_to_sink_cpu_matches_jax_scan(grid):
    """maxflow.dist_to_sink on CPU tensors (the plain path of the kernels'
    BFS entry point) equals the JAX package's _dist_to_sink_scan on the
    same initial graph (its _mincut_core state), exactly, and the tile BFS
    model."""
    host = _grids()[grid]
    t = [torch.from_numpy(a) for a in host]
    got = tmf.dist_to_sink(*t)
    wh, wv, exc, node = (jnp.asarray(a) for a in host)
    nodef = node.astype(jnp.float32)
    ch = wh * nodef * jmf._shift(nodef, 0, 1, 0.0)
    cv = wv * nodef * jmf._shift(nodef, 1, 0, 0.0)
    caps = jnp.stack([ch, jmf._shift(ch, 0, -1, 0.0),
                      cv, jmf._shift(cv, -1, 0, 0.0)])
    e = jnp.clip(jnp.where(node, exc, 0.0), -(caps.sum(0) + 1.0),
                 caps.sum(0) + 1.0)
    want = np.asarray(jmf._dist_to_sink_scan(caps, e < 0, node,
                                             host[0].size + 1))
    assert np.array_equal(got.numpy(), want)
    _, caps_t, e_t = _state(host)
    model, _ = _bfs_model(caps_t, e_t, t[3], 8, 32)
    assert torch.equal(got, model)


def _cut_checks(host, side, name):
    t = [torch.from_numpy(a) for a in host]
    ref = tmf.grid_mincut_ref(*t)
    v = tmf.cut_value(*host, side)
    v_ref = tmf.cut_value(*host, ref)
    exact = max_flow_value(*host)
    assert abs(v - v_ref) <= 1e-3 * max(1.0, abs(v_ref)), (name, v, v_ref)
    assert abs(v - exact) <= 1e-3 * max(1.0, exact), (name, v, exact)
    node = host[3]
    assert (side.numpy() == ref.numpy())[node].mean() >= 0.999


def _bfs(caps, e, node):
    return tmf._dist_to_sink_scan(caps, e < 0, node, e.numel() + 1)


def _tiled_model(host, TH, TW, k, inner=30, max_outer=400):
    """Kernel 2's schedule: per outer round, ceil(inner / k) visits of
    every active tile, the tiles of one colour (tile row, column mod 2)
    at a time; a visit runs k push/relabel phases on the tile with its
    edge halo, where only interior cells below INF push or lift. Returns
    (side, outer rounds)."""
    t, caps, e = _state(host)
    node = t[3]
    H, W = e.shape
    h = _bfs(caps, e, node)
    it = 0
    while it < max_outer and bool(((e > 0) & (h < _INF)).any()):
        for _ in range(-(-inner // k)):
            for cy in (0, 1):
                for cx in (0, 1):
                    for y0 in range(cy * TH, H, 2 * TH):
                        for x0 in range(cx * TW, W, 2 * TW):
                            y1, x1 = min(y0 + TH, H), min(x0 + TW, W)
                            if not bool(((e[y0:y1, x0:x1] > 0)
                                         & (h[y0:y1, x0:x1] < _INF)).any()):
                                continue   # an idle tile
                            s0, s1 = max(y0 - 1, 0), min(y1 + 1, H)
                            r0, r1 = max(x0 - 1, 0), min(x1 + 1, W)
                            sl = (slice(s0, s1), slice(r0, r1))
                            inner_m = torch.zeros((s1 - s0, r1 - r0),
                                                  dtype=torch.bool)
                            inner_m[y0 - s0:y1 - s0, x0 - r0:x1 - r0] = True
                            cs = [c[sl].clone() for c in caps]
                            es, hs = e[sl].clone(), h[sl].clone()
                            for _ in range(k):
                                es, hs = tmf._push_phase(cs, es, hs,
                                                         inner_m & (hs < _INF))
                            for c, cn in zip(caps, cs):
                                c[sl] = cn
                            e[sl] = es
                            h[sl] = hs
        h = _bfs(caps, e, node)
        it += 1
    return (h >= _INF) & node, it


@pytest.mark.parametrize("grid", ["random24x32", "random48x160",
                                  "maze24x64"])
@pytest.mark.parametrize("k", [1, 5])
def test_tiled_schedule_model_reaches_the_min_cut(grid, k):
    """Kernel 2's schedule (four colours, k phases per tile visit, idle
    tiles skipped, no pushes at INF) reaches the plain solver's cut and
    scipy's exact value (within 1e-3 relative), sides equal on >= 99.9%
    of nodes, ended by its termination test."""
    host = _grids()[grid]
    side, outer = _tiled_model(host, 8, 32, k)
    assert outer < 400
    _cut_checks(host, side, grid)


def _resident_model(host, TH, TW, inner=30, max_outer=400):
    """Kernel 1's schedule: lock-step phases over the whole grid; a flow
    whose target lies in another TH x TW tile leaves its sender at once
    and reaches its target after the phase's four sub-steps, before the
    lock-step relabel; cells at INF do not push. Returns (side, outer
    rounds)."""
    t, caps, e = _state(host)
    node = t[3]
    H, W = e.shape
    tile = (torch.arange(H)[:, None] // TH) * W + \
        torch.arange(W)[None, :] // TW
    zero = torch.zeros_like(e)
    h = _bfs(caps, e, node)
    it = 0
    while it < max_outer and bool(((e > 0) & (h < _INF)).any()):
        for _ in range(inner):
            h_nb = [tmf._shift(h, dy, dx, _INF) for dy, dx in tmf._DIRS]
            lower = [h == nb + 1.0 for nb in h_nb]
            late_e = zero.clone()
            late_c = [zero.clone() for _ in range(4)]
            for k, (dy, dx) in enumerate(tmf._DIRS):
                adm = (e > 0) & lower[k] & (caps[k] > 0) & (h < _INF)
                flow = torch.where(adm, torch.minimum(e, caps[k]), zero)
                caps[k] = caps[k] - flow
                back = tmf._shift(flow, -dy, -dx, 0.0)
                src_tile = tmf._shift(tile, -dy, -dx, -1)
                same = src_tile == tile
                now = torch.where(same, back, zero)
                late = torch.where(same, zero, back)
                caps[tmf._REV[k]] = caps[tmf._REV[k]] + now
                e = e - flow + now
                late_e = late_e + late
                late_c[tmf._REV[k]] = late_c[tmf._REV[k]] + late
            e = e + late_e
            for k in range(4):
                caps[k] = caps[k] + late_c[k]
            min_h = torch.full_like(e, _INF)
            adm = torch.zeros(e.shape, dtype=torch.bool)
            for k in range(4):
                has = caps[k] > 0
                min_h = torch.minimum(min_h, torch.where(has, h_nb[k], _INF))
                adm |= has & lower[k]
            lift = (e > 0) & ~adm & (min_h < _INF)
            h = torch.where(lift, min_h + 1.0, h)
        h = _bfs(caps, e, node)
        it += 1
    return (h >= _INF) & node, it


@pytest.mark.parametrize("grid", ["random24x32", "random48x160",
                                  "maze24x64"])
def test_resident_schedule_model_reaches_the_min_cut(grid):
    """Kernel 1's schedule (whole-grid lock-step phases, cross-tile flow
    applied after the four sub-steps) reaches the plain solver's cut and
    scipy's exact value (within 1e-3 relative), sides equal on >= 99.9%
    of nodes, ended by its termination test."""
    host = _grids()[grid]
    side, outer = _resident_model(host, 12, 32)
    assert outer < 400
    _cut_checks(host, side, grid)


def _flag_model(host, TH, TW, order, inner=30, max_outer=400, guard=True):
    """Kernel 1's resident route (csrc/mincut.cu) tile by tile, in numpy
    float32 with the kernel's operations in its order: each launch loads
    every TH x TW tile (its halo heights from the global plane), runs
    ``inner`` push phases and stores it; a BFS follows. A phase of a tile
    is three steps: push (halo excess zeroed, the four lock-step
    sub-steps, the flows that left the tile written to the one inflow
    plane of their direction, phase word 2p + 1); inflow (after every
    neighbour's word reads 2p + 1: the neighbours' flows added to the
    tile's edge cells by direction, then the relabel, the edge heights
    written to the one global height plane, phase word 2p + 2); halo
    (after every neighbour's word reads 2p + 2: the halo heights read
    back). The last phase has no halo step and publishes no heights.

    ``order`` "lockstep" runs each step on every tile before the next
    step (the grid barriers of the parent kernel); an int seeds random
    interleavings of the tiles' steps in which each tile waits only on
    its neighbours' words. ``guard`` False drops the wait before the halo
    step, so a tile may read heights not yet published and write phase
    p + 1 flows before a neighbour read its phase-p ones. Returns
    (caps (4, H, W), e, h, side, outer rounds, the largest number of
    phases by which one tile ran ahead of another)."""
    t, caps_t, e_t = _state(host)
    node = t[3]
    caps = np.stack([c.numpy() for c in caps_t])
    e = e_t.numpy().copy()
    H, W = e.shape
    INF, f0 = np.float32(_INF), np.float32(0.0)
    nty, ntx = -(-H // TH), -(-W // TW)
    n = nty * ntx
    rng = None if order == "lockstep" else np.random.default_rng(order)

    def bfs():
        return _bfs([torch.from_numpy(c) for c in caps], torch.from_numpy(e),
                    node).numpy()

    def box(ti):
        y0, x0 = (ti // ntx) * TH, (ti % ntx) * TW
        return y0, x0, min(y0 + TH, H), min(x0 + TW, W)

    def nbs(ti):
        ty, tx = ti // ntx, ti % ntx
        return [u for u, ok in ((ti - ntx, ty > 0), (ti + ntx, ty + 1 < nty),
                                (ti - 1, tx > 0), (ti + 1, tx + 1 < ntx))
                if ok]

    def shift(a, dy, dx, fill):   # out[y, x] = a[y + dy, x + dx]
        out = np.full_like(a, fill)
        h_, w_ = a.shape
        out[max(0, -dy):h_ - max(0, dy), max(0, -dx):w_ - max(0, dx)] = \
            a[max(0, dy):h_ - max(0, -dy), max(0, dx):w_ - max(0, -dx)]
        return out

    def read_halo(ti, hl, hg):
        y0, x0, y1, x1 = box(ti)
        if y0 > 0:
            hl[0, 1:-1] = hg[y0 - 1, x0:x1]
        if y1 < H:
            hl[-1, 1:-1] = hg[y1, x0:x1]
        if x0 > 0:
            hl[1:-1, 0] = hg[y0:y1, x0 - 1]
        if x1 < W:
            hl[1:-1, -1] = hg[y0:y1, x1]

    def launch(h):
        inflow = np.zeros((4, H, W), np.float32)
        tiles = []
        for ti in range(n):
            y0, x0, y1, x1 = box(ti)
            c = np.zeros((4, y1 - y0 + 2, x1 - x0 + 2), np.float32)
            c[:, 1:-1, 1:-1] = caps[:, y0:y1, x0:x1]
            el = np.zeros(c.shape[1:], np.float32)
            el[1:-1, 1:-1] = e[y0:y1, x0:x1]
            hl = np.full(c.shape[1:], INF, np.float32)
            hl[1:-1, 1:-1] = h[y0:y1, x0:x1]
            read_halo(ti, hl, h)
            tiles.append([c, el, hl])
        word = [0] * n

        def push(ti, p):
            c, el, hl = tiles[ti]
            m = np.zeros(el.shape, bool)
            m[1:-1, 1:-1] = True
            el[0, :] = el[-1, :] = el[:, 0] = el[:, -1] = f0
            for k, (dy, dx) in enumerate(tmf._DIRS):
                nb = shift(hl, dy, dx, INF)
                f = np.where(m & (el > 0) & (hl < INF) & (hl == nb + 1)
                             & (c[k] > 0), np.minimum(el, c[k]), f0)
                b = shift(f, -dy, -dx, f0)
                c[k] = c[k] - f
                c[tmf._REV[k]] = c[tmf._REV[k]] + b
                el[:] = el - f + b
            y0, x0, y1, x1 = box(ti)
            if x1 < W:
                inflow[0, y0:y1, x1] = el[1:-1, -1]
            if x0 > 0:
                inflow[1, y0:y1, x0 - 1] = el[1:-1, 0]
            if y1 < H:
                inflow[2, y1, x0:x1] = el[-1, 1:-1]
            if y0 > 0:
                inflow[3, y0 - 1, x0:x1] = el[0, 1:-1]
            word[ti] = 2 * p + 1

        def take(ti, p):
            c, el, hl = tiles[ti]
            y0, x0, y1, x1 = box(ti)
            # by direction: into the left column, the right column, the
            # top row, the bottom row
            for k, ok, sl, src in (
                    (0, x0 > 0, (slice(1, -1), 1), (slice(y0, y1), x0)),
                    (1, x1 < W, (slice(1, -1), -2), (slice(y0, y1), x1 - 1)),
                    (2, y0 > 0, (1, slice(1, -1)), (y0, slice(x0, x1))),
                    (3, y1 < H, (-2, slice(1, -1)), (y1 - 1, slice(x0, x1)))):
                if ok:
                    f = inflow[k][src]
                    c[tmf._REV[k]][sl] = c[tmf._REV[k]][sl] + f
                    el[sl] = el[sl] + f
            m = np.zeros(el.shape, bool)
            m[1:-1, 1:-1] = True
            min_h = np.full_like(hl, INF)
            adm = np.zeros(hl.shape, bool)
            for k, (dy, dx) in enumerate(tmf._DIRS):
                nb = shift(hl, dy, dx, INF)
                has = c[k] > 0
                min_h = np.minimum(min_h, np.where(has, nb, INF))
                adm |= has & (hl == nb + 1)
            lift = m & (el > 0) & ~adm & (min_h < INF)
            hl[:] = np.where(lift, min_h + 1, hl)
            if p + 1 < inner:
                for sl, src in (((1, slice(1, -1)), (y0, slice(x0, x1))),
                                ((-2, slice(1, -1)), (y1 - 1, slice(x0, x1))),
                                ((slice(1, -1), 1), (slice(y0, y1), x0)),
                                ((slice(1, -1), -2),
                                 (slice(y0, y1), x1 - 1))):
                    h[src] = hl[sl]
                word[ti] = 2 * p + 2

        steps = [(s, p) for p in range(inner)
                 for s in ("push", "take", "halo")][:-1]
        ready = {"push": lambda ti, p: True,
                 "take": lambda ti, p: all(word[u] >= 2 * p + 1
                                           for u in nbs(ti)),
                 "halo": lambda ti, p: not guard or all(
                     word[u] >= 2 * p + 2 for u in nbs(ti))}
        run = {"push": push, "take": take,
               "halo": lambda ti, p: read_halo(ti, tiles[ti][2], h)}
        pc = [0] * n
        skew = 0
        if rng is None:
            for s, p in steps:
                for ti in range(n):
                    run[s](ti, p)
        else:
            while min(pc) < len(steps):
                live = [ti for ti in range(n) if pc[ti] < len(steps)
                        and ready[steps[pc[ti]][0]](ti, steps[pc[ti]][1])]
                assert live, "the tiles' waits deadlocked"
                ti = live[rng.integers(len(live))]
                run[steps[pc[ti]][0]](ti, steps[pc[ti]][1])
                pc[ti] += 1
                ph = [steps[min(q, len(steps) - 1)][1] for q in pc]
                skew = max(skew, max(ph) - min(ph))
        for ti in range(n):
            y0, x0, y1, x1 = box(ti)
            caps[:, y0:y1, x0:x1] = tiles[ti][0][:, 1:-1, 1:-1]
            e[y0:y1, x0:x1] = tiles[ti][1][1:-1, 1:-1]
        return skew

    h = bfs()
    it = skew = 0
    while it < max_outer and bool(((e > 0) & (h < INF) & node.numpy()).any()):
        skew = max(skew, launch(h))
        h = bfs()
        it += 1
    side = (h >= INF) & node.numpy()
    return caps, e, h, side, it, skew


# uneven tiles for the flag model: 7-row tiles (7 divides neither H) and
# grids whose W is no multiple of the 32-column tiles
_FLAG_GRIDS = {
    "random30x80": lambda: cut_grid(30, 80, 2, (6, 14, 20, 50)),
    "maze24x72": lambda: maze_grid(24, 72, 4),
}


@pytest.fixture(scope="module")
def lockstep():
    """The flag model in lock-step order, once a grid for the module."""
    memo = {}

    def get(grid):
        if grid not in memo:
            memo[grid] = _flag_model(_FLAG_GRIDS[grid](), 7, 32, "lockstep")
        return memo[grid]
    return get


def _same_bits(got, want):
    return all(np.array_equal(a.view(np.int32), b.view(np.int32))
               for a, b in zip(got[:3], want[:3])) and \
        np.array_equal(got[3], want[3]) and got[4] == want[4]


@pytest.mark.parametrize("grid", sorted(_FLAG_GRIDS))
def test_lockstep_tile_model_reaches_the_min_cut(lockstep, grid):
    """The tile model of kernel 1's resident route in lock-step order
    (its one inflow plane per direction and one height plane) reaches
    the plain solver's cut and scipy's exact value (within 1e-3
    relative), sides equal on >= 99.9% of nodes, ended by its
    termination test."""
    side, outer = lockstep(grid)[3:5]
    assert outer < 400
    _cut_checks(_FLAG_GRIDS[grid](), torch.from_numpy(side), grid)


@pytest.mark.parametrize("grid", sorted(_FLAG_GRIDS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flag_schedule_model_equals_lockstep(lockstep, grid, seed):
    """Kernel 1's push phases without grid barriers: each tile waits only
    on its neighbours' phase words, before it reads their flows and
    before it reads their heights, in seeded random interleavings in
    which a tile runs two or more phases ahead of tiles it does not
    touch. With the single inflow and height planes the final c, e, h,
    sides and outer rounds equal the lock-step order's bit for bit."""
    got = _flag_model(_FLAG_GRIDS[grid](), 7, 32, seed)
    assert _same_bits(got, lockstep(grid))
    assert got[5] >= 2


@pytest.mark.parametrize("grid", sorted(_FLAG_GRIDS))
def test_flag_schedule_model_needs_the_height_wait(lockstep, grid):
    """Without the wait on the neighbours' heights a tile writes phase
    p + 1 flows into the inflow plane before a neighbour read its phase-p
    ones (and reads heights not yet published): the result leaves the
    lock-step order's, so the equality above guards the ordering."""
    got = _flag_model(_FLAG_GRIDS[grid](), 7, 32, 0, guard=False)
    assert not _same_bits(got, lockstep(grid))
