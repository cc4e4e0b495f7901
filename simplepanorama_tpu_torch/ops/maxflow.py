"""Min-cut of a 4-connected seam grid: lock-step push-relabel.

Port of simplepanorama_tpu/ops/maxflow.py. Graph encoding and algorithm
are the same: t-links are folded into a signed excess (e = cap_source -
cap_sink); every push/relabel phase is a lock-step (H, W) update with
4-neighbour shifts; one global-relabel BFS per outer round (distance to
the nearest sink through positive residual edges, computed by directional
min-plus scans) gives the next heights and the termination test. The
source side of the cut is the set of nodes that cannot reach a sink.

Two solvers, each with a plain PyTorch version and a CUDA kernel:

* whole grid: ``grid_mincut_ref``, a line-for-line port of
  ``_mincut_core`` + ``_dist_to_sink_scan``, and ``csrc/mincut.cu``, the
  kernel that replaces the TPU Pallas kernel ``_mincut_kernel``;
* tiled: ``grid_mincut_tiled_ref``, the port of the row-tiled
  ``_mincut_tiled_kernel``, and ``csrc/mincut_tiled.cu``, which replaces
  it with 2-D tiles in shared memory.

Both kernels run one cooperative launch per outer round and share the
bit-parallel tile BFS of ``csrc/mincut_bfs.cuh``; ``dist_to_sink`` runs
that BFS alone. They may push in another order than their plain
versions, which reaches the same cut (tests/test_torch_mincut_schedule.py
holds CPU models of their schedules to it).

``grid_mincut`` and ``grid_mincut_tiled`` dispatch on where their tensors
live: CPU tensors take the plain version; CUDA tensors launch the kernel
(built with nvcc at first use) or raise. There is no fallback from one to
the other. ``grid_mincut_auto`` picks the solver by grid size.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from simplepanorama_tpu_torch.utils.nvcc import count_launches

_INF = 1e18

# direction order: 0=right(+x), 1=left(-x), 2=down(+y), 3=up(-y)
_DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0))
_REV = (1, 0, 3, 2)


def _shift(x: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """result[y, x] = x[y+dy, x+dx]; out-of-bounds filled with ``fill``
    (any step size — the port of both _shift and _shift_n)."""
    H, W = x.shape
    out = torch.full_like(x, fill)
    if abs(dy) >= H or abs(dx) >= W:
        return out
    out[max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)] = \
        x[max(0, dy):H - max(0, -dy), max(0, dx):W - max(0, -dx)]
    return out


def _scan_offsets(open_, dim: int, reverse: bool, big: int):
    """Offsets of one scan direction for _minplus_scan. Each run of open
    steps is a segment; the offset is p + seg(p) * big, so every later
    segment sits above anything before it and the cummin cannot reach
    across a closed step (``big`` exceeds the spread of the distances
    plus the line length). Built once per BFS: the open steps do not
    change while it runs."""
    if reverse:
        open_ = open_.flip(dim)
    n = open_.shape[dim]
    shape = [1, 1]
    shape[dim] = n
    idx = torch.arange(n, device=open_.device).view(shape)
    seg = torch.cumsum((~open_).to(torch.int64), dim)
    return idx + seg * big


def _minplus_scan(d, lo, dim: int, reverse: bool):
    """Inclusive min-plus scan of integer distances along ``dim``:
    d[p] = min(d[p], d[p-1] + 1) wherever the step into p is open (the
    JAX package's _minplus_scan with weights 1 / INF). Within a segment
    d[p] = p + cummin_{j<=p}(d[j] - j), which with the segment offsets
    ``lo`` of _scan_offsets is cummin(d - lo) + lo."""
    if reverse:
        d = d.flip(dim)
    out = torch.cummin(d - lo, dim).values + lo
    return out.flip(dim) if reverse else out


def _tally(stats, key, n):
    """Add ``n`` (an int or a device scalar, so no host sync) to
    ``stats[key]`` when the caller asked for stats."""
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _relax_scan(caps, d, node, n_pass: int, sentinel: int, stats=None):
    """Passes of down/up/right/left min-plus scans over integer distances
    ``d`` (int64, ``sentinel`` for INF) until a pass changes nothing (one
    host sync per pass) or ``n_pass`` passes ran: the fixpoint of
    d[p] = min(d[p], d[q] + 1) over residual edges p -> q, restricted to
    the node set. ``stats["scan_cells"]`` counts the node cells of every
    pass."""
    H, W = d.shape
    # a scan never raises a distance, so every value stays <= sentinel
    big = 2 * sentinel + 8 * (H + W)
    # a step into p from its predecessor is open iff p can push back
    # toward the predecessor (residual capacity of the reverse direction)
    open_down, open_up = caps[3] > 0, caps[2] > 0
    open_right, open_left = caps[1] > 0, caps[0] > 0
    unreach = torch.full_like(d, sentinel)
    # column scans run on a transposed copy, so every scan is along the
    # contiguous dim
    lo_down = _scan_offsets(open_down.t().contiguous(), 1, False, big)
    lo_up = _scan_offsets(open_up.t().contiguous(), 1, True, big)
    lo_right = _scan_offsets(open_right, 1, False, big)
    lo_left = _scan_offsets(open_left, 1, True, big)
    for _ in range(n_pass):
        prev = d
        dt = d.t().contiguous()
        dt = _minplus_scan(dt, lo_down, 1, False)
        dt = _minplus_scan(dt, lo_up, 1, True)
        d = dt.t().contiguous()
        d = _minplus_scan(d, lo_right, 1, False)
        d = _minplus_scan(d, lo_left, 1, True)
        d = torch.where(node & (d < sentinel), d, unreach)
        _tally(stats, "scan_cells", node.sum())
        if not bool((d < prev).any()):
            break
    return d


def _dist_to_sink_scan(caps, demand, node, n_pass: int, stats=None):
    """BFS distance to the nearest sink-demand node by _relax_scan.
    Distances are exact small integers, carried as int64 with a sentinel
    above every reachable distance for INF."""
    H, W = demand.shape
    sentinel = H * W + H + W + 1
    unreach = torch.full(demand.shape, sentinel, dtype=torch.int64,
                         device=demand.device)
    d = torch.where(demand & node, torch.zeros_like(unreach), unreach)
    d = _relax_scan(caps, d, node, n_pass, sentinel, stats)
    return torch.where(d < sentinel, d.to(torch.float32),
                       torch.full_like(caps[0], _INF))


# sweeps of _dist_to_sink between two host reads of its predicate
_SWEEP_READ_EVERY = 8


def _dist_to_sink(caps, demand, node, n_sweep: int, shift=_shift,
                  gany=None):
    """BFS distance to the nearest sink-demand node by lock-step sweeps
    (port of the JAX package's _dist_to_sink): each sweep relaxes every
    cell from its 4 neighbours, d[p] = min(d[p], d[q] + 1) over residual
    edges p -> q, restricted to the node set, until a sweep changes
    nothing or ``n_sweep`` sweeps ran. ``shift`` and ``gany`` supply the
    neighbour access and the any-over-the-grid of the loop predicate, so
    the column-sharded solver (parallel/dist_mincut.py) runs it with halo
    exchanges and an all_reduce. The host reads the predicate of the last
    sweep of every _SWEEP_READ_EVERY: a sweep after the fixpoint changes
    nothing, so the distances are the same as with a read every sweep.
    Same fixpoint as _dist_to_sink_scan, float32 distances, _INF where a
    node reaches no sink."""
    gany = gany or (lambda b: b)
    inf = torch.full_like(caps[0], _INF)
    d = torch.where(demand & node, torch.zeros_like(inf), inf)
    it = 0
    while it < n_sweep:
        for _ in range(min(_SWEEP_READ_EVERY, n_sweep - it)):
            prev = d
            best = d
            for k, (dy, dx) in enumerate(_DIRS):
                cand = torch.where(caps[k] > 0, shift(d, dy, dx, _INF) + 1.0,
                                   inf)
                best = torch.minimum(best, cand)
            d = torch.where(node, best, inf)
            it += 1
        if not bool(gany((d < prev).any())):
            break
    return d


def _init_state(cap_h, cap_v, excess0, node, shift=_shift):
    """Residual capacities and clipped excess of the seam graph
    (maxflow.py:164-183): caps[k][p] = residual capacity from p toward
    its k-neighbour, t-links clamped to the incident capacity sum + 1."""
    nodef = node.to(torch.float32)
    cap_h = cap_h.to(torch.float32) * nodef * shift(nodef, 0, 1, 0.0)
    cap_v = cap_v.to(torch.float32) * nodef * shift(nodef, 1, 0, 0.0)
    caps = [cap_h, shift(cap_h, 0, -1, 0.0),
            cap_v, shift(cap_v, -1, 0, 0.0)]
    e = torch.where(node, excess0.to(torch.float32),
                    torch.zeros_like(cap_h))
    cap_sum = caps[0] + caps[1] + caps[2] + caps[3] + 1.0
    return caps, torch.minimum(torch.maximum(e, -cap_sum), cap_sum)


def _push_phase(caps, e, h, interior=None, shift=_shift):
    """One push/relabel phase (the 4 push sub-steps, each lock-step, then
    the relabel); ``caps`` is updated in place, (e, h) returned. With
    ``interior``, only those cells push or lift (a row tile of the tiled
    solver, maxflow.py:591-607); the others only receive. ``shift``
    supplies the neighbour values (halo exchanges when sharded)."""
    zero = torch.zeros_like(e)
    inf = torch.full_like(e, _INF)
    # h is unchanged by the pushes: the shifted heights and the "exactly
    # one lower" tests serve every push sub-step and the relabel
    h_nb = [shift(h, dy, dx, _INF) for dy, dx in _DIRS]
    lower = [h == nb + 1.0 for nb in h_nb]
    for k, (dy, dx) in enumerate(_DIRS):
        admissible = (e > 0) & lower[k] & (caps[k] > 0)
        if interior is not None:
            admissible &= interior
        flow = torch.where(admissible, torch.minimum(e, caps[k]), zero)
        caps[k] = caps[k] - flow
        back = shift(flow, -dy, -dx, 0.0)
        caps[_REV[k]] = caps[_REV[k]] + back
        e = e - flow + back
    min_h = inf
    adm = torch.zeros(e.shape, dtype=torch.bool, device=e.device)
    for k in range(4):
        has_cap = caps[k] > 0
        min_h = torch.minimum(min_h, torch.where(has_cap, h_nb[k], inf))
        adm |= has_cap & lower[k]
    lift = (e > 0) & (~adm) & (min_h < _INF)
    if interior is not None:
        lift &= interior
    return e, torch.where(lift, min_h + 1.0, h)


def _mincut_core(cap_h, cap_v, excess0, node, max_outer: int,
                 inner_iters: int, sweep_iters: int, shift=_shift,
                 gany=None, stats=None) -> torch.Tensor:
    """Solver core shared by the single-device and the column-sharded
    variants (port of the JAX package's _mincut_core): ``shift`` supplies
    neighbour values (with halo exchanges when the grid is sharded) and
    ``gany`` reduces loop predicates over the whole grid. The identity
    pair takes the scan BFS (_dist_to_sink_scan), any other the sweep BFS
    (_dist_to_sink), whose shifts reach one cell; both reach the same
    distances. The outer while_loop is a Python loop with one host read
    per round."""
    gany_ = gany or (lambda b: b)
    node = node.to(torch.bool)
    caps, e = _init_state(cap_h, cap_v, excess0, node, shift)

    if shift is _shift:
        def bfs():
            return _dist_to_sink_scan(caps, e < 0, node, sweep_iters, stats)
    else:
        def bfs():
            return _dist_to_sink(caps, e < 0, node, sweep_iters, shift,
                                 gany)

    d = bfs()
    it = 0
    while it < max_outer and bool(gany_(((e > 0) & (d < _INF)).any())):
        h = d
        for _ in range(inner_iters):
            _tally(stats, "push_cells", ((e > 0) & node).sum())
            e, h = _push_phase(caps, e, h, shift=shift)
        d = bfs()
        it += 1
    _finish_stats(stats, it)
    return (d >= _INF) & node


def grid_mincut_ref(cap_h: torch.Tensor, cap_v: torch.Tensor,
                    excess0: torch.Tensor, node: torch.Tensor,
                    max_outer: int = 400, inner_iters: int = 30,
                    sweep_iters: int = 0, stats=None) -> torch.Tensor:
    """Plain PyTorch solver: _mincut_core with the scan BFS and the
    identity shift and any.

    With a dict ``stats`` it also counts the work these inputs needed:
    ``outer`` rounds, ``push_cells`` (node cells holding positive excess
    at the start of each push phase, the ones that push or relabel) and
    ``scan_cells`` (node cells of every BFS scan pass)."""
    H, W = cap_h.shape
    if sweep_iters <= 0:
        sweep_iters = H + W + 4
    return _mincut_core(cap_h, cap_v, excess0, node, max_outer, inner_iters,
                        sweep_iters, stats=stats)


def _finish_stats(stats, outer: int):
    """The plain solvers' stats as host ints."""
    if stats is not None:
        stats["outer"] = outer
        for k in ("push_cells", "scan_cells"):
            stats[k] = int(stats.get(k, 0))


def grid_mincut_tiled_ref(cap_h: torch.Tensor, cap_v: torch.Tensor,
                          excess0: torch.Tensor, node: torch.Tensor,
                          max_outer: int = 400, inner_iters: int = 30,
                          sweep_iters: int = 0,
                          tile_rows: int = 512, stats=None) -> torch.Tensor:
    """Plain PyTorch version of the row-tiled solver (the TPU kernel
    _mincut_tiled_kernel, maxflow.py:411-663, as grid_mincut_pallas_tiled
    calls it). The state lives in whole-grid planes with 8 guard rows
    above and below; row tiles of ``tile_rows`` rows (8-aligned, as
    maxflow.py:677) are worked one after another, which makes cross-tile
    flow exact:

    * a push phase visits tiles 0..T-1; a tile with no positive interior
      excess is skipped (the peek, :569-580); an active tile pushes and
      relabels its interior only, and its flow lands in the rows just
      outside it, the neighbour tiles' edge rows (:582-613);
    * the BFS seeds the sinks, then runs rounds over all tiles in
      alternating down/up order until a round changes nothing (:526-561);
      a tile scans its view with 8 halo rows each side to a local
      fixpoint and keeps its interior rows;
    * the outer loop ends when no node with positive excess reaches a
      sink (:616-650); the side is the set of nodes that cannot (:653).

    The TPU's 128-column padding serves only Mosaic's layout (padded
    columns are not nodes) and is left out. One host sync per tile peek
    and per BFS pass. ``stats`` as grid_mincut_ref: a skipped tile pushes
    no cell, and a tile's scans count the node cells of its view."""
    H, W = cap_h.shape
    Tr = min(tile_rows, (H + 7) // 8 * 8)
    T = (H + Tr - 1) // Tr
    H2 = T * Tr + 16
    if sweep_iters <= 0:
        sweep_iters = H + W + 4
    dev = cap_h.device

    def pad(x, dtype):
        out = torch.zeros((H2, W), dtype=dtype, device=dev)
        out[8:8 + H] = x
        return out

    node_p = pad(node.to(torch.bool), torch.bool)
    caps, e = _init_state(pad(cap_h, torch.float32),
                          pad(cap_v, torch.float32),
                          pad(excess0, torch.float32), node_p)
    d = torch.full((H2, W), _INF, dtype=torch.float32, device=dev)
    sentinel = H2 * W + H2 + W + 1

    def bfs_tile(t) -> bool:
        v0, v1 = t * Tr, t * Tr + Tr + 16
        nd = node_p[v0:v1]
        dv = torch.where(nd, d[v0:v1], torch.full_like(d[v0:v1], _INF))
        dv = torch.minimum(dv, torch.where((e[v0:v1] < 0) & nd,
                                           torch.zeros_like(dv), dv))
        di = torch.where(dv < _INF, dv.to(torch.int64),
                         torch.full(dv.shape, sentinel, dtype=torch.int64,
                                    device=dev))
        di = _relax_scan([c[v0:v1] for c in caps], di, nd, sweep_iters,
                         sentinel, stats)
        out = torch.where(di < sentinel, di.to(torch.float32),
                          torch.full_like(dv, _INF))
        d[v0 + 8:v0 + 8 + Tr] = out[8:8 + Tr]
        return bool((out < dv).any())

    def bfs():
        d.copy_(torch.where((e < 0) & node_p, torch.zeros_like(d),
                            torch.full_like(d, _INF)))
        rnd, changed = 0, True
        while rnd < sweep_iters and changed:
            order = range(T) if rnd % 2 == 0 else range(T - 1, -1, -1)
            changed = False
            for t in order:
                changed |= bfs_tile(t)
            rnd += 1

    interior = torch.zeros((Tr + 2, 1), dtype=torch.bool, device=dev)
    interior[1:Tr + 1] = True

    def push_tile(t):
        r0 = t * Tr + 8
        n_active = ((e[r0:r0 + Tr] > 0) & node_p[r0:r0 + Tr]).sum()
        if not bool(n_active):
            return
        _tally(stats, "push_cells", n_active)
        # the interior and one row each side: flow from the interior only
        # reaches the first halo row, the other halo rows stay unchanged
        s0, s1 = r0 - 1, r0 + Tr + 1
        cs = [c[s0:s1] for c in caps]
        es, hs = _push_phase(cs, e[s0:s1], d[s0:s1], interior)
        for c, cn in zip(caps, cs):
            c[s0:s1] = cn
        e[s0:s1] = es
        d[s0:s1] = hs

    def work_left():
        return bool(((e > 0) & (d < _INF) & node_p).any())

    bfs()
    it = 0
    while it < max_outer and work_left():
        for _ in range(inner_iters):
            for t in range(T):
                push_tile(t)
        bfs()
        it += 1
    _finish_stats(stats, it)
    return ((d >= _INF) & node_p)[8:8 + H]


def cut_value(cap_h, cap_v, excess0, node, side) -> float:
    """Cost of the cut that ``side`` (True = source side) induces, summed
    in float64 on the host: the cut n-links between node cells plus the
    t-links cut by the labeling (a source cell on the sink side pays its
    positive excess, a sink cell on the source side its negative one).
    Arrays or tensors of shape (H, W); the min cut minimises this."""
    def host(a, dtype):
        return np.asarray(a.cpu() if torch.is_tensor(a) else a, dtype)
    wh, wv, exc = (host(a, np.float64) for a in (cap_h, cap_v, excess0))
    node, side = host(node, bool), host(side, bool)
    S = side & node
    T = (~side) & node
    ch = ((S[:, :-1] & T[:, 1:]) | (T[:, :-1] & S[:, 1:])) \
        & node[:, :-1] & node[:, 1:]
    cv = ((S[:-1] & T[1:]) | (T[:-1] & S[1:])) & node[:-1] & node[1:]
    return float(wh[:, :-1][ch].sum() + wv[:-1][cv].sum()
                 + np.where(T, np.maximum(exc, 0), 0).sum()
                 + np.where(S, np.maximum(-exc, 0), 0).sum())


# kernel -> (library, source under csrc/, C entry point); both entry
# points take the same arguments
_KERNELS = {
    "grid_mincut": ("spt_mincut", "mincut.cu", "spt_grid_mincut"),
    "grid_mincut_tiled": ("spt_mincut_tiled", "mincut_tiled.cu",
                          "spt_grid_mincut_tiled"),
}
_ENTRY = {}

# the solvers' counters, in the order of the C entry points' stats
_STATS = ("outer", "bfs_rounds", "launches", "host_reads", "push_tiles",
          "resident", "push_ns", "bfs_ns", "bfs_levels")


def build(kernel: str = "grid_mincut", rebuild: bool = False) -> float:
    """Build (or reuse, unless ``rebuild``) the kernel's CUDA source;
    returns the seconds spent building in this process."""
    from simplepanorama_tpu_torch.utils.nvcc import load_library
    lib_name, source, entry = _KERNELS[kernel]
    lib, seconds = load_library(lib_name, [source], rebuild=rebuild)
    if kernel not in _ENTRY:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        lib.spt_work_floats.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.spt_work_floats.restype = ctypes.c_longlong
        lib.spt_error_string.argtypes = [ctypes.c_int]
        lib.spt_error_string.restype = ctypes.c_char_p
        _ENTRY[kernel] = (fn, lib.spt_work_floats, lib.spt_error_string)
    return seconds


def _check(cap_h, cap_v, excess0, node):
    if cap_h.dim() != 2:
        raise ValueError(f"grid_mincut wants (H, W) planes, got {tuple(cap_h.shape)}")
    for name, t in (("cap_h", cap_h), ("cap_v", cap_v),
                    ("excess0", excess0), ("node", node)):
        if t.shape != cap_h.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(cap_h.shape)}")
        if t.device != cap_h.device:
            raise ValueError(f"{name} is on {t.device}, cap_h on {cap_h.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        want = torch.bool if name == "node" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
    if cap_h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_mincut runs on cpu or cuda, not {cap_h.device}")


def _launch(kernel, cap_h, cap_v, excess0, node, max_outer, inner_iters,
            sweep_iters, dist=False):
    """Run one CUDA solver; returns (side, the distances of its last BFS
    when ``dist``, else None, its stats as a dict)."""
    build(kernel)
    fn, work_floats, err = _ENTRY[kernel]
    H, W = cap_h.shape
    dev = cap_h.device
    side = torch.empty((H, W), dtype=torch.bool, device=dev)
    d = torch.empty((H, W), dtype=torch.float32, device=dev) if dist else None
    work = torch.empty(int(work_floats(H, W)), dtype=torch.float32,
                       device=dev)
    flags = torch.zeros(12, dtype=torch.int32, device=dev)
    stats = (ctypes.c_longlong * len(_STATS))()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(cap_h.data_ptr(), cap_v.data_ptr(), excess0.data_ptr(),
                node.data_ptr(), side.data_ptr(),
                d.data_ptr() if dist else None, work.data_ptr(),
                flags.data_ptr(), H, W, max_outer, inner_iters, sweep_iters,
                stream, stats)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel failed: " + err(rc).decode())
    return side, d, dict(zip(_STATS, stats))


def grid_mincut(cap_h: torch.Tensor, cap_v: torch.Tensor,
                excess0: torch.Tensor, node: torch.Tensor,
                max_outer: int = 400, inner_iters: int = 30,
                sweep_iters: int = 0) -> torch.Tensor:
    """Min cut of the seam grid (port of grid_mincut / grid_mincut_pallas).

    cap_h: (H, W) float32 capacity between (y, x) and (y, x+1);
    cap_v: (H, W) float32 capacity between (y, x) and (y+1, x);
    excess0: float32 signed t-link excess (+source, -sink);
    node: bool validity mask. All contiguous, on one device.

    Returns the (H, W) bool source side. CPU tensors run grid_mincut_ref;
    CUDA tensors launch csrc/mincut.cu and count the launch in
    ``grid_mincut.launches``; ``grid_mincut.last_stats`` holds the counters
    of the last solve on the card (outer rounds, BFS rounds, launches,
    host reads, push tiles worked by the tiled route, ``resident``: 1
    when the grid's tiles stayed in shared memory, 0 when it took the
    tiled route, the device nanoseconds of the push blocks and of the
    BFSs, read from the device clock at grid barriers, and the BFS levels
    run, summed over tiles and rounds)."""
    _check(cap_h, cap_v, excess0, node)
    H, W = cap_h.shape
    if sweep_iters <= 0:
        sweep_iters = H + W + 4   # grid diameter bounds every BFS
    if cap_h.device.type == "cpu":
        return grid_mincut_ref(cap_h, cap_v, excess0, node, max_outer,
                               inner_iters, sweep_iters)
    side, _, stats = _launch("grid_mincut", cap_h, cap_v, excess0, node,
                             max_outer, inner_iters, sweep_iters)
    count_launches(grid_mincut)
    grid_mincut.last_stats = stats
    return side


grid_mincut.launches = 0
grid_mincut.last_stats = None


def grid_mincut_tiled(cap_h: torch.Tensor, cap_v: torch.Tensor,
                      excess0: torch.Tensor, node: torch.Tensor,
                      max_outer: int = 400, inner_iters: int = 30,
                      sweep_iters: int = 0) -> torch.Tensor:
    """The tiled min cut (port of grid_mincut_pallas_tiled as
    grid_mincut_auto calls it), same inputs and output as grid_mincut.
    CPU tensors run grid_mincut_tiled_ref (row tiles of 512, as the JAX
    package); CUDA tensors launch csrc/mincut_tiled.cu, whose 2-D tiles
    (16x128 for the pushes, 128x128 for the BFS) and 5 push phases per
    tile visit are fixed by its source, and count the launch in
    ``grid_mincut_tiled.launches``. ``last_stats`` holds the counters of
    the last solve on the card, as grid_mincut's."""
    _check(cap_h, cap_v, excess0, node)
    H, W = cap_h.shape
    if sweep_iters <= 0:
        sweep_iters = H + W + 4
    if cap_h.device.type == "cpu":
        return grid_mincut_tiled_ref(cap_h, cap_v, excess0, node, max_outer,
                                     inner_iters, sweep_iters)
    side, _, stats = _launch("grid_mincut_tiled", cap_h, cap_v, excess0,
                             node, max_outer, inner_iters, sweep_iters)
    count_launches(grid_mincut_tiled)
    grid_mincut_tiled.last_stats = stats
    return side


grid_mincut_tiled.launches = 0
grid_mincut_tiled.last_stats = None


def dist_to_sink(cap_h: torch.Tensor, cap_v: torch.Tensor,
                 excess0: torch.Tensor, node: torch.Tensor,
                 kernel: str = "grid_mincut_tiled") -> torch.Tensor:
    """The first global-relabel BFS of a solve: (H, W) float32 distances
    to the nearest sink (node with negative clipped excess) through
    positive residual edges of the initial graph, 1e18 where there is
    none; same inputs as grid_mincut. CPU tensors run _dist_to_sink_scan
    to its fixpoint; CUDA tensors run the bit-parallel tile BFS of
    ``kernel`` (csrc/mincut_bfs.cuh, driven by csrc/mincut.cu or
    csrc/mincut_tiled.cu) to its fixpoint, which gives the same integers.
    Not counted in the solvers' launches."""
    _check(cap_h, cap_v, excess0, node)
    H, W = cap_h.shape
    if cap_h.device.type == "cpu":
        caps, e = _init_state(cap_h, cap_v, excess0, node)
        return _dist_to_sink_scan(caps, e < 0, node, H * W + 1)
    return _launch(kernel, cap_h, cap_v, excess0, node, 0, 0, H * W + 1,
                   dist=True)[1]

# Largest grid the whole-grid solver takes: the JAX package's
# _PALLAS_MAX_CELLS (maxflow.py:361). Measured on an H100 80GB HBM3 at
# 700 W on seam blocks (PERF.md): kernel 1 keeps its tiles resident in
# shared memory up to ~0.8-0.9M cells and beats kernel 2 there by
# 1.19-1.34x; above that it takes kernel 2's tiled route and times the
# same, so where between 0.8M and 1.2M the switch sits changes nothing.
WHOLE_GRID_MAX_CELLS = 1_200_000


def grid_mincut_auto(cap_h, cap_v, excess0, node, **kw):
    """The solver the seam graph cut calls, dispatched as the traced
    branch of the JAX package's grid_mincut_auto (maxflow.py:753, :777):
    on H*W alone, with no bounding-box crop. At or under
    WHOLE_GRID_MAX_CELLS the whole-grid solver (kernel 1 on the card,
    grid_mincut_ref on the CPU); over it the tiled one (kernel 2,
    grid_mincut_tiled_ref)."""
    H, W = cap_h.shape
    if H * W <= WHOLE_GRID_MAX_CELLS:
        return grid_mincut(cap_h, cap_v, excess0, node, **kw)
    return grid_mincut_tiled(cap_h, cap_v, excess0, node, **kw)
