"""Min-cut of a 4-connected seam grid: lock-step push-relabel.

Port of simplepanorama_tpu/ops/maxflow.py. Graph encoding and algorithm
are the same: t-links are folded into a signed excess (e = cap_source -
cap_sink); every push/relabel phase is a lock-step (H, W) update with
4-neighbour shifts; one global-relabel BFS per outer round (distance to
the nearest sink through positive residual edges, computed by directional
min-plus scans) gives the next heights and the termination test. The
source side of the cut is the set of nodes that cannot reach a sink.

Two implementations of one function:

* ``grid_mincut_ref`` — plain PyTorch, a line-for-line port of
  ``_mincut_core`` + ``_dist_to_sink_scan``. It defines the semantics and
  runs on any device.
* ``csrc/mincut.cu`` — the hand-written CUDA kernel for Hopper that
  replaces the TPU Pallas kernel ``_mincut_kernel``.

``grid_mincut`` dispatches on where its tensors live: CPU tensors take the
plain version; CUDA tensors launch the kernel (built with nvcc at first
use) or raise. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

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


def _scan_offsets(open_, dim: int, reverse: bool):
    """Offsets of one scan direction for _minplus_scan. Each run of open
    steps is a segment; the offset is p + seg(p) * big, so every later
    segment sits above anything before it and the cummin cannot reach
    across a closed step. Built once per BFS: the open steps do not
    change while it runs."""
    if reverse:
        open_ = open_.flip(dim)
    n = open_.shape[dim]
    shape = [1, 1]
    shape[dim] = n
    idx = torch.arange(n, device=open_.device).view(shape)
    seg = torch.cumsum((~open_).to(torch.int64), dim)
    return idx + seg * (4 * open_.numel() + 4 * n)


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


def _dist_to_sink_scan(caps, demand, node, n_pass: int):
    """BFS distance to the nearest sink-demand node: passes of
    down/up/right/left min-plus scans until nothing changes (one host
    sync per pass). Distances are exact small integers, carried as int64
    with a sentinel above every reachable distance for INF."""
    H, W = demand.shape
    sentinel = H * W + H + W + 1
    # a step into p from its predecessor is open iff p can push back
    # toward the predecessor (residual capacity of the reverse direction)
    open_down, open_up = caps[3] > 0, caps[2] > 0
    open_right, open_left = caps[1] > 0, caps[0] > 0
    unreach = torch.full(demand.shape, sentinel, dtype=torch.int64,
                         device=demand.device)
    d = torch.where(demand & node, torch.zeros_like(unreach), unreach)
    # column scans run on a transposed copy, so every scan is along the
    # contiguous dim
    lo_down = _scan_offsets(open_down.t().contiguous(), 1, False)
    lo_up = _scan_offsets(open_up.t().contiguous(), 1, True)
    lo_right = _scan_offsets(open_right, 1, False)
    lo_left = _scan_offsets(open_left, 1, True)
    for _ in range(n_pass):
        prev = d
        dt = d.t().contiguous()
        dt = _minplus_scan(dt, lo_down, 1, False)
        dt = _minplus_scan(dt, lo_up, 1, True)
        d = dt.t().contiguous()
        d = _minplus_scan(d, lo_right, 1, False)
        d = _minplus_scan(d, lo_left, 1, True)
        d = torch.where(node & (d < sentinel), d, unreach)
        if not bool((d < prev).any()):
            break
    return torch.where(d < sentinel, d.to(torch.float32),
                       torch.full_like(caps[0], _INF))


def grid_mincut_ref(cap_h: torch.Tensor, cap_v: torch.Tensor,
                    excess0: torch.Tensor, node: torch.Tensor,
                    max_outer: int = 400, inner_iters: int = 30,
                    sweep_iters: int = 0) -> torch.Tensor:
    """Plain PyTorch solver (port of _mincut_core with the scan BFS).
    The outer while_loop is a Python loop with one host sync per round."""
    H, W = cap_h.shape
    if sweep_iters <= 0:
        sweep_iters = H + W + 4
    node = node.to(torch.bool)
    nodef = node.to(torch.float32)
    cap_h = cap_h.to(torch.float32) * nodef * _shift(nodef, 0, 1, 0.0)
    cap_v = cap_v.to(torch.float32) * nodef * _shift(nodef, 1, 0, 0.0)
    # caps[k][p] = residual capacity from p toward its k-neighbour
    caps = [cap_h, _shift(cap_h, 0, -1, 0.0),
            cap_v, _shift(cap_v, -1, 0, 0.0)]
    e = torch.where(node, excess0.to(torch.float32),
                    torch.zeros_like(cap_h))
    # clamp t-links to the incident capacity sum + 1 (maxflow.py:177-183)
    cap_sum = caps[0] + caps[1] + caps[2] + caps[3] + 1.0
    e = torch.minimum(torch.maximum(e, -cap_sum), cap_sum)
    zero = torch.zeros_like(e)
    inf = torch.full_like(e, _INF)

    def push_phase(e, h):
        # h is unchanged by the pushes: the shifted heights and the
        # "exactly one lower" tests serve every push sub-step and the
        # relabel
        h_nb = [_shift(h, dy, dx, _INF) for dy, dx in _DIRS]
        lower = [h == nb + 1.0 for nb in h_nb]
        for k, (dy, dx) in enumerate(_DIRS):
            admissible = (e > 0) & lower[k] & (caps[k] > 0)
            flow = torch.where(admissible, torch.minimum(e, caps[k]), zero)
            caps[k] = caps[k] - flow
            back = _shift(flow, -dy, -dx, 0.0)
            caps[_REV[k]] = caps[_REV[k]] + back
            e = e - flow + back
        min_h = inf
        adm = torch.zeros_like(node)
        for k in range(4):
            has_cap = caps[k] > 0
            min_h = torch.minimum(min_h, torch.where(has_cap, h_nb[k], inf))
            adm |= has_cap & lower[k]
        lift = (e > 0) & (~adm) & (min_h < _INF)
        return e, torch.where(lift, min_h + 1.0, h)

    def bfs():
        return _dist_to_sink_scan(caps, e < 0, node, sweep_iters)

    d = bfs()
    it = 0
    while it < max_outer and bool(((e > 0) & (d < _INF)).any()):
        h = d
        for _ in range(inner_iters):
            e, h = push_phase(e, h)
        d = bfs()
        it += 1
    return (d >= _INF) & node


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


_LIB = None


def build(rebuild: bool = False) -> float:
    """Build (or reuse, unless ``rebuild``) csrc/mincut.cu; returns the
    seconds spent building in this process."""
    global _LIB
    from simplepanorama_tpu_torch.utils.nvcc import load_library
    lib, seconds = load_library("spt_mincut", ["mincut.cu"], rebuild=rebuild)
    if _LIB is None:
        lib.spt_grid_mincut.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_longlong)]
        lib.spt_grid_mincut.restype = ctypes.c_int
        lib.spt_error_string.argtypes = [ctypes.c_int]
        lib.spt_error_string.restype = ctypes.c_char_p
        _LIB = lib
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
    ``grid_mincut.launches``."""
    _check(cap_h, cap_v, excess0, node)
    H, W = cap_h.shape
    if sweep_iters <= 0:
        sweep_iters = H + W + 4   # grid diameter bounds every BFS
    dev = cap_h.device
    if dev.type == "cpu":
        return grid_mincut_ref(cap_h, cap_v, excess0, node, max_outer,
                               inner_iters, sweep_iters)
    if dev.type != "cuda":
        raise ValueError(f"grid_mincut runs on cpu or cuda, not {dev}")
    build()
    side = torch.empty((H, W), dtype=torch.bool, device=dev)
    work = torch.empty((13, H, W), dtype=torch.float32, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)
    stats = (ctypes.c_longlong * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _LIB.spt_grid_mincut(
            cap_h.data_ptr(), cap_v.data_ptr(), excess0.data_ptr(),
            node.data_ptr(), side.data_ptr(), work.data_ptr(),
            flags.data_ptr(), H, W, max_outer, inner_iters, sweep_iters,
            stream, stats)
    if rc != 0:
        raise RuntimeError("mincut kernel failed: "
                           + _LIB.spt_error_string(rc).decode())
    grid_mincut.launches += 1
    grid_mincut.last_stats = {"outer": stats[0], "bfs_passes": stats[1],
                              "kernels": stats[2]}
    return side


grid_mincut.launches = 0
grid_mincut.last_stats = None


def grid_mincut_auto(cap_h, cap_v, excess0, node, **kw):
    """The solver the seam graph-cut calls. On the card the solver state
    sits in device memory at every size, so there is no size dispatch
    (the TPU package picks between an in-VMEM and a row-tiled kernel)."""
    return grid_mincut(cap_h, cap_v, excess0, node, **kw)
