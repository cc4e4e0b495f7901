"""Incremental bundle-adjustment stitching.

Port of simplepanorama_tpu/stitch.py (stch::bundleadjust_stitching of the
reference): nodes are added in greedy strongest-edge order; each new
camera inherits its connection's focal with the principal point zeroed
and a rotation initialized from the pairwise RANSAC homography (nearest
rotation to K_new^-1 H K_conn, times R_conn); after every addition a full
LM bundle adjustment runs over all cameras added so far; finally the
principal points are shifted by the integer image half-sizes.

Cameras are renumbered into addition order and matches sorted by
activation step, so the live subproblem after addition l is a prefix of
the padded tables. The schedule is split into equal-work chunks, each run
at a cropped capacity bucket (matches rounded to 2048, cameras to 8) —
the JAX package's bucket plan. Each chunk's LM runs go through its
bucket's ba.LMProgram, which ba lends (ba.chunk_programs) and which reads
the termination flag every few trials; on the card its trial is one CUDA
graph, replayed: the counterpart of the JAX package's one compiled
program per chunk; on one card a trial is three kernels
(ba.fused_trial). As the JAX package's jit cache keeps that program for
the process, ba.program keeps the graph: a later stitch whose bucket has
the same shapes loads its match tables into it and replays, capturing
nothing (ba.release_programs() drops them all); a chunk holds its
program's lock, so stitches in several threads stay apart. In a world
of several ranks the matches of every chunk are split across the ranks
(parallel.dist_ba), and on the card the bucket's graph holds the trial's
all_reduces too; such graphs live for one call. The additions themselves
(the rotation init's SVD) run eagerly, once each.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from simplepanorama_tpu_torch import ba
from simplepanorama_tpu_torch.adjacency import Adjacency
from simplepanorama_tpu_torch.config import Config
from simplepanorama_tpu_torch.geometry import rotation as rotn
from simplepanorama_tpu_torch.geometry.graph import (
    Component, order_nodes_by_connection)
from simplepanorama_tpu_torch.utils.device import checked_device
from simplepanorama_tpu_torch.utils.timing import global_timer, span


@dataclasses.dataclass
class StitchResult:
    """Post-BA state (stch::stitch_result), component-local indexing."""
    rot: np.ndarray            # (n, 3, 3)
    K: np.ndarray              # (n, 3, 3), centers shifted by half-size
    adj: np.ndarray            # (n, n) upper-tri weights
    connectivity: np.ndarray   # (n,)
    order: List[Tuple[int, int]]  # [(node, connected_to)] local indices
    nodes: List[int]           # local -> global image index
    center: int                # best-connected local node
    sizes: List[Tuple[int, int]]  # (h, w) per local node


def _ba_mesh(mesh, n_matches: int):
    """The mesh the BA splits ``n_matches`` matches over, or None (the
    single-device BA): a world of two or more ranks splits them whenever
    the count divides, as the JAX package's stitch does."""
    if mesh is None or mesh.size < 2 or n_matches % mesh.size:
        return None
    return mesh


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def build_ba_data(comp: Component, adjres: Adjacency, device="cuda",
                  cap_round: int = 512,
                  order: Optional[List[Tuple[int, int]]] = None,
                  relabel: Optional[np.ndarray] = None,
                  ) -> Tuple[ba.BAData, Optional[np.ndarray]]:
    """Flatten the component's directed cleaned matches into padded
    tables on ``device``; with ``order``, matches are sorted by activation
    step and prefix[l] = matches active after addition l."""
    device = checked_device(device)
    nodes = comp.nodes
    g2l = {g: l for l, g in enumerate(nodes)}
    mi, mj, q, t, step = [], [], [], [], []
    add_idx = None
    if order is not None:
        add_idx = {node: l for l, (node, _) in enumerate(order)}
    for (gi, gj), (xy_i, xy_j) in adjres.matches.items():
        if gi in g2l and gj in g2l:
            li, lj = g2l[gi], g2l[gj]
            mi.extend([li] * len(xy_i))
            mj.extend([lj] * len(xy_i))
            q.append(xy_i)
            t.append(xy_j)
            if add_idx is not None:
                s = max(add_idx.get(li, len(order)),
                        add_idx.get(lj, len(order)))
                step.extend([s] * len(xy_i))
    M = len(mi)
    mi_np = np.asarray(mi, np.int64)
    mj_np = np.asarray(mj, np.int64)
    q_np = np.concatenate(q).astype(np.float32) if M else np.zeros((0, 2), np.float32)
    t_np = np.concatenate(t).astype(np.float32) if M else np.zeros((0, 2), np.float32)
    prefix = None
    if add_idx is not None and M:
        step_np = np.asarray(step, np.int64)
        srt = np.argsort(step_np, kind="stable")
        mi_np, mj_np = mi_np[srt], mj_np[srt]
        q_np, t_np = q_np[srt], t_np[srt]
        prefix = np.searchsorted(step_np[srt], np.arange(len(order)),
                                 side="right")
    if relabel is not None and M:
        mi_np = relabel[mi_np].astype(np.int64)
        mj_np = relabel[mj_np].astype(np.int64)
    cap = max(cap_round, _round_up(M, cap_round))
    mi_a = np.zeros(cap, np.int64)
    mj_a = np.zeros(cap, np.int64)
    q_a = np.zeros((cap, 2), np.float32)
    t_a = np.zeros((cap, 2), np.float32)
    valid = np.zeros(cap, bool)
    mp_a = np.zeros(cap, np.int64)
    if M:
        mi_a[:M], mj_a[:M], q_a[:M], t_a[:M] = mi_np, mj_np, q_np, t_np
        valid[:M] = True
        uniq, inv_rows = np.unique(np.stack([mi_np, mj_np], 1), axis=0,
                                   return_inverse=True)
        mp_a[:M] = inv_rows.reshape(-1)
    else:
        uniq = np.zeros((0, 2), np.int64)
    P = max(64, _round_up(len(uniq), 64))
    pi_a = np.zeros(P, np.int64)
    pj_a = np.zeros(P, np.int64)
    pi_a[:len(uniq)] = uniq[:, 0]
    pj_a[:len(uniq)] = uniq[:, 1]
    T = lambda a: torch.as_tensor(a, device=device)
    data = ba.BAData(mi=T(mi_a), mj=T(mj_a), q=T(q_a), t=T(t_a),
                     m_valid=T(valid), pi=T(pi_a), pj=T(pj_a), mp=T(mp_a))
    return data, prefix


def _chunk_plan(prefix: np.ndarray, L: int, n_pad: int, Mcap: int,
                m_round: int = 2048):
    """Equal-work chunks of additions [lo, hi) with their capacity buckets
    (n_cap, m_cap), as stitch.bundle_adjust_stitching plans them: matches
    rounded to ``m_round``, cameras to 8."""
    n_chunks = min(10, L - 1)
    w = prefix[1:L].astype(np.float64) + 3000.0
    cw = np.cumsum(w)
    bounds = [1]
    for c in range(1, n_chunks):
        t = np.searchsorted(cw, cw[-1] * c / n_chunks) + 1
        if t > bounds[-1] and t < L:
            bounds.append(int(t))
    bounds.append(L)
    chunks = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        n_cap = min(n_pad, _round_up(hi, 8))
        m_cap = min(Mcap, _round_up(max(int(prefix[hi - 1]), 1), m_round))
        chunks.append((lo, hi, n_cap, m_cap))
    return chunks


@span("ba.add_camera")
def _add_camera(cams: ba.CamState, l: int, conn: int, H_pair: torch.Tensor):
    """Activate camera l (addition order) from its connection: inherit the
    focal, zero principal point, rotation from the pairwise homography."""
    f = cams.focal[conn]
    Kc = ba._K_of(f, cams.ppal[conn])
    Kn_inv = torch.diag(torch.stack([1.0 / f, 1.0 / f, torch.ones_like(f)]))
    R_init = rotn.orthogonalize(Kn_inv @ H_pair @ Kc)
    R_conn = rotn.rodrigues(cams.rotvec[conn])
    rv = rotn.rotvec_from_matrix(R_init @ R_conn)
    focal = cams.focal.clone()
    ppal = cams.ppal.clone()
    rotvec = cams.rotvec.clone()
    focal[l] = f
    ppal[l] = 0.0
    rotvec[l] = rv
    return cams._replace(focal=focal, ppal=ppal, rotvec=rotvec)


def _shift_centers(K: np.ndarray, sizes, nodes) -> np.ndarray:
    Ks = K.copy()
    for l in range(len(nodes)):
        h, w = sizes[nodes[l]]
        Ks[l, 0, 2] += w // 2
        Ks[l, 1, 2] += h // 2
    return Ks


class LMCounts(NamedTuple):
    """What one chunk of the schedule ran."""
    runs: int                 # LM runs (one per addition)
    trials: torch.Tensor      # () trials of those runs, accepted or not
    accepted: torch.Tensor    # () accepted steps
    executed: int             # trials executed: the runs' trials, the
    #                           no-op ones after a run ended, the warm-up
    fused: int                # of those, trials run by kernels 4 and 5
    #                           (ba.fused_trial, a single-card program)
    reads: int                # host reads of the termination flag
    graphs: int               # trials captured as CUDA graphs in this
    #                           chunk (0 when its program was kept)
    capture_s: float          # host seconds spent capturing them
    error: torch.Tensor       # () the last run's error


def _lm_chunk(cams_c: ba.CamState, active_c: torch.Tensor,
              program: ba.LMProgram, lo: int, hi: int, order_conns, H_pair,
              vaug, lambda0: float):
    """Additions [lo, hi) of the schedule at one capacity bucket: each
    activates its camera (eagerly, with the SVD of its rotation init),
    then runs LM over the active set through ``program``, the bucket's
    ba.LMProgram. ``active_c`` is updated in place. Returns (cams,
    LMCounts); the counts stay on the device."""
    dev = cams_c.focal.device
    trials = torch.zeros((), dtype=torch.int64, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    executed = reads = graphs = fused = 0
    capture_s = 0.0
    error = torch.zeros((), dtype=torch.float32, device=dev)
    for l in range(lo, hi):
        cams_c = _add_camera(cams_c, l, order_conns[l], H_pair[l])
        active_c[l] = True
        fresh = program.graph is None
        res, n, r = program.run(cams_c, active_c, lambda0, int(vaug[l]))
        if fresh and program.graph is not None:
            graphs += 1
            capture_s += program.capture_s
        fused += n if program.trial_kernels else 0
        cams_c = res.cams
        error = res.error
        trials = trials + res.n_iter
        accepted = accepted + res.n_accepted
        executed += n
        reads += r
    return cams_c, LMCounts(runs=hi - lo, trials=trials, accepted=accepted,
                            executed=executed, fused=fused, reads=reads,
                            graphs=graphs,
                            capture_s=capture_s, error=error)


def bundle_adjust_stitching(comp: Component, adjres: Adjacency,
                            sizes: Sequence[Tuple[int, int]], focal: float,
                            cfg: Config,
                            progress: Optional[Callable[[float], None]] = None,
                            cancelled: Optional[Callable[[], bool]] = None,
                            device="cuda") -> StitchResult:
    """Run the incremental BA over one connected component; ``sizes`` are
    (h, w) of the global image list, ``focal`` the scene estimate.
    ``cfg.fast`` selects the Lowe objective. Each chunk of the schedule
    runs through the LMProgram of its bucket that ba.chunk_programs lends:
    on one card ba.program's kept program of the bucket's shapes, held by
    this thread for the chunk, loaded with this problem's match tables,
    its trial (kernels 4, 3 and 5, ba.fused_trial) captured as a CUDA
    graph only when the process has none yet (a chunk's LMCounts count
    the captures it made; the chunks' trials go to the timer's counters,
    ``_count_trials``); on the CPU a program of the chunk's own, whose
    trial is ba.lm_step. Progress and cancellation are per chunk.
    ``device`` is the card unless the caller asks for another.

    In a world of several ranks (parallel.mesh.pipeline_mesh) the matches
    of every chunk are split across the ranks, with the camera system and
    the trial error all-reduced (parallel.dist_ba): match capacity then
    rounds to 512 per rank, so every rank's share suits kernel 3, and b is
    gathered back after each chunk. On the card each bucket's sharded
    trial is one CUDA graph holding its all_reduces (ba.LMProgram with
    the mesh's group, closed when the call returns). Every rank ends with
    the same result."""
    from simplepanorama_tpu_torch.parallel.mesh import (
        pipeline_mesh, shard_matches, unshard_matches)
    device = checked_device(device)
    mesh = pipeline_mesh()
    world = 1 if mesh is None else mesh.size
    nodes = comp.nodes
    n = len(nodes)
    order = order_nodes_by_connection(comp.adj + comp.adj.T)
    center = int(np.argmax(comp.connectivity))
    rot = np.tile(np.eye(3), (n, 1, 1))
    K = np.tile(np.diag([focal, focal, 1.0]), (n, 1, 1))

    def result(K):
        return StitchResult(rot=rot, K=_shift_centers(K, sizes, nodes),
                            adj=comp.adj, connectivity=comp.connectivity,
                            order=order, nodes=nodes, center=center,
                            sizes=[sizes[g] for g in nodes])

    if n == 1 or len(order) < 2:
        return result(K)
    if cancelled is not None and cancelled():
        raise RuntimeError("Process canceled")

    L = len(order)
    in_order = [o[0] for o in order]
    seen = set(in_order)
    perm = np.array(in_order + [i for i in range(n) if i not in seen], np.int64)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)

    with span("ba.build_data"):
        data, prefix = build_ba_data(comp, adjres, device=device,
                                     order=order, relabel=inv,
                                     cap_round=512 * world)
    Mcap = int(data.mi.shape[0])
    mesh = _ba_mesh(mesh, Mcap)
    world = 1 if mesh is None else mesh.size
    if prefix is None:
        prefix = np.zeros(L, np.int64)
    order_conns = [int(inv[max(o[1], 0)]) for o in order]
    H_pair = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    for l in range(1, L):
        node, conn = order[l]
        H_pair[l] = adjres.hom_mat[nodes[conn], nodes[node]].astype(np.float32)
    H_pair = torch.as_tensor(H_pair, device=device)
    # V-augment quirk: the scaling focal belongs to the active camera with
    # the highest ORIGINAL local index, renumbered
    vaug = inv[np.maximum.accumulate(np.array(in_order))]
    n_pad = _round_up(n, 8)
    cams = ba.CamState(
        focal=torch.full((n_pad,), focal, dtype=torch.float32, device=device),
        ppal=torch.zeros((n_pad, 2), dtype=torch.float32, device=device),
        rotvec=torch.zeros((n_pad, 3), dtype=torch.float32, device=device),
        b=data.t.clone())
    active = torch.zeros(n_pad, dtype=torch.bool, device=device)
    active[0] = True
    chunk_counts = []
    m_round = int(np.lcm(2048, 512 * world))
    with ba.chunk_programs(None if mesh is None else mesh.group) \
            as program_of:
        for lo, hi, n_cap, m_cap in _chunk_plan(prefix, L, n_pad, Mcap,
                                                m_round):
            sl = lambda x: x[:m_cap]
            data_c = ba.BAData(mi=sl(data.mi), mj=sl(data.mj), q=sl(data.q),
                               t=sl(data.t), m_valid=sl(data.m_valid),
                               pi=data.pi, pj=data.pj, mp=sl(data.mp))
            cams_c = ba.CamState(cams.focal[:n_cap], cams.ppal[:n_cap],
                                 cams.rotvec[:n_cap], sl(cams.b))
            active_c = active[:n_cap].clone()
            if mesh is not None:
                data_c = shard_matches(data_c, mesh)
                cams_c = cams_c._replace(b=cams_c.b[mesh.rank::world])
            with program_of(data_c, n_cap, bool(cfg.fast)) as program:
                cams_c, counts = _lm_chunk(
                    cams_c, active_c, program, lo, hi, order_conns, H_pair,
                    vaug, float(cfg.lambda_))
            if counts is not None:
                chunk_counts.append(counts)
            if mesh is not None:
                cams_c = cams_c._replace(b=unshard_matches(cams_c.b, mesh))
            cams = ba.CamState(
                focal=torch.cat([cams_c.focal, cams.focal[n_cap:]]),
                ppal=torch.cat([cams_c.ppal, cams.ppal[n_cap:]]),
                rotvec=torch.cat([cams_c.rotvec, cams.rotvec[n_cap:]]),
                b=torch.cat([cams_c.b, cams.b[m_cap:]]))
            active[:n_cap] = active_c
            if progress is not None:
                progress((hi - lo) / (L - 1))
            if cancelled is not None and cancelled():
                raise RuntimeError("Process canceled")

    with span("ba.readback"):
        focal_new = cams.focal.cpu().double().numpy()
        ppal_new = cams.ppal.cpu().double().numpy()
        rv_new = cams.rotvec.cpu().double().numpy()
    _count_trials(chunk_counts)
    for l in range(L):   # addition order back to local ids
        i = int(perm[l])
        K[i] = np.array([[focal_new[l], 0, ppal_new[l, 0]],
                         [0, focal_new[l], ppal_new[l, 1]],
                         [0, 0, 1.0]])
        rot[i] = _rodrigues_np(rv_new[l])
    return result(K)


def _count_trials(chunk_counts: List[LMCounts]) -> None:
    """Add the chunks' trials to the counters ``ba.trials_executed``
    (executed, no-op and warm-up trials included), ``ba.fused_trials``
    (those run by kernels 4 and 5: every one on a single card) and
    ``ba.lm_trials`` (the runs' own trials): one read of the device's
    trial counts, after the readback has synced."""
    if not chunk_counts:
        return
    timer = global_timer()
    timer.add("ba.trials_executed", sum(c.executed for c in chunk_counts))
    timer.add("ba.fused_trials", sum(c.fused for c in chunk_counts))
    timer.add("ba.lm_trials",
              int(torch.stack([c.trials for c in chunk_counts]).sum()))


def _rodrigues_np(v: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(v)
    if th < 1e-10:
        return np.eye(3) + _skew(v)
    Kx = _skew(v / th)
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
