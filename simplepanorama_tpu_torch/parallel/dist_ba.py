"""Distributed bundle adjustment: the LM with its matches split across
ranks.

Port of simplepanorama_tpu/parallel/dist_ba.py. The Schur complement is
what makes this cheap: the per-match V blocks are 2x2 and local to the
rank holding the match, and only the 6N x 6N camera system is global.
Each rank sums its own matches' U, e_A, Y W^T and Y e_B with
ops/ba_kernel.assemble_streams (kernel 3 on the card); one all_reduce of
the four, packed into one buffer, completes the system, and one more the
trial error; every rank solves the system redundantly (it is tiny), and
the back-substitution d_b = V*^-1 (e_B - W^T d_a) of its own matches
stays local. This is the reference's get_iter_par dataflow
(_bundle_adjust_main.cpp:192-244) as a collective schedule.

There is no second LM: ``ba.lm_step`` with the process group of a mesh
is the sharded trial, and ``ba.LMProgram`` with that group runs it, with
a host read every ba.READ_EVERY trials. On the card the program captures
it, both all_reduces included, as one CUDA graph and replays it: the
counterpart of the JAX package's one compiled program; on the CPU (gloo;
CUDA graphs do not exist there) it runs the trial between the reads.
The JAX package's two variants, ``lm_run_sharded`` (sharding
annotations, XLA's partitioner inserts the all-reduces) and
``lm_run_shard_map`` (explicit psums), compute the same numbers; here
both names are this one implementation, and ``make_lm_step_shard_map``
exposes one trial of it. At one rank the all-reduces are the identity,
so the result equals, bit for bit, that of a program without a group
whose trial is ba.lm_step.

The matches are interleaved across ranks (parallel.mesh.shard_matches):
the match count must be divisible by the mesh size, and each rank's
share a multiple of min(512, share), as kernel 3 requires.
"""

from __future__ import annotations

from simplepanorama_tpu_torch import ba
from simplepanorama_tpu_torch.parallel.mesh import (Mesh, shard_matches,
                                                    unshard_matches)


def lm_run_sharded(cams: ba.CamState, data: ba.BAData, cam_active,
                   lambda0, mesh: Mesh, fast: bool = False,
                   max_iter: int = 50, vaug_idx=None,
                   with_counts: bool = False):
    """ba.lm_run with the match axis split over ``mesh``. ``cams`` and
    ``data`` are whole (every rank holds the same), on ``mesh.device``;
    the result's b is gathered back to the whole table on every rank.
    The run is a ba.LMProgram's with the mesh's group, made and closed in
    this call: on the card its trial is one CUDA graph with its
    all_reduces inside. With ``with_counts`` it returns (LMResult, trials
    executed, host reads), as LMProgram.run does.
    ``lm_run_sharded.last_stats`` holds the last call's ``graphed``
    (whether it ran on the card, where the trial is a graph) and
    ``capture_s`` (host seconds capturing)."""
    local = shard_matches(data, mesh)
    start = cams._replace(b=cams.b[mesh.rank::mesh.size])
    program = ba.LMProgram(local, cams.focal.shape[0], fast,
                           max_iter=max_iter, group=mesh.group)
    try:
        res, executed, reads = program.run(start, cam_active, lambda0,
                                           vaug_idx)
    finally:
        program.close()
    lm_run_sharded.last_stats = {"graphed": program.graphed,
                                 "capture_s": program.capture_s}
    b = cams.b if fast else unshard_matches(res.cams.b, mesh)
    res = res._replace(cams=res.cams._replace(b=b))
    return (res, executed, reads) if with_counts else res


lm_run_sharded.last_stats = {}


def lm_run_shard_map(cams: ba.CamState, data: ba.BAData, cam_active,
                     lambda0, mesh: Mesh, fast: bool = False,
                     max_iter: int = 50) -> ba.LMResult:
    """The full LM loop (lambda x10 / /10 schedule, 6-strike stop) with
    explicit collectives, for either objective: the same implementation
    as lm_run_sharded."""
    return lm_run_sharded(cams, data, cam_active, lambda0, mesh,
                          fast=fast, max_iter=max_iter)


def make_lm_step_shard_map(mesh: Mesh, n_cams: int, fast: bool = False):
    """One LM trial step over this rank's share of the matches (the loop
    body of lm_run_sharded, without the schedule). Returns
    step(cams, local_data, cam_active, lam) -> (new_cams, err, ok): the
    camera state with this rank's b (from shard_matches), the trial's
    error over every rank's matches, and whether it was accepted."""

    def step(cams: ba.CamState, data: ba.BAData, cam_active, lam):
        if cams.focal.shape[0] != n_cams:
            raise ValueError(f"{cams.focal.shape[0]} cameras, the step was "
                             f"made for {n_cams}")
        pb = ba.lm_problem(data, cam_active, group=mesh.group)
        st = ba.lm_init(cams, pb, lam, fast)
        new, err_new = ba.lm_step(st, pb, fast)
        return new.cams, err_new, new.n_acc > 0

    return step
