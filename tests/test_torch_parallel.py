"""The port's multi-device layer (simplepanorama_tpu_torch/parallel/) in a
world of 2 gloo ranks on the CPU, against the JAX package's on
make_mesh(2) of the conftest's 8-device CPU mesh and against the port's
single-device code.

One world runs every check of this file: the module-scoped fixture writes
the seeded inputs, starts 2 ranks (subprocesses that import torch and the
port, never jax, with the SPT_* variables) and reads what each rank wrote.
"""

import os
import textwrap

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from simplepanorama_tpu import ba as jba
from simplepanorama_tpu.ops.maxflow import grid_mincut as jax_grid_mincut
from simplepanorama_tpu.parallel import tiled_compose as jtc
from simplepanorama_tpu.parallel.dist_ba import (
    lm_run_sharded as j_lm_run_sharded, make_lm_step_shard_map as j_step)
from simplepanorama_tpu.parallel.mesh import make_mesh as j_make_mesh
from simplepanorama_tpu.render.blending import multi_blend as j_multi_blend
from simplepanorama_tpu.render.projection import (adjusted_K, roi_for_image,
                                                  warp_backward)
from simplepanorama_tpu_torch import ba as tba
from simplepanorama_tpu_torch.fixtures import cut_grid, max_flow_value
from simplepanorama_tpu_torch.ops import maxflow as tmf
from simplepanorama_tpu_torch.parallel.launch import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[3])
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from simplepanorama_tpu_torch import ba
    from simplepanorama_tpu_torch.parallel import (dist_ba, dist_mincut,
                                                   multihost,
                                                   tiled_compose as tc)
    from simplepanorama_tpu_torch.parallel.mesh import shard_matches

    multihost.initialize()
    mesh = multihost.global_mesh()
    inp = dict(np.load(sys.argv[1]))
    T = torch.from_numpy
    out = {"world": np.array(mesh.size)}

    # the match-sharded LM, both objectives, and one explicit step
    data = ba.BAData(*(T(inp["ba_" + k]) for k in ba.BAData._fields))
    cams = ba.CamState(T(inp["ba_focal"]), T(inp["ba_ppal"]),
                       T(inp["ba_rotvec"]), data.t.clone())
    active = torch.ones(4, dtype=torch.bool)
    for fast in (True, False):
        res = dist_ba.lm_run_sharded(cams, data, active, 0.05, mesh,
                                     fast=fast, max_iter=12)
        for k in ("focal", "rotvec", "b"):
            out[f"lm{int(fast)}_{k}"] = getattr(res.cams, k).numpy()
        out[f"lm{int(fast)}_error"] = res.error.numpy()
        out[f"lm{int(fast)}_trials"] = res.n_iter.numpy()
    step = dist_ba.make_lm_step_shard_map(mesh, 4, fast=True)
    local = shard_matches(data, mesh)
    new, err, ok = step(cams._replace(b=local.t.clone()), local, active,
                        torch.tensor(0.05))
    out.update(step_focal=new.focal.numpy(), step_rotvec=new.rotvec.numpy(),
               step_err=err.numpy(), step_ok=ok.numpy())

    # the column-sharded min-cut
    for g in ("g0", "g1"):
        graph = [T(inp[f"{g}_{k}"]) for k in ("wh", "wv", "exc", "node")]
        out[g + "_side"] = dist_mincut.grid_mincut_sharded(*graph,
                                                           mesh).numpy()

    # halo exchange of this rank's slab of an iota, fill 0 and -1
    x = T(inp["halo_x"])
    Ws = x.shape[1] // mesh.size
    slab = x[:, mesh.rank * Ws:(mesh.rank + 1) * Ws]
    out["halo0"] = tc.halo_exchange(slab, 2, mesh).numpy()
    out["halo1"] = tc.halo_exchange(slab, 2, mesh, fill=-1.0).numpy()

    # multiband blend, images split over the ranks
    for c in ("mb4", "mb5", "mb3"):
        out[c] = tc.multi_blend_sharded(
            T(inp[c + "_imgs"]), T(inp[c + "_seams"]), T(inp[c + "_origs"]),
            T(inp[c + "_offs"]), (96, 320), mesh, bands=int(inp[c + "_bands"]),
            sigma=float(inp[c + "_sigma"])).numpy()

    # the tiled warp
    w, m = tc.warp_tiled(T(inp["wt_img"]), T(inp["wt_K"]), T(inp["wt_R"]),
                         T(inp["wt_corner"]), 120.0, "spherical",
                         int(inp["wt_hw"][0]), int(inp["wt_hw"][1]),
                         T(inp["wt_vhw"]), mesh)
    out.update(wt_warped=w.numpy(), wt_mask=m.numpy())

    # the two full-res schedules
    fr = {k[3:]: inp[k] for k in inp if k.startswith("fr_")}
    kw = dict(scale=40.0, kind="spherical", canvas_hw=(64, 256),
              min_xy=(0, 0), bands=2, sigma=3.0, use_seam=True,
              use_field=False, mesh=mesh)
    args = [fr["src"], fr["Ka"], fr["R"], fr["corner"], fr["vhw"], fr["wh"],
            fr["offs"], T(fr["sb"]), fr["sr"], T(fr["fb"]), fr["fr"],
            fr["g"]]
    out["fr_canvas"] = tc.fullres_multi_canvas(*args, **kw).numpy()
    out["fr_dp"] = tc.fullres_multi_dp(args[0], (40, 128), *args[1:],
                                       **kw).numpy()
    np.savez(sys.argv[2] % mesh.rank, **out)
    print(f"rank {mesh.rank}: ok", flush=True)
""")


def _ba_problem(rng, n_cams=4, M=512):
    """tests/test_parallel.py's problem: cameras on a yaw arc, matches
    from the model, the start perturbed."""
    from simplepanorama_tpu.stitch import _rodrigues_np
    f = 700.0
    rotvecs = [np.array([0.0, 0.2 * i, 0.01 * i]) for i in range(n_cams)]
    K = np.diag([f, f, 1.0])
    mi = rng.integers(0, n_cams - 1, M).astype(np.int32)
    mj = (mi + 1).astype(np.int32)
    t = rng.uniform(-200, 200, (M, 2)).astype(np.float32)
    q = np.zeros_like(t)
    for m in range(M):
        H = K @ _rodrigues_np(rotvecs[mi[m]]).T \
            @ _rodrigues_np(rotvecs[mj[m]]) @ np.linalg.inv(K)
        p = H @ np.array([t[m, 0], t[m, 1], 1.0])
        q[m] = p[:2] / p[2]
    data = jba.with_pair_tables(jba.BAData(
        mi=jnp.asarray(mi), mj=jnp.asarray(mj), q=jnp.asarray(q),
        t=jnp.asarray(t), m_valid=jnp.ones(M, bool)))
    rot0 = np.stack([np.zeros(3)] + [r + 0.02 for r in rotvecs[1:]]) \
        .astype(np.float32)
    return data, np.full(n_cams, f * 1.05, np.float32), rot0


def _blocks(rng, n, Hb=40, Wb=128, H=96, W=320):
    """tests/test_tiled.py's random blocks."""
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    origs = np.zeros((n, Hb, Wb), np.float32)
    seams = np.zeros((n, Hb, Wb), np.float32)
    offs = np.zeros((n, 2), np.int32)
    for i in range(n):
        h, w = rng.integers(20, Hb + 1), rng.integers(60, Wb + 1)
        origs[i, :h, :w] = 1.0
        y0, x0 = rng.integers(0, 5), rng.integers(0, 20)
        seams[i, y0:h, x0:w] = 1.0
        offs[i] = (rng.integers(0, H - Hb + 1), rng.integers(0, W - Wb + 1))
    return imgs, seams, origs, offs


def _fullres_problem():
    """tests/test_tiled.py's full-res smoke problem (3 images)."""
    m = 3
    rng = np.random.default_rng(0)
    return dict(
        src=rng.integers(0, 255, (m, 32, 48, 3)).astype(np.uint8),
        Ka=np.tile(np.diag([40.0, 40.0, 1.0]).astype(np.float32), (m, 1, 1)),
        R=np.tile(np.eye(3, dtype=np.float32), (m, 1, 1)),
        corner=np.array([[0., 0.], [10., 0.], [20., 0.]], np.float32),
        vhw=np.array([[32, 48]] * m, np.int32),
        wh=np.array([[40, 30]] * m, np.int32),
        offs=np.array([[0, 0], [0, 10], [0, 20]], np.int32),
        sb=np.ones((m, 16, 24), np.float32),
        sr=np.full((m, 2), 0.5, np.float32),
        fb=np.zeros((m, 1, 1), np.float32),
        fr=np.ones((m, 2), np.float32), g=np.ones((m,), np.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the 2-rank world's outputs (one dict per rank)."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp = {}
    data, focal, rot0 = _ba_problem(np.random.default_rng(2))
    for k in ("mi", "mj", "pi", "pj", "mp"):
        inp["ba_" + k] = np.asarray(getattr(data, k)).astype(np.int64)
    for k in ("q", "t", "m_valid"):
        inp["ba_" + k] = np.asarray(getattr(data, k))
    inp.update(ba_focal=focal, ba_ppal=np.zeros((4, 2), np.float32),
               ba_rotvec=rot0)
    for g, graph in (("g0", cut_grid(48, 160, 7, (10, 20, 40, 70))),
                     ("g1", cut_grid(24, 33, 3, (5, 9, 10, 14)))):
        for k, a in zip(("wh", "wv", "exc", "node"), graph):
            inp[f"{g}_{k}"] = a
    inp["halo_x"] = np.arange(2 * 16, dtype=np.float32).reshape(2, 16)
    rng = np.random.default_rng(0)
    for c, n, bands, sigma in (("mb4", 4, 2, 5.0), ("mb5", 5, 2, 5.0),
                               ("mb3", 3, 3, 3.0)):
        for k, a in zip(("imgs", "seams", "origs", "offs"), _blocks(rng, n)):
            inp[f"{c}_{k}"] = a
        inp[c + "_bands"], inp[c + "_sigma"] = np.array(bands), \
            np.array(sigma)
    H, W = 64, 96
    img = rng.uniform(0, 255, (H, W, 3)).astype(np.float32)
    K0 = np.array([[120.0, 0, W / 2], [0, 120.0, H / 2], [0, 0, 1]])
    tlx, tly, rw, rh = roi_for_image("spherical", 120.0, np.eye(3), K0, H, W)
    inp.update(wt_img=img, wt_K=adjusted_K(K0, H, W).astype(np.float32),
               wt_R=np.eye(3, dtype=np.float32),
               wt_corner=np.array([tlx, tly], np.float32),
               wt_vhw=np.array([H, W], np.int64),
               wt_hw=np.array([rh + 6, rw + 10]))
    for k, a in _fullres_problem().items():
        inp["fr_" + k] = a
    np.savez(tmp / "in.npz", **inp)
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    outs = run_world([str(script), str(tmp / "in.npz"),
                      str(tmp / "out%d.npz"), REPO], 2, timeout_s=400)
    for rank, (rc, log) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{log[-3000:]}"
    return inp, [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


def _jax_ba(inp):
    data = jba.BAData(**{k: jnp.asarray(inp["ba_" + k])
                         for k in ("q", "t", "m_valid")},
                      **{k: jnp.asarray(inp["ba_" + k].astype(np.int32))
                         for k in ("mi", "mj", "pi", "pj", "mp")})
    cams = jba.CamState(focal=jnp.asarray(inp["ba_focal"]),
                        ppal=jnp.zeros((4, 2), jnp.float32),
                        rotvec=jnp.asarray(inp["ba_rotvec"]), b=data.t)
    return cams, data


def test_ranks_hold_the_same_results(world):
    """Every result comes back whole and equal, bit for bit, on both
    ranks (the collectives leave every rank the same value)."""
    _, (r0, r1) = world
    assert int(r0["world"]) == 2
    for k in r0:
        if not k.startswith("halo"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("fast", [True, False])
def test_lm_run_sharded_matches_jax(world, fast):
    """lm_run_sharded over 2 ranks against the JAX package's over
    make_mesh(2) and against the port's unsharded LM (ba.lm_run),
    12 trials. Tolerance (tests/test_parallel.py's): errors within 1e-2
    relative, rotation vectors within 5e-3; focals within 1e-3 relative
    of the unsharded port's. The relaxed objective moves b."""
    inp, (r0, _) = world
    cams_j, data_j = _jax_ba(inp)
    active = jnp.ones(4, bool)
    rj = j_lm_run_sharded(cams_j, data_j, active, 0.05, j_make_mesh(2),
                          fast=fast, max_iter=12)
    T = torch.from_numpy
    data_t = tba.BAData(*(T(inp["ba_" + k]) for k in tba.BAData._fields))
    cams_t = tba.CamState(T(inp["ba_focal"]), T(inp["ba_ppal"]),
                          T(inp["ba_rotvec"]), data_t.t.clone())
    rt = tba.lm_run(cams_t, data_t, torch.ones(4, dtype=torch.bool),
                    0.05, fast=fast, max_iter=12)
    f = int(fast)
    err = float(r0[f"lm{f}_error"])
    np.testing.assert_allclose(err, float(rj.error), rtol=1e-2)
    np.testing.assert_allclose(err, float(rt.error), rtol=1e-2)
    np.testing.assert_allclose(r0[f"lm{f}_rotvec"], np.asarray(rj.cams.rotvec),
                               atol=5e-3)
    np.testing.assert_allclose(r0[f"lm{f}_rotvec"], rt.cams.rotvec.numpy(),
                               atol=5e-3)
    np.testing.assert_allclose(r0[f"lm{f}_focal"], rt.cams.focal.numpy(),
                               rtol=1e-3)
    moved = np.abs(r0[f"lm{f}_b"] - inp["ba_t"]).max()
    assert (moved == 0.0) if fast else (moved > 1e-4)


def test_lm_step_matches_jax(world):
    """One make_lm_step_shard_map step (Lowe objective) over 2 ranks
    against the JAX package's under shard_map on make_mesh(2).
    Tolerance: accepted alike; the trial error within 1e-5 relative,
    focals within 1e-5 relative, rotation vectors within 1e-5."""
    inp, (r0, _) = world
    cams, data = _jax_ba(inp)
    mesh = j_make_mesh(2)
    sh, rep = P("data"), P()
    f = shard_map(j_step(mesh, 4, fast=True), mesh=mesh,
                  in_specs=(jba.CamState(focal=rep, ppal=rep, rotvec=rep,
                                         b=sh),
                            jba.BAData(mi=sh, mj=sh, q=sh, t=sh, m_valid=sh,
                                       pi=rep, pj=rep, mp=sh), rep, rep),
                  out_specs=(jba.CamState(focal=rep, ppal=rep, rotvec=rep,
                                          b=sh), rep, rep))
    new, err, ok = jax.jit(f)(cams, data, jnp.ones(4, bool),
                              jnp.asarray(0.05, jnp.float32))
    assert bool(r0["step_ok"]) == bool(ok) is True
    np.testing.assert_allclose(float(r0["step_err"]), float(err), rtol=1e-5)
    np.testing.assert_allclose(r0["step_focal"], np.asarray(new.focal),
                               rtol=1e-5)
    np.testing.assert_allclose(r0["step_rotvec"], np.asarray(new.rotvec),
                               atol=1e-5)


@pytest.mark.parametrize("g", ["g0", "g1"])
def test_grid_mincut_sharded_matches_ref(world, g):
    """grid_mincut_sharded over 2 ranks (48x160 with a hole, and 24x33,
    whose width is padded to 34): the port's grid_mincut_ref's side bit
    for bit; its cut value equal to the JAX package's grid_mincut and
    within 1e-3 relative of scipy's exact max flow."""
    inp, (r0, _) = world
    graph = [inp[f"{g}_{k}"] for k in ("wh", "wv", "exc", "node")]
    ref = tmf.grid_mincut_ref(*map(torch.from_numpy, graph)).numpy()
    np.testing.assert_array_equal(r0[g + "_side"], ref)
    side_j = np.asarray(jax_grid_mincut(*map(jnp.asarray, graph)))
    v = tmf.cut_value(*graph, r0[g + "_side"])
    assert v == tmf.cut_value(*graph, side_j)
    exact = max_flow_value(*graph)
    assert abs(v - exact) <= 1e-3 * max(1.0, exact)


def test_halo_exchange_roundtrip(world):
    """Each rank's slab of a (2, 16) iota, padded by 2 columns from each
    neighbour: the neighbours' columns, ``fill`` at the ring's ends
    (tests/test_tiled.py's check)."""
    inp, outs = world
    x = inp["halo_x"]
    for fill, key in ((0.0, "halo0"), (-1.0, "halo1")):
        for d, r in enumerate(outs):
            lo, hi = d * 8 - 2, (d + 1) * 8 + 2
            want = np.full((2, 12), fill, np.float32)
            want[:, max(lo, 0) - lo:min(hi, 16) - lo] = \
                x[:, max(lo, 0):min(hi, 16)]
            np.testing.assert_array_equal(r[key], want)


@pytest.mark.parametrize("case", ["mb4", "mb5", "mb3"])
def test_multi_blend_sharded_matches_jax(world, case):
    """multi_blend_sharded over 2 ranks: 4 images (2 a rank), 5 and 3
    (uneven). Tolerance (tests/test_tiled.py's): within 2e-2 of the JAX
    package's multi_blend_sharded on make_mesh(2) and of its
    single-device multi_blend, on the 0..255 scale (float order only)."""
    inp, (r0, _) = world
    args = [jnp.asarray(inp[f"{case}_{k}"])
            for k in ("imgs", "seams", "origs", "offs")]
    kw = dict(bands=int(inp[case + "_bands"]),
              sigma=float(inp[case + "_sigma"]))
    sj = np.asarray(jtc.multi_blend_sharded(*args, (96, 320), j_make_mesh(2),
                                            **kw))
    ref = np.asarray(j_multi_blend(*args, (96, 320), **kw))
    assert r0[case].shape == sj.shape == (96, 320, 3)
    np.testing.assert_allclose(r0[case], sj, atol=2e-2)
    np.testing.assert_allclose(r0[case], ref, atol=2e-2)


def test_warp_tiled_matches_full_warp(world):
    """warp_tiled over 2 ranks against the JAX package's warp_backward of
    the whole ROI. Tolerance: masks equal; pixels within 0.05 on the
    0..255 scale (tests/test_tiled.py's bound)."""
    inp, (r0, _) = world
    out_h, out_w = (int(v) for v in inp["wt_hw"])
    ref_w, ref_m = warp_backward(
        jnp.asarray(inp["wt_img"]), jnp.asarray(inp["wt_K"]),
        jnp.asarray(inp["wt_R"]), jnp.asarray(inp["wt_corner"]), 120.0,
        "spherical", out_h, out_w, jnp.asarray(inp["wt_vhw"], jnp.int32))
    assert np.asarray(ref_m).sum() > 100
    np.testing.assert_array_equal(r0["wt_mask"], np.asarray(ref_m))
    np.testing.assert_allclose(r0["wt_warped"], np.asarray(ref_w), atol=0.05)


@pytest.mark.parametrize("schedule", ["canvas", "dp"])
def test_fullres_schedules_match_jax(world, schedule):
    """fullres_multi_canvas and fullres_multi_dp over 2 ranks on
    tests/test_tiled.py's 3-image problem, against the JAX package's same
    schedule on make_mesh(2). Tolerance: uint8 within 1 level on >= 99.9%
    of pixels (a float32 sum in another order rounds to the neighbouring
    level), and test_tiled's own check, canvas against dp differing by > 2
    levels on < 1% of pixels."""
    inp, (r0, _) = world
    fr = {k[3:]: jnp.asarray(inp[k]) for k in inp if k.startswith("fr_")}
    kw = dict(scale=40.0, kind="spherical", canvas_hw=(64, 256),
              min_xy=(0, 0), bands=2, sigma=3.0, use_seam=True,
              use_field=False, mesh=j_make_mesh(2))
    args = [fr[k] for k in ("src", "Ka", "R", "corner", "vhw", "wh", "offs",
                            "sb", "sr", "fb", "fr", "g")]
    if schedule == "canvas":
        want = np.asarray(jtc.fullres_multi_canvas(*args, **kw))
    else:
        want = np.asarray(jtc.fullres_multi_dp(args[0], (40, 128), *args[1:],
                                               **kw))
    got = r0["fr_" + schedule]
    assert got.shape == want.shape == (64, 256, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.999, (diff.max(), (diff > 1).mean())
    other = r0["fr_dp" if schedule == "canvas" else "fr_canvas"]
    assert (np.abs(got.astype(int) - other.astype(int)) > 2).mean() < 0.01
