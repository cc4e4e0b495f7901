"""The port's rank-sharded pipeline in a world of 2 gloo ranks on the CPU:
host_shard, the feature all-gather, the sharded adjacency passes and a
whole 4-view stitch with its preview and full-res render, against the
port in one process and against the JAX package.

One world runs every check of this file (ranks are subprocesses that
import torch and the port, never jax, with the SPT_* variables); the
module-scoped fixture computes the single-process results while the
world runs.
"""

import os
import textwrap
import threading

import numpy as np
import pytest
import torch
import jax

import simplepanorama_tpu_torch as T
from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import adjacency as jadj
from simplepanorama_tpu import features as jfeat
from simplepanorama_tpu import io as jio
from simplepanorama_tpu_torch import adjacency as tadj
from simplepanorama_tpu_torch import features as tfeat
from simplepanorama_tpu_torch import io as tio
from simplepanorama_tpu_torch import stitch as tstitch
from simplepanorama_tpu_torch.geometry.focal import focal_from_hom
from simplepanorama_tpu_torch.geometry.graph import connected_components
from simplepanorama_tpu_torch.fixtures import fkh360_views
from simplepanorama_tpu_torch.parallel.launch import run_world
from simplepanorama_tpu_torch.parallel.multihost import host_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(cut=True, init_size=320, RANSAC_iterations=300)
torch.set_num_threads(2)

_WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, sys.argv[3])
    import numpy as np
    import torch
    torch.set_num_threads(2)
    import simplepanorama_tpu_torch as T
    from simplepanorama_tpu_torch import adjacency, ba, features, io, stitch
    from simplepanorama_tpu_torch.parallel import multihost
    from simplepanorama_tpu_torch.parallel import tiled_compose as tc
    from simplepanorama_tpu_torch.parallel.mesh import pipeline_mesh

    from simplepanorama_tpu_torch.geometry.focal import focal_from_hom
    from simplepanorama_tpu_torch.geometry.graph import connected_components

    multihost.initialize()
    mesh = pipeline_mesh()
    inp = dict(np.load(sys.argv[1]))
    paths = [str(p) for p in inp["paths"]]
    cfg = T.Config(cut=True, init_size=320, RANSAC_iterations=300)
    out = {"world": np.array(mesh.size), "rank": np.array(mesh.rank),
           "shard": np.array(multihost.host_shard(list(range(5))))}

    # which sharded paths ran
    calls = {"extract_sharded": 0, "sharded_trials": 0,
             "multi_blend_sharded": 0, "fullres_multi_dp": 0}

    def counting(mod, name, key, when=lambda *a, **kw: True):
        fn = getattr(mod, name)
        def wrapped(*a, **kw):
            calls[key] += bool(when(*a, **kw))
            return fn(*a, **kw)
        setattr(mod, name, wrapped)
    counting(features, "_extract_sharded", "extract_sharded")
    counting(ba, "_camera_sums", "sharded_trials",
             lambda floats, pb, *a: pb.group is not None)
    counting(tc, "multi_blend_sharded", "multi_blend_sharded")
    counting(tc, "fullres_multi_dp", "fullres_multi_dp")

    # the feature all-gather
    images = io.ImageSet(paths)
    images.load_resized(320, threads=1)
    feats = features.extract_features(images.img_data, cfg, device="cpu")
    for k in ("xy", "desc", "valid"):
        out["feat_" + k] = np.stack([np.asarray(getattr(f, k))
                                     for f in feats])

    # the two passes of the adjacency, with the JAX package's draws
    def draws(i, j, n_iter, m):
        return inp[f"draws_{i}_{j}"]
    sizes = [im.shape[:2] for im in images.img_data]
    adj = adjacency.build_adjacency(feats, sizes, cfg, pair_draws=draws)
    out.update(adj_counts=adj.raw_counts, adj_adj=adj.adj,
               adj_hom=adj.hom_mat,
               adj_nmatch=np.array([len(adj.matches.get((i, j), ((),))[0])
                                    for i in range(4) for j in range(4)]))

    # the BA over that adjacency: every rank runs its share of the
    # matches
    comp = connected_components(adj.adj)[0]
    trials = calls["sharded_trials"]
    whole = stitch.bundle_adjust_stitching(
        comp, adj, sizes, focal_from_hom(adj.hom_mat, adj.adj), cfg,
        device="cpu")
    out.update(whole_K=whole.K, whole_rot=whole.rot,
               whole_sharded_trials=np.array(calls["sharded_trials"] - trials))

    # the whole stitch, preview and full-res
    pano = T.Panorama(paths, device="cpu").stitch(cfg)
    out.update(connected=np.array(pano.connected),
               K=pano.result.K, rot=pano.result.rot,
               preview=pano.get_preview(), full=pano.get_panorama(),
               seams=pano.stitch_params.state.seam_masks.numpy())
    out.update({"calls_" + k: np.array(v) for k, v in calls.items()})
    np.savez(sys.argv[2] % mesh.rank, **out)
    print(f"rank {mesh.rank}: ok", flush=True)
""")


def _jax_draws(n, n_iter, m):
    """The JAX package's per-pair RANSAC uniforms (adjacency._pair_keys,
    homography.ransac_homography)."""
    master = jax.random.PRNGKey(0)
    return {(i, j): np.array(jax.random.uniform(
        jax.random.fold_in(master, i * n + j), (n_iter, m)))
        for i in range(n) for j in range(i + 1, n)}


def _ncc(a, b):
    a = a.astype(np.float64).ravel() - a.mean()
    b = b.astype(np.float64).ravel() - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(paths, the JAX draws, rank outputs, single-process port results)."""
    tmp = tmp_path_factory.mktemp("multihost")
    paths, _, _ = fkh360_views(4, 320, yaw_step_deg=20.0, hfov_deg=45.0,
                               roll_deg=3.0, out_dir=str(tmp / "views"))
    cfg = T.Config(**CFG)
    draws = _jax_draws(4, cfg.RANSAC_iterations, cfg.max_matches_per_pair)
    np.savez(tmp / "in.npz", paths=np.array(paths),
             **{f"draws_{i}_{j}": d for (i, j), d in draws.items()})
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    result = {}
    t = threading.Thread(target=lambda: result.update(outs=run_world(
        [str(script), str(tmp / "in.npz"), str(tmp / "out%d.npz"), REPO],
        2, timeout_s=500)))
    t.start()
    # meanwhile, the same in one process
    images = tio.ImageSet(paths)
    images.load_resized(320, threads=1)
    feats = tfeat.extract_features(images.img_data, cfg, device="cpu")
    sizes = [im.shape[:2] for im in images.img_data]
    adj = tadj.build_adjacency(feats, sizes, cfg,
                               pair_draws=lambda i, j, n, m: draws[i, j])
    whole = tstitch.bundle_adjust_stitching(
        connected_components(adj.adj)[0], adj, sizes,
        focal_from_hom(adj.hom_mat, adj.adj), cfg, device="cpu")
    pano = T.Panorama(paths, device="cpu").stitch(cfg)
    single = dict(feats=feats, adj=adj, whole=whole, connected=pano.connected,
                  K=pano.result.K, rot=pano.result.rot,
                  preview=pano.get_preview(), full=pano.get_panorama())
    t.join()
    for rank, (rc, log) in enumerate(result["outs"]):
        assert rc == 0, f"rank {rank} failed:\n{log[-3000:]}"
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]
    return paths, draws, outs, single


def test_world_ran_the_sharded_paths(world):
    """Both ranks ran the rank-sharded code: the feature all-gather, the
    LM trials with the camera system all-reduced (a world splits the BA's
    matches at any size), the sharded multiband preview and the
    image-split full-res render; and both hold the same results, bit for
    bit."""
    _, _, (r0, r1), _ = world
    assert int(r0["world"]) == 2 and int(r1["rank"]) == 1
    for k in ("extract_sharded", "multi_blend_sharded", "fullres_multi_dp"):
        assert int(r0["calls_" + k]) >= 1, k
    assert int(r0["calls_sharded_trials"]) >= 3 * 8
    for k in r0:
        if k not in ("rank", "shard"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_ba_splits_matches_in_a_world_of_two_or_more():
    """stitch._ba_mesh: no world, or a world of one rank, runs the
    single-device BA (None); a world of two splits the matches over its
    mesh at any count that divides, as the JAX package's stitch does: at
    6,144 matches (slices 1 and 3's BA problems) and at the 1,024 of a
    few-view stitch."""
    from simplepanorama_tpu_torch import stitch
    from simplepanorama_tpu_torch.parallel.mesh import Mesh
    one = Mesh(group=None, size=1, rank=0, device=torch.device("cpu"))
    two = Mesh(group=None, size=2, rank=0, device=torch.device("cpu"))
    assert not hasattr(stitch, "BA_SHARD_MIN_MATCHES")
    assert stitch._ba_mesh(None, 6144) is None
    assert stitch._ba_mesh(one, 6144) is None
    assert stitch._ba_mesh(two, 6144) is two
    assert stitch._ba_mesh(two, 1024) is two


def test_host_shard():
    """host_shard: contiguous shards of ceil(n / ranks), in both packages'
    sense; rank 1 of 2 in the world held [3, 4] of 5."""
    from simplepanorama_tpu.parallel.multihost import host_shard as jshard
    for n, idx in ((2, 0), (2, 1), (3, 2)):
        assert host_shard(list(range(5)), n, idx) == \
            jshard(list(range(5)), n, idx)


def test_world_host_shards(world):
    _, _, (r0, r1), _ = world
    assert r0["shard"].tolist() == [0, 1, 2] and r1["shard"].tolist() == [3, 4]


def test_feature_all_gather_matches(world):
    """The 2-rank features (each rank SIFTs its 2 images at the common
    pad, then all-gathers the tables) against the port in one process:
    equal, bit for bit; and against the JAX package's extract_features at
    tests/test_torch_modules.py's SIFT tolerances (the same valid counts,
    every JAX keypoint within 1e-2 px of a port keypoint, paired
    descriptors within 2e-3)."""
    paths, _, (r0, _), single = world
    for i, f in enumerate(single["feats"]):
        for k in ("xy", "desc", "valid"):
            np.testing.assert_array_equal(r0["feat_" + k][i],
                                          np.asarray(getattr(f, k)), k)
    jimages = jio.ImageSet(paths)
    jimages.load_resized(320, threads=1)
    fj = jfeat.extract_features(jimages.img_data, JConfig(init_size=320))
    for i, a in enumerate(fj):
        vj, vt = np.asarray(a.valid), r0["feat_valid"][i]
        assert vj.sum() == vt.sum() > 50
        xj, xt = np.asarray(a.xy)[vj], r0["feat_xy"][i][vt]
        d = np.abs(xj[:, None, :] - xt[None, :, :]).max(-1)
        assert d.min(1).max() <= 1e-2
        dt = r0["feat_desc"][i][vt][d.argmin(1)]
        assert np.abs(dt - np.asarray(a.desc)[vj]).max() <= 2e-3


def test_adjacency_matches(world):
    """The sharded passes (each rank counts, then verifies, its shard of
    the pairs; the results all-gathered) against the port in one process
    and the JAX package's build_adjacency on the same features with the
    same draws: pass-1 counts equal; the same accepted pairs; weights and
    homographies within 1e-5 of the single-process port's (measured:
    equal) and 1e-3 of the JAX package's (float order)."""
    _, draws, (r0, _), single = world
    a1 = single["adj"]
    np.testing.assert_array_equal(r0["adj_counts"], a1.raw_counts)
    np.testing.assert_array_equal(r0["adj_adj"] > 0, a1.adj > 0)
    assert (a1.adj > 0).sum() >= 3
    np.testing.assert_allclose(r0["adj_adj"], a1.adj, atol=1e-5)
    np.testing.assert_allclose(r0["adj_hom"], a1.hom_mat, atol=1e-5)
    nm = [len(a1.matches.get((i, j), ((),))[0])
          for i in range(4) for j in range(4)]
    assert r0["adj_nmatch"].tolist() == nm
    jfe = [jfeat.Features(xy=f.xy, size=f.size, response=f.response,
                          desc=f.desc, valid=f.valid)
           for f in single["feats"]]
    sizes = [(320, 320)] * 4
    aj = jadj.build_adjacency(jfe, sizes, JConfig(**CFG))
    np.testing.assert_array_equal(r0["adj_counts"], aj.raw_counts)
    np.testing.assert_array_equal(r0["adj_adj"] > 0, aj.adj > 0)
    np.testing.assert_allclose(r0["adj_adj"], aj.adj, atol=1e-3)


def test_whole_ba_in_two_ranks_matches_one(world):
    """The BA over the adjacency in a world of two ranks splits its
    matches (every trial sharded, at the default) and gets the port's
    one-process result on the same adjacency: both ranks equal bit for
    bit, focals and rotations within 1e-5 of one process's."""
    _, _, (r0, r1), single = world
    assert int(r0["whole_sharded_trials"]) >= 8
    np.testing.assert_array_equal(r0["whole_K"], r1["whole_K"])
    np.testing.assert_array_equal(r0["whole_rot"], r1["whole_rot"])
    np.testing.assert_allclose(r0["whole_K"], single["whole"].K, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r0["whole_rot"], single["whole"].rot,
                               atol=1e-5)


def test_stitch_in_two_ranks_matches_one(world):
    """A 4-view 320-px stitch (cut=True, MULTI_BLEND) in 2 ranks against
    1: the same views connected; focals within 1e-3 relative and
    rotations within 0.1 degree (the sharded BA sums the camera system in
    another float order); preview and full-res of the same shape with
    NCC >= 0.99 (tests/test_torch_slice.py's preview bound)."""
    _, _, (r0, _), single = world
    assert tuple(r0["connected"]) == tuple(single["connected"]) == (4, 4)
    np.testing.assert_allclose(r0["K"][:, 0, 0], single["K"][:, 0, 0],
                               rtol=1e-3)
    for Ra, Rb in zip(r0["rot"], single["rot"]):
        c = np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)
        assert np.degrees(np.arccos(c)) < 0.1
    for k in ("preview", "full"):
        assert r0[k].shape == single[k].shape
        assert _ncc(r0[k], single[k]) >= 0.99, k
