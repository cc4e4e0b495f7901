"""The port's host min-cut (native.py, the ctypes binding of
native/mincut.cpp built into build/native/) and the CPU seam path that
uses it, against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import native as jnative
from simplepanorama_tpu import stitcher as jstitcher
from simplepanorama_tpu.stitch import StitchResult as JStitchResult
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import native as tnative
from simplepanorama_tpu_torch import stitcher as tstitcher
from simplepanorama_tpu_torch.convert import stitch_result_from_numpy
from simplepanorama_tpu_torch.fixtures import cut_grid, max_flow_value

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_mincut_native_matches_jax_and_scipy(seed):
    """grid_mincut_native of the port against the JAX package's binding of
    the same source, on a 40x56 cut graph with a hole: the same sides and
    the same flow, bit for bit; the flow within 1e-3 relative of scipy's
    exact max flow (scipy works on capacities rounded to 1e-4). Tensors
    and arrays give the same result."""
    graph = cut_grid(40, 56, seed, (8, 16, 20, 30))
    side_t, flow_t = tnative.grid_mincut_native(*graph)
    side_j, flow_j = jnative.grid_mincut_native(*graph)
    np.testing.assert_array_equal(side_t, side_j)
    assert flow_t == flow_j
    exact = max_flow_value(*graph)
    assert abs(flow_t - exact) <= 1e-3 * max(1.0, exact)
    side_tt, flow_tt = tnative.grid_mincut_native(
        *(torch.from_numpy(a) for a in graph))
    np.testing.assert_array_equal(side_tt, side_t)
    assert flow_tt == flow_t


def test_build_goes_to_the_build_directory():
    """The shared object lives in build/native/, named by a hash of the
    source and flags; native/ holds none of the port's."""
    tnative.grid_mincut_native(*cut_grid(8, 8, 0, (2, 3, 2, 3)))
    built = list(tnative.BUILD_DIR.glob("libspt_mincut-*.so"))
    assert built and all(p.parent == tnative.BUILD_DIR for p in built)
    assert not list(tnative.SOURCE.parent.glob("libspt_mincut-*"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A source g++ refuses raises NativeUnavailable with the compiler's
    message; there is no fallback to another solver."""
    bad = tmp_path / "mincut.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(tnative.NativeUnavailable, match="g\\+\\+"):
        tnative.grid_mincut_native(*cut_grid(8, 8, 0, (2, 3, 2, 3)))


def _loop(tmp_path, n=4, size=320):
    """``n`` views of the fixture loop and their true geometry as a JAX
    StitchResult (pure yaw, 30-degree steps)."""
    import cv2
    from simplepanorama_tpu_torch.fixtures import fkh360_views
    paths, yaws, f = fkh360_views(n, size, out_dir=str(tmp_path))
    imgs = [cv2.imread(p) for p in paths]
    Rs = [np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]) for a in np.radians(yaws)]
    K = np.array([[f, 0, size // 2], [0, f, size // 2], [0, 0, 1.0]])
    adj = np.zeros((n, n))
    for i in range(n - 1):
        adj[i, i + 1] = 0.5
    res = JStitchResult(
        rot=np.stack(Rs), K=np.stack([K] * n), adj=adj,
        connectivity=np.ones(n), order=[(0, -1)] + [(i, i - 1)
                                                   for i in range(1, n)],
        nodes=list(range(n)), center=0, sizes=[(size, size)] * n)
    return imgs, res


def test_set_config_cut_seams_match_jax(tmp_path):
    """set_config(Config(cut=True)) on the CPU in both packages, on one
    StitchResult of 4 views: both run the host loop with the Dinic
    solver. Tolerance: seam masks equal on >= 99.99% of the blocks'
    pixels (measured: all but 1 of 454,656; the warped pixels differ in
    the last bits of float32 (test_torch_modules.py: 1.6e-3 on 0..255),
    so a capacity can differ in its last bit and a tied min cut fall on
    the neighbouring pixel), and previews with NCC >= 0.999."""
    imgs, res = _loop(tmp_path)
    pj = jstitcher.set_config(res, imgs, JConfig(cut=True))
    pt = tstitcher.set_config(stitch_result_from_numpy(res), imgs,
                              TConfig(cut=True), device="cpu")
    sj = np.asarray(pj.state.seam_masks)
    st = pt.state.seam_masks.numpy()
    assert st.shape == sj.shape and sj.any()
    assert (st == sj).mean() >= 0.9999, (st != sj).sum()
    prev_j = jstitcher.render_preview(pj, JConfig(cut=True))
    prev_t = tstitcher.render_preview(pt, TConfig(cut=True))
    a = prev_j.astype(np.float64).ravel() - prev_j.mean()
    b = prev_t.astype(np.float64).ravel() - prev_t.mean()
    assert (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()) >= 0.999


def test_stage_functions_need_a_card_for_cuda(tmp_path):
    """The five stage functions run on the card unless asked: with no GPU,
    their default raises (the check of pipeline._checked_device), and
    device="cpu" runs."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default does not raise")
    from simplepanorama_tpu_torch import features, stitch
    from simplepanorama_tpu_torch.render import compose, projection
    imgs, res = _loop(tmp_path, n=2)
    r = stitch_result_from_numpy(res)
    args = ("spherical", float(r.K[0][0, 0]), imgs, list(r.rot), list(r.K),
            [1.0, 1.0])
    calls = [
        lambda **kw: features.extract_features(imgs, TConfig(init_size=320),
                                               **kw),
        lambda **kw: compose.warp_all(*args, **kw),
        lambda **kw: projection.get_proj_parameters(*args, **kw)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    from simplepanorama_tpu_torch.adjacency import build_adjacency
    from simplepanorama_tpu_torch.geometry.graph import connected_components
    feats = features.extract_features(imgs, TConfig(init_size=320),
                                      device="cpu")
    adjres = build_adjacency(feats, [(320, 320)] * 2, TConfig())
    comp = connected_components(adjres.adj)[0]
    for call in (lambda **kw: stitch.build_ba_data(comp, adjres, **kw),
                 lambda **kw: stitch.bundle_adjust_stitching(
                     comp, adjres, [(320, 320)] * 2, 500.0,
                     TConfig(init_size=320), **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
