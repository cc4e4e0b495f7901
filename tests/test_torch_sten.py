"""The port's stereographic centre fix against the JAX package, on the
CPU.

One known-geometry StitchResult, with no SIFT, RANSAC or BA: a 12-view
360-degree loop of 300-px pure-yaw views (fixtures.fkh360_views, 60-degree
field of view) with their true yaws and focal. Its little planet has a
hole at the centre, enclosed by the content, so the fix triggers.
"""

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import _center_dark as center_dark
from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import io as jio
from simplepanorama_tpu import stitcher as jstitcher
from simplepanorama_tpu.config import Projection as JProjection
from simplepanorama_tpu.render import blending as jblend
from simplepanorama_tpu.render import compose as jcomp
from simplepanorama_tpu.render import projection as jproj
from simplepanorama_tpu.render import sten_fix as jsten
from simplepanorama_tpu.stitch import StitchResult as JStitchResult
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import cli as tcli
from simplepanorama_tpu_torch import io as tio
from simplepanorama_tpu_torch import stitcher as tstitcher
from simplepanorama_tpu_torch.config import Projection as TProjection
from simplepanorama_tpu_torch.convert import stitch_result_from_numpy
from simplepanorama_tpu_torch.fixtures import fkh360_views
from simplepanorama_tpu_torch.render import blending as tblend
from simplepanorama_tpu_torch.render import compose as tcomp
from simplepanorama_tpu_torch.render import projection as tproj
from simplepanorama_tpu_torch.render import sten_fix as tsten
from simplepanorama_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

N_VIEWS = 12


def _result(f, size):
    """The loop's true geometry as the BA would hand it over: R = rot_y(yaw)
    (the convention of tests/test_torch_fullres.py), K with the true focal
    and the integer-half principal point."""
    Rs = []
    for k in range(N_VIEWS):
        a = np.radians(30.0 * k)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    K = np.array([[f, 0, size // 2], [0, f, size // 2], [0, 0, 1.0]])
    adj = np.zeros((N_VIEWS, N_VIEWS))
    for i in range(N_VIEWS):
        j = (i + 1) % N_VIEWS
        adj[min(i, j), max(i, j)] = 0.5
    return JStitchResult(
        rot=np.stack(Rs), K=np.stack([K] * N_VIEWS), adj=adj,
        connectivity=np.ones(N_VIEWS),
        order=[(0, -1)] + [(i, i - 1) for i in range(1, N_VIEWS)],
        nodes=list(range(N_VIEWS)), center=0,
        sizes=[(size, size)] * N_VIEWS)


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The 300-px views, the 600-px full-res views of the same loop, and
    the geometry at 300 px."""
    out = tmp_path_factory.mktemp("sten")
    paths, _, f = fkh360_views(N_VIEWS, 600, out_dir=str(out / "full"))
    full = [cv2.imread(p) for p in paths]
    imgs = [cv2.resize(im, (300, 300), interpolation=cv2.INTER_AREA)
            for im in full]
    return imgs, full, _result(f * 300 / 600, 300), paths


def _sten(fix=True, **kw):
    return (JConfig(proj=JProjection.STEREOGRAPHIC, fix_center=fix, **kw),
            TConfig(proj=TProjection.STEREOGRAPHIC, fix_center=fix, **kw))


@pytest.fixture(scope="module")
def warped(loop):
    """The stereographic warp of the loop (JAX package), as per-image
    lists: the input of the fix."""
    imgs, _, res, _ = loop
    f = float(res.K[0, 0, 0])
    st = jcomp.warp_all("stereographic", f, imgs, list(res.rot),
                        list(res.K), list(res.connectivity))
    im, mk = np.asarray(st.imgs), np.asarray(st.masks)
    lists = ([im[b, :rh, :rw] for b, (_, _, rw, rh) in enumerate(st.rois)],
             [mk[b, :rh, :rw] for b, (_, _, rw, rh) in enumerate(st.rois)],
             [(r[0], r[1]) for r in st.rois])
    return lists, tcomp.warp_all("stereographic", f, imgs, list(res.rot),
                                 list(res.K), list(res.connectivity),
                                 device="cpu")


@pytest.fixture(scope="module")
def previews(loop):
    """set_config + render_preview of both packages, with the fix."""
    imgs, _, res, _ = loop
    cj, ct = _sten()
    pj = jstitcher.set_config(res, imgs, cj)
    pt = tstitcher.set_config(stitch_result_from_numpy(res), imgs, ct,
                              device="cpu")
    return (pj, np.asarray(jstitcher.render_preview(pj, cj)),
            pt, tstitcher.render_preview(pt, ct))


def _agree(a, b, max_frac, max_mean, tol=3):
    """tests/test_fullres.py:57-65: the share of pixels that differ by
    more than ``tol`` levels, and the mean absolute difference."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    frac = float((diff > tol).mean())
    mean = float(diff.mean())
    assert frac < max_frac, f"{frac:.4%} pixels differ by >{tol}"
    assert mean < max_mean, f"mean abs diff {mean:.3f}"
    return frac, mean


@pytest.mark.parametrize("source", ["jax_warp", "port_warp"])
def test_estimate_circle_matches_jax(warped, source):
    """estimate_circle of the port on the JAX package's warp and on its
    own warp, against the JAX estimate on the JAX warp. Tolerance: equal
    centre and radius (measured equal: ((-1, -1), 161.398...))."""
    (imgs, masks, corners), st = warped
    want = jsten.estimate_circle(masks, corners)
    assert want is not None
    if source == "jax_warp":
        got = tsten.estimate_circle([torch.from_numpy(np.array(m)) for m in masks],
                                    corners)
    else:
        params = tstitcher.StitchParams(
            res=None, rot=None, proj_kind="stereographic", scale=1.0,
            state=st)
        p_imgs, p_masks, p_corners = params._lists()
        assert p_corners == corners
        assert [tuple(m.shape) for m in p_masks] == [m.shape for m in masks]
        assert [tuple(i.shape) for i in p_imgs] == [i.shape for i in imgs]
        got = tsten.estimate_circle(p_masks, p_corners)
    assert got == want


def test_get_proj_parameters_matches_jax(loop):
    """get_proj_parameters (the per-image warp that the full-res render
    of the fix starts from) on 4 of the 600-px views. Tolerance: equal
    corners and crop shapes; masks differ on at most 0.1% of pixels
    (measured 2.5e-4: single pixels at the mask edge, where f32
    trigonometry in another float order crosses a bound); pixels within
    0.05 levels where both masks hold (measured 0.011)."""
    _, full, res, _ = loop
    K2 = np.array(res.K[:4], np.float64)
    K2[:, :2] *= 2.0
    args = ("stereographic", float(K2[0, 0, 0]), full[:4], list(res.rot[:4]),
            list(K2), [1, 1, 1, 1])
    pj = jproj.get_proj_parameters(*args)
    pt = tproj.get_proj_parameters(*args, device="cpu")
    assert pt.corners == [tuple(c) for c in pj.corners]
    flips = total = 0
    worst = 0.0
    for a, b, ma, mb in zip(pj.imgs, pt.imgs, pj.masks, pt.masks):
        assert tuple(b.shape) == a.shape and tuple(mb.shape) == ma.shape
        mb = mb.numpy()
        flips += int((mb != ma).sum())
        total += ma.size
        both = ma & mb
        worst = max(worst, np.abs(b.numpy()[both] - a[both]).max())
    assert flips / total <= 1e-3 and worst <= 0.05


@pytest.mark.parametrize("method", ["MULTI_BLEND", "SIMPLE_BLEND",
                                    "NO_BLEND"])
def test_blend_lists_match_jax(warped, method):
    """blending.blend (pack_blocks, then the packed blends) on the
    per-image lists of the stereographic warp, footprints as seams.
    Tolerance: same shape, at most 1 level apart after the uint8 cast on
    at most 0.5% of pixels, as tests/test_torch_modules.py's
    test_blend_dev_matches_jax (measured: 1 level on 5.7e-6 of the
    pixels for MULTI_BLEND, 1.7e-4 for SIMPLE_BLEND, none for
    NO_BLEND)."""
    (imgs, masks, corners), _ = warped
    oj = np.clip(jblend.blend(method, imgs, masks, masks, corners), 0, 255)
    ot = np.clip(tblend.blend(method, [torch.from_numpy(np.array(i))
                                       for i in imgs],
                              [torch.from_numpy(np.array(m))
                               for m in masks],
                              [np.array(m) for m in masks], corners), 0, 255)
    assert ot.shape == oj.shape
    diff = np.abs(ot.astype(np.uint8).astype(np.int32)
                  - oj.astype(np.uint8).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3


def test_disk_reproj_matches_jax(warped):
    """disk_reproj of both packages on the same (JAX) warp. Tolerance:
    equal corners, ansatz and box shapes; masks differ on at most 0.05%
    of pixels (measured: none); pixels within a mean of 0.01 levels where
    both masks hold (measured 1.2e-4), at most 0.1 levels (measured
    7.2e-3): f32 atan2/cos/sin in another float order. The port's
    sources are padded to the JAX package's shape (the largest unpadded
    ROI), so the taps are clipped alike and the masks agree."""
    (imgs, masks, corners), _ = warped
    (cx, cy), r = jsten.estimate_circle(masks, corners)
    ij, mj, cj, aj = jsten.disk_reproj(imgs, masks, corners, (cx, cy), r,
                                       True)
    it, mt, ct, at = tsten.disk_reproj(
        [torch.from_numpy(np.array(i)) for i in imgs],
        [torch.from_numpy(np.array(m)) for m in masks], corners, (cx, cy),
        r, True)
    assert ct == cj and at == aj
    diffs, flips, total = [], 0, 0
    for a, b, ma, mb in zip(ij, it, mj, mt):
        assert tuple(b.shape) == a.shape and tuple(mb.shape) == ma.shape
        ma, mb = np.asarray(ma), mb.numpy()
        flips += int((ma != mb).sum())
        total += ma.size
        both = ma & mb
        diffs.append(np.abs(b.numpy()[both] - np.asarray(a)[both]))
    d = np.concatenate(diffs)
    assert flips / total <= 5e-4
    assert d.mean() <= 0.01 and d.max() <= 0.1


def test_set_config_preview_matches_jax(previews):
    """set_config + render_preview with the fix, on the same result.
    Tolerance: equal sten_circle, min_xy, canvas and block shapes;
    the preview within tests/test_torch_fullres.py's _agree at its
    tightest (under 0.01% of pixels more than 1 level apart, mean under
    0.01; measured 8.1e-6 and 1.1e-3)."""
    pj, prev_j, pt, prev_t = previews
    assert pt.sten_circle is not None
    (aj, rj), (at, rt) = pj.sten_circle, pt.sten_circle
    assert tuple(at) == tuple(aj) and rt == rj
    assert pt.state.min_xy == tuple(pj.state.min_xy)
    assert pt.state.canvas_hw == tuple(pj.state.canvas_hw)
    assert tuple(pt.state.masks.shape) == tuple(pj.state.masks.shape)
    assert pt.state.rois == [tuple(r) for r in pj.state.rois]
    _agree(prev_j, prev_t, max_frac=1e-4, max_mean=0.01, tol=1)
    assert center_dark(prev_t) < 0.10


def test_fix_center_false_leaves_the_hole(loop, previews):
    """Without the fix the centre of the little planet stays dark in
    both packages, and sten_circle stays None. Tolerance: a centre-dark
    share over 0.4 and within 0.01 of the JAX package's (measured 0.839
    in both; 0.0 with the fix)."""
    imgs, _, res, _ = loop
    cj, ct = _sten(fix=False)
    pj = jstitcher.set_config(res, imgs, cj)
    pt = tstitcher.set_config(stitch_result_from_numpy(res), imgs, ct,
                              device="cpu")
    assert pt.sten_circle is None and pj.sten_circle is None
    dj = center_dark(np.asarray(jstitcher.render_preview(pj, cj)))
    dt = center_dark(tstitcher.render_preview(pt, ct))
    assert dt > 0.4 and abs(dt - dj) <= 0.01
    assert center_dark(previews[3]) < 0.10


def test_render_full_matches_jax(loop, previews):
    """The full-res render (render_full_host, the dispatch of
    render_full for fix_center and STEREOGRAPHIC) from the 600-px views,
    against the JAX package's render_full_host on its own preview state.
    The circle is estimated again on the full-res masks. Tolerance: same
    shape; under 0.1% of pixels more than 1 level apart and a mean under
    0.05 (measured: none, mean 8.6e-4). The margin is for the seam masks,
    which the port upsamples with the cv2-aligned matrices of
    render/fullres.py, whose cubic rows are renormalised at the block
    edge where cv2 replicates the border."""
    _, full, _, _ = loop
    pj, _, pt, _ = previews
    cj, ct = _sten()
    oj = np.asarray(jstitcher.render_full_host(pj, cj, full))
    ot = tstitcher.render_full(pt, ct, full)
    _agree(oj, ot, max_frac=1e-3, max_mean=0.05, tol=1)
    assert center_dark(ot) < 0.10


def test_cylinder_prewarp_matches_jax(loop):
    """io.cylinder_prewarp (in the port's io.py since it was copied) on
    one view: equal to the JAX package's."""
    view = loop[1][0]
    for focal in (300.0, 520.0):
        np.testing.assert_array_equal(tio.cylinder_prewarp(view, focal),
                                      jio.cylinder_prewarp(view, focal))


def test_cli_little_planet_from_state(loop, previews, tmp_path):
    """The CLI with ``--proj STEREOGRAPHIC`` (fix_center at its default,
    on) on the CPU, resumed from a checkpoint of the loop's geometry:
    both commands return 0, the preview equals set_config +
    render_preview's pixel for pixel (the same images at init_size 300),
    and the full-res panorama is about 2x the preview with its centre
    closed."""
    _, _, res, paths = loop
    state = str(tmp_path / "s.npz")
    tck.save_stitch_state(state, stitch_result_from_numpy(res), paths=paths)
    common = ["--from-state", state, "--proj", "STEREOGRAPHIC",
              "--init-size", "300", "--device", "cpu", "--quiet"]
    prev_p, full_p = str(tmp_path / "p.png"), str(tmp_path / "f.png")
    assert tcli.main(common + ["-o", prev_p]) == 0
    assert tcli.main(common + ["--full-res", "-o", full_p]) == 0
    prev, full = cv2.imread(prev_p), cv2.imread(full_p)
    assert np.array_equal(prev, previews[3])
    assert abs(full.shape[0] - 2 * prev.shape[0]) <= 8
    assert abs(full.shape[1] - 2 * prev.shape[1]) <= 8
    assert center_dark(full) < 0.10


@pytest.mark.slow
def test_jax_little_planet_sets_the_slice5_gate(tmp_path):
    """The reference behind chip_smoke.py's slice-5 NCC gate: the JAX
    package's own little planet of the loop that the slice5 phase
    stitches on the card (12 pure-yaw views of 1400 px, preview at 700)
    with its true geometry, on the CPU. The full-res render estimates the
    circle again on the full-res masks, so with the fix its NCC against
    the preview (common footprint) stays under 0.95, and the gate sits at
    least 0.02 below it; without the fix the two agree to 0.95. Prints
    one JSON line (``-s`` shows it)."""
    import json
    import chip_smoke
    paths, _, f = fkh360_views(N_VIEWS, 1400, out_dir=str(tmp_path))
    full = [cv2.imread(p) for p in paths]
    imgs = [cv2.resize(im, (700, 700), interpolation=cv2.INTER_AREA)
            for im in full]
    res = _result(f * 700 / 1400, 700)
    out = {}
    for fix in (True, False):
        cj, _ = _sten(fix)
        pj = jstitcher.set_config(res, imgs, cj)
        prev = np.asarray(jstitcher.render_preview(pj, cj))
        small = cv2.resize(np.asarray(jstitcher.render_full(pj, cj, full)),
                           (prev.shape[1], prev.shape[0]),
                           interpolation=cv2.INTER_AREA)
        out[fix] = chip_smoke._ncc_common(prev, small)
    print(json.dumps({"ncc_fix": out[True], "ncc_no_fix": out[False],
                      "gate": chip_smoke.SLICE5_FIXED_NCC_GATE}))
    assert out[True] - 0.02 >= chip_smoke.SLICE5_FIXED_NCC_GATE
    assert out[False] >= 0.95
