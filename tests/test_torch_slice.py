"""The slice end to end: JAX Panorama against the PyTorch port on the CPU.

Four 320-px views cut out of the 360-degree fixture panorama go through
``Panorama(paths).stitch(Config(cut=True, init_size=320,
RANSAC_iterations=300)).get_preview()`` in both packages, the port on
``device="cpu"`` with the JAX package's RANSAC draws injected.

The views step 20 degrees in yaw at a 45-degree field of view and roll
+-3 degrees in turn. At 30-degree steps and 60 degrees without roll the
problem is ill-conditioned at 320 px: the homography focal estimate is
degenerate for pure yaw, and the JAX package itself lands 3-11% off the
true focal. There, near-tied SIFT responses that sort in another order
(a 1e-7 float difference) permute the match tables, RANSAC with the same
draws then samples other matches, and the two packages end 3-11% apart
in focal and 6-8 degrees apart in rotation (measured). On the views
used here the same effect stays far below the bounds.
"""

import numpy as np
import pytest
import torch
import jax

import simplepanorama_tpu as J
import simplepanorama_tpu_torch as T
from simplepanorama_tpu_torch.fixtures import fkh360_views
from simplepanorama_tpu_torch import native

torch.set_num_threads(2)


def _jax_draws(n):
    """The JAX package's per-pair RANSAC uniforms (adjacency._pair_keys,
    homography.ransac_homography), for the port's draw hook."""
    master = jax.random.PRNGKey(0)

    def draws(i, j, n_iter, m):
        key = jax.random.fold_in(master, i * n + j)
        return np.array(jax.random.uniform(key, (n_iter, m)))
    return draws


@pytest.fixture(scope="module")
def stitched(tmp_path_factory):
    out = tmp_path_factory.mktemp("views")
    paths, yaws, f_true = fkh360_views(4, 320, yaw_step_deg=20.0,
                                       hfov_deg=45.0, roll_deg=3.0,
                                       out_dir=str(out))
    cfg = dict(cut=True, init_size=320, RANSAC_iterations=300)
    pj = J.Panorama(paths).stitch(J.Config(**cfg))
    prev_j = pj.get_preview()
    calls = []
    ref = native.grid_mincut_native

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return ref(*a, **kw)
    native.grid_mincut_native = counted
    try:
        pt = T.Panorama(paths, device="cpu")
        pt.pair_draws = _jax_draws(len(paths))
        pt.stitch(T.Config(**cfg))
        prev_t = pt.get_preview()
    finally:
        native.grid_mincut_native = ref
    return pj, prev_j, pt, prev_t, f_true, calls


def test_slice_connected_and_cut(stitched):
    """Both packages connect all 4 views; the port ran one min-cut per
    image after the first, through the native Dinic solver on the CPU
    (the host loop render/graphcut.graph_cut, as the JAX package)."""
    pj, _, pt, _, _, calls = stitched
    assert tuple(pt.connected) == tuple(pj.connected) == (4, 4)
    assert len(calls) == 3
    seams = pt.stitch_params.state.seam_masks
    masks = pt.stitch_params.state.masks
    assert seams.dtype == torch.bool and seams.shape == masks.shape
    assert not (seams & ~masks).any()


def test_slice_focals_match_jax(stitched):
    """Focals within 1e-3 relative of the JAX package's (measured 8.3e-5)
    and within 2% of the true focal (measured 0.6%)."""
    pj, _, pt, _, f_true, _ = stitched
    fj, ft = pj.result.K[:, 0, 0], pt.result.K[:, 0, 0]
    np.testing.assert_allclose(ft, fj, rtol=1e-3)
    assert np.abs(ft / f_true - 1.0).max() < 0.02


def test_slice_rotations_match_jax(stitched):
    """Camera rotations within 0.1 degree of the JAX package's (measured
    0.0042 degree)."""
    pj, _, pt, _, _, _ = stitched
    for Ra, Rb in zip(pj.result.rot, pt.result.rot):
        c = np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)
        assert np.degrees(np.arccos(c)) < 0.1


def test_slice_preview_matches_jax(stitched):
    """The uint8 previews: same shape, NCC >= 0.99 (measured 0.99968),
    and the preview fills > 0.9 of its bounding box."""
    _, prev_j, _, prev_t, _, _ = stitched
    assert prev_t.dtype == np.uint8 and prev_t.shape == prev_j.shape
    a = prev_j.astype(np.float64).ravel()
    b = prev_t.astype(np.float64).ravel()
    a -= a.mean()
    b -= b.mean()
    assert (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()) >= 0.99
    nz = prev_t.max(axis=2) > 0
    ys, xs = np.nonzero(nz)
    assert nz[ys.min():ys.max() + 1, xs.min():xs.max() + 1].mean() > 0.9


def test_slice_seams_match_jax(stitched):
    """The graph-cut seams of both packages, each from its own stitch
    (both run the host loop with the Dinic solver on the CPU). The two
    BAs differ in the last digits (focals 8.3e-5 apart), so the warped
    blocks, and with them the seam graphs, differ slightly. Tolerance:
    the same block shape, seams equal on >= 99% of pixels (measured
    99.45%; on one StitchResult they agree on all but one pixel,
    tests/test_torch_native.py)."""
    pj, _, pt, _, _, _ = stitched
    sj = np.asarray(pj.stitch_params.state.seam_masks)
    st = pt.stitch_params.state.seam_masks.numpy()
    assert st.shape == sj.shape
    assert (st == sj).mean() >= 0.99
