"""Parity of the PyTorch port's modules with the JAX package, on the CPU.

Each test feeds the same numpy inputs, made from a fixed seed, to a JAX
function and to its counterpart in simplepanorama_tpu_torch, and states
its tolerance as the measured difference plus a margin. Float32 sums are
taken in another order by XLA's and PyTorch's CPU kernels, which is where
the non-zero differences come from.
"""

import cv2
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import ba as jba
from simplepanorama_tpu import stitcher as jstitcher
from simplepanorama_tpu.stitch import StitchResult as JStitchResult
from simplepanorama_tpu.geometry import rotation as jrot
from simplepanorama_tpu.ops import edt as jedt
from simplepanorama_tpu.ops import homography as jhom
from simplepanorama_tpu.ops import matching as jmat
from simplepanorama_tpu.ops import polygon as jpoly
from simplepanorama_tpu.ops import sift as jsift
from simplepanorama_tpu.render import blending as jblend
from simplepanorama_tpu.render import compose as jcomp
from simplepanorama_tpu.render import projection as jproj
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import adjacency as tadj
from simplepanorama_tpu_torch import stitcher as tstitcher
from simplepanorama_tpu_torch import ba as tba
from simplepanorama_tpu_torch.convert import (compose_state_from_numpy,
                                              stitch_result_from_numpy)
from simplepanorama_tpu_torch.fixtures import FKH360
from simplepanorama_tpu_torch.geometry import rotation as trot
from simplepanorama_tpu_torch.ops import edt as tedt
from simplepanorama_tpu_torch.ops import homography as thom
from simplepanorama_tpu_torch.ops import matching as tmat
from simplepanorama_tpu_torch.ops import polygon as tpoly
from simplepanorama_tpu_torch.ops import sift as tsift
from simplepanorama_tpu_torch.render import blending as tblend
from simplepanorama_tpu_torch.render import compose as tcomp
from simplepanorama_tpu_torch.render import projection as tproj

torch.set_num_threads(2)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _crops():
    """Two 136x200 BGR crops of the 360-degree fixture panorama."""
    pano = cv2.imread(str(FKH360))
    return np.stack([pano[60:196, 0:200], pano[60:196, 900:1100]])


# ---------------------------------------------------------------- SIFT


def test_sift_upscale_and_pyramid_match_jax():
    """The x2 linear upscale (F.interpolate vs jax.image.resize) and the
    Gaussian pyramid. Tolerance: upscale 1e-4 absolute on 0..255 (measured
    exact); pyramid levels 2e-3 absolute (measured 7.6e-5: a 17-tap
    float32 convolution summed in another order)."""
    gray = _crops()[..., 1].astype(np.float32)
    N, H, W = gray.shape
    up_j = np.asarray(jax.image.resize(jnp.asarray(gray), (N, 2 * H, 2 * W),
                                       "linear"))
    up_t = torch.nn.functional.interpolate(
        torch.from_numpy(gray)[:, None], size=(2 * H, 2 * W),
        mode="bilinear", align_corners=False)[:, 0].numpy()
    assert np.abs(up_t - up_j).max() <= 1e-4
    pyr_j = jsift.build_pyramid_batch(jnp.asarray(gray), 1.4142, 4, 3)
    pyr_t = tsift.build_pyramid_batch(torch.from_numpy(gray), 1.4142, 4, 3)
    assert len(pyr_j) == len(pyr_t)
    for a, b in zip(pyr_j, pyr_t):
        assert tuple(a.shape) == tuple(b.shape)
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 2e-3


def test_sift_dense_refine_matches_jax():
    """Dense sub-pixel refinement of one DoG stack. Tolerance: offsets
    within 1e-3 and responses within 1e-6 wherever both accept, accept
    maps differing on at most 0.01% of the cells (measured: all exact;
    the margin covers another float order of the cofactor solve)."""
    gray = _crops()[:1, ..., 1].astype(np.float32)
    pyr = jsift.build_pyramid_batch(jnp.asarray(gray), 1.4142, 4, 1)[0]
    dog = np.asarray(pyr[:, 1:] - pyr[:, :-1])
    out_j = [np.asarray(a) for a in jsift._dense_refine(
        jnp.asarray(dog[0]), 4, 0.03, 6.0)]
    out_t = [a[0].numpy() for a in tsift._dense_refine(
        torch.from_numpy(dog), 4, 0.03, 6.0)]
    ok_j, ok_t = out_j[0], out_t[0]
    assert (ok_j != ok_t).mean() <= 1e-4
    both = ok_j & ok_t
    assert both.sum() > 10
    for k in (1, 2, 3):
        assert np.abs(out_t[k][both] - out_j[k][both]).max() <= 1e-3
    assert np.abs(out_t[4][both] - out_j[4][both]).max() <= 1e-6


def test_extract_sift_batch_matches_jax():
    """Whole SIFT on a 2-image batch. Near-tied responses may come out in
    another order, so keypoints are paired by position. Tolerance: the
    same number of valid keypoints; every JAX keypoint has a port
    keypoint within 1e-2 px (measured 3.3e-4); paired descriptors within
    2e-3 (measured 2.7e-4: gradients are rounded to bfloat16 on both
    sides, and a float32 difference can flip one rounding)."""
    imgs = _crops()
    hw = np.array([imgs.shape[1:3]] * 2, np.int32)
    fj = jsift.extract_sift_batch(jnp.asarray(imgs), jnp.asarray(hw),
                                  max_kp=256)
    ft = tsift.extract_sift_batch(torch.from_numpy(imgs),
                                  torch.from_numpy(hw.astype(np.int64)),
                                  max_kp=256)
    for i in range(2):
        vj, vt = np.asarray(fj.valid[i]), ft.valid[i].numpy()
        assert vj.sum() == vt.sum() and vj.sum() > 50
        xj, xt = np.asarray(fj.xy[i])[vj], ft.xy[i].numpy()[vt]
        d = np.abs(xj[:, None, :] - xt[None, :, :]).max(-1)
        nn = d.argmin(1)
        assert d.min(1).max() <= 1e-2
        dj = np.asarray(fj.desc[i])[vj]
        dt = ft.desc[i].numpy()[vt][nn]
        assert np.abs(dt - dj).max() <= 2e-3


# ---------------------------------------------------------------- matching


def test_match_pair_batch_matches_jax():
    """2-NN ratio matching on unit descriptors, 30% of the queries being
    noisy copies of train descriptors. Tolerance: exact (same match
    tables and counts; measured exact)."""
    rng = np.random.default_rng(0)
    B, K = 2, 96
    dt = rng.normal(size=(B, K, 128)).astype(np.float32)
    dq = rng.normal(size=(B, K, 128)).astype(np.float32)
    dq[:, :30] = dt[:, 10:40] + 0.1 * rng.normal(size=(B, 30, 128))
    dq /= np.linalg.norm(dq, axis=-1, keepdims=True)
    dt /= np.linalg.norm(dt, axis=-1, keepdims=True)
    vq = rng.uniform(size=(B, K)) > 0.1
    vt = rng.uniform(size=(B, K)) > 0.1
    out_j = jmat.match_pair_batch(*(jnp.asarray(a) for a in (dq, dt, vq, vt)),
                                  match_cap=64)
    out_t = tmat.match_pair_batch(*(torch.from_numpy(a)
                                    for a in (dq, dt, vq, vt)), match_cap=64)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(out_t[2].sum()) > 20


def test_default_pair_draws_depend_on_the_pair_only():
    """The pipeline's default RANSAC draws (adjacency.torch_pair_draws):
    a CPU generator seeded by the pair's linear index, so a pair draws the
    same uniforms whatever batch verifies it and on every device."""
    draws = tadj.torch_pair_draws(0, 4, "cpu")
    g = torch.Generator()
    g.manual_seed(1 * 4 + 2)
    np.testing.assert_array_equal(draws(1, 2, 5, 7).numpy(),
                                  torch.rand((5, 7), generator=g).numpy())
    assert not torch.equal(draws(1, 3, 5, 7), draws(1, 2, 5, 7))


# ---------------------------------------------------------------- homography


def _matches(rng, M=128, n_good=80):
    """Matches of a known homography plus uniform outliers."""
    H = np.array([[1.02, 0.03, 40.0], [-0.02, 0.98, -12.0],
                  [1e-5, -2e-5, 1.0]])
    t = rng.uniform(-150, 150, (M, 2))
    th = np.concatenate([t, np.ones((M, 1))], 1) @ H.T
    q = th[:, :2] / th[:, 2:] + rng.normal(0, 0.5, (M, 2))
    q[n_good:] = rng.uniform(-150, 150, (M - n_good, 2))
    valid = np.arange(M) < M - 10
    return q.astype(np.float32), t.astype(np.float32), valid


def test_ransac_homography_with_injected_draws_matches_jax():
    """RANSAC with JAX's threefry uniforms fed to the port. Tolerance: H
    within 1e-3 relative + 1e-6 absolute (measured 7.2e-6 relative on the
    first two rows, 3.7e-9 absolute on the perspective terms: the DLT
    normal equations in another float order) and identical inlier masks
    (measured exact)."""
    rng = np.random.default_rng(1)
    n_iter = 200
    qs, ts, vs, Hj, Ij, draws = [], [], [], [], [], []
    for b in range(2):
        q, t, v = _matches(rng)
        key = jax.random.PRNGKey(b)
        H, inl = jhom.ransac_homography(
            jnp.asarray(q), jnp.asarray(t), jnp.asarray(v),
            jnp.array([300, 300]), jnp.array([300, 300]), key, n_iter=n_iter)
        draws.append(np.asarray(jax.random.uniform(key, (n_iter, len(q)))))
        qs.append(q), ts.append(t), vs.append(v)
        Hj.append(np.asarray(H)), Ij.append(np.asarray(inl))
    hw = torch.full((2, 2), 300, dtype=torch.int64)
    Ht, It = thom.ransac_homography(
        torch.from_numpy(np.stack(qs)), torch.from_numpy(np.stack(ts)),
        torch.from_numpy(np.stack(vs)), hw, hw,
        torch.from_numpy(np.stack(draws)))
    for b in range(2):
        np.testing.assert_allclose(Ht[b].numpy(), Hj[b], rtol=1e-3,
                                   atol=1e-6)
        np.testing.assert_array_equal(It[b].numpy(), Ij[b])
        assert Ij[b].sum() >= 70


def test_dlt_and_sanity_match_jax():
    """dlt_homography on jittered 4-point squares (no three points near
    a line, so the solve is well conditioned) and hom_sanity on perturbed
    homographies. Tolerance: H within 1e-3 relative + 1e-6 (measured
    3.7e-5 relative); sanity verdicts exact."""
    rng = np.random.default_rng(2)
    square = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * 100.0
    q = (square + rng.normal(0, 10, (16, 4, 2))).astype(np.float32)
    t = (q + rng.normal(0, 5, q.shape)).astype(np.float32)
    Hj = np.asarray(jax.vmap(jhom.dlt_homography)(jnp.asarray(q),
                                                  jnp.asarray(t)))
    Ht = thom.dlt_homography(torch.from_numpy(q), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(Ht, Hj, rtol=1e-3, atol=1e-6)
    Hs = (np.eye(3) + rng.normal(0, 0.3, (64, 3, 3)) * [[1, 1, 100],
                                                        [1, 1, 100],
                                                        [1e-3, 1e-3, 0]])
    Hs[::4, 0] *= -1.0                            # reflecting
    Hs[1::4, 2, :2] = 0.01                        # strong perspective
    Hs = Hs.astype(np.float32)
    hw = np.array([240, 320])
    sj = np.asarray(jax.vmap(lambda H: jhom.hom_sanity(
        H, jnp.asarray(hw), jnp.asarray(hw)))(jnp.asarray(Hs)))
    st = thom.hom_sanity(torch.from_numpy(Hs), torch.from_numpy(hw),
                         torch.from_numpy(hw)).numpy()
    np.testing.assert_array_equal(st, sj)
    assert 0 < sj.sum() < len(sj)


# ---------------------------------------------------------------- polygon


def test_overlap_stats_matches_jax():
    """Overlap fraction, keypoints and matches in the overlap for shifted
    and rotated pairs. Tolerance: fraction within 1e-5 (measured 6.0e-8);
    counts exact."""
    rng = np.random.default_rng(3)
    B, K = 6, 64
    Hs = []
    for b in range(B):
        a = rng.uniform(-0.3, 0.3)
        Hs.append([[np.cos(a), -np.sin(a), rng.uniform(-150, 150)],
                   [np.sin(a), np.cos(a), rng.uniform(-100, 100)],
                   [rng.uniform(-1e-4, 1e-4), 0, 1]])
    Hs = np.array(Hs, np.float32)
    hw1 = np.array([[240, 320]] * B)
    hw2 = np.array([[260, 300]] * B)
    kp = rng.uniform(-170, 170, (B, K, 2)).astype(np.float32)
    kv = rng.uniform(size=(B, K)) > 0.2
    mq = rng.uniform(-170, 170, (B, K, 2)).astype(np.float32)
    mv = rng.uniform(size=(B, K)) > 0.2
    out_j = [np.asarray(a) for a in jax.vmap(jpoly.overlap_stats)(
        *(jnp.asarray(a) for a in (Hs, hw1, hw2, kp, kv, mq, mv)))]
    out_t = [a.numpy() for a in tpoly.overlap_stats(
        *(torch.from_numpy(a) for a in (Hs, hw1, hw2, kp, kv, mq, mv)))]
    np.testing.assert_allclose(out_t[0], out_j[0], atol=1e-5)
    np.testing.assert_array_equal(out_t[1], out_j[1])
    np.testing.assert_array_equal(out_t[2], out_j[2])
    assert (out_j[0] > 0).sum() >= 3


# ---------------------------------------------------------------- rotation


def test_rotation_algebra_matches_jax():
    """rodrigues, orthogonalize and rotvec_from_matrix. Tolerance: 1e-5
    absolute (measured 3.9e-7)."""
    rng = np.random.default_rng(4)
    for _ in range(5):
        v = rng.normal(0, 0.8, 3).astype(np.float32)
        R = np.asarray(jrot.rodrigues(jnp.asarray(v)))
        np.testing.assert_allclose(
            trot.rodrigues(torch.from_numpy(v)).numpy(), R, atol=1e-5)
        M = (R + rng.normal(0, 0.05, (3, 3))).astype(np.float32)
        np.testing.assert_allclose(
            trot.orthogonalize(torch.from_numpy(M)).numpy(),
            np.asarray(jrot.orthogonalize(jnp.asarray(M))), atol=1e-5)
        np.testing.assert_allclose(
            trot.rotvec_from_matrix(torch.from_numpy(M)).numpy(),
            np.asarray(jrot.rotvec_from_matrix(jnp.asarray(M))), atol=1e-5)


# ---------------------------------------------------------------- BA


def _ba_problem(seed=5, n_cams=4, f=500.0, n_per_pair=60):
    """Cameras on a yaw arc; matches from the BA model H(i, j) =
    K_j R_i^T R_j K_i^-1 plus 0.3 px noise."""
    rng = np.random.default_rng(seed)
    rot = [np.array([0.02 * i, 0.3 * i, 0.01 * i]) for i in range(n_cams)]
    Rm = [np.asarray(jrot.rodrigues(jnp.asarray(r, jnp.float32)), np.float64)
          for r in rot]
    K = np.diag([f, f, 1.0])
    mi, mj, qs, ts = [], [], [], []
    for i in range(n_cams):
        for j in range(n_cams):
            if abs(i - j) != 1:
                continue
            H = K @ Rm[i].T @ Rm[j] @ np.linalg.inv(K)
            t = rng.uniform(-200, 200, (n_per_pair, 2))
            th = np.concatenate([t, np.ones((n_per_pair, 1))], 1) @ H.T
            q = th[:, :2] / th[:, 2:3]
            keep = (np.abs(q) < 250).all(1)
            q = q[keep] + rng.normal(0, 0.3, (keep.sum(), 2))
            mi += [i] * keep.sum()
            mj += [j] * keep.sum()
            qs.append(q)
            ts.append(t[keep])
    M = len(mi)
    cap = (M + 255) // 256 * 256
    pad = lambda a: np.pad(a, [(0, cap - M)] + [(0, 0)] * (a.ndim - 1))
    data = jba.with_pair_tables(jba.BAData(
        mi=jnp.asarray(pad(np.array(mi, np.int32))),
        mj=jnp.asarray(pad(np.array(mj, np.int32))),
        q=jnp.asarray(pad(np.concatenate(qs)).astype(np.float32)),
        t=jnp.asarray(pad(np.concatenate(ts)).astype(np.float32)),
        m_valid=jnp.asarray(np.arange(cap) < M)))
    rot0 = np.stack([np.zeros(3)] + [r + rng.normal(0, 0.02, 3)
                                     for r in rot[1:]]).astype(np.float32)
    return data, rot0, f


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("max_iter", [1, 50])
def test_lm_run_matches_jax(max_iter, fast):
    """LM from a perturbed start with the focal 10% off, relaxed
    objective and Lowe's (``fast``): one trial step, and the full run of
    50. Tolerance: focals within 1e-3 relative (measured 9.8e-7 relaxed,
    9.5e-7 Lowe), rotation vectors within 1e-3 (measured 1.0e-4 and
    5.9e-5 after 50 steps, 5.4e-7 and 3.6e-7 after one). Error after one
    step within 1e-5 relative (measured 3.7e-6 and 5.9e-6).
    The f32 solve amplifies the float-order difference from step to
    step, so after 50 steps, with both runs still creeping down, the
    errors differ more while the cameras agree: within 2% (measured
    0.9% relaxed, 0.06% Lowe)."""
    data, rot0, f = _ba_problem()
    n = 4
    cams_j = jba.CamState(focal=jnp.full((n,), f * 1.1, jnp.float32),
                          ppal=jnp.zeros((n, 2), jnp.float32),
                          rotvec=jnp.asarray(rot0), b=data.t)
    rj = jba.lm_run(cams_j, data, jnp.ones(n, bool), 0.05, fast=fast,
                    max_iter=max_iter)
    T = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)
    data_t = tba.BAData(
        mi=T(data.mi, torch.int64), mj=T(data.mj, torch.int64),
        q=T(data.q), t=T(data.t), m_valid=T(data.m_valid),
        pi=T(data.pi, torch.int64), pj=T(data.pj, torch.int64),
        mp=T(data.mp, torch.int64))
    cams_t = tba.CamState(focal=torch.full((n,), f * 1.1),
                          ppal=torch.zeros((n, 2)),
                          rotvec=T(rot0), b=data_t.t.clone())
    rt = tba.lm_run(cams_t, data_t, torch.ones(n, dtype=torch.bool), 0.05,
                    fast=fast, max_iter=max_iter)
    fj, ft = np.asarray(rj.cams.focal), rt.cams.focal.numpy()
    if max_iter == 50:
        assert np.abs(fj - f).max() < 0.02 * f    # the solve converged
    np.testing.assert_allclose(ft, fj, rtol=1e-3)
    np.testing.assert_allclose(rt.cams.rotvec.numpy(),
                               np.asarray(rj.cams.rotvec), atol=1e-3)
    np.testing.assert_allclose(float(rt.error), float(rj.error),
                               rtol=1e-5 if max_iter == 1 else 2e-2)
    if fast:   # the Lowe objective keeps b at the train keypoints
        assert torch.equal(rt.cams.b, data_t.t)


# ---------------------------------------------------------------- EDT


def test_distance_transform_matches_jax():
    """Jump-flooding EDT with its wrap-around access. Tolerance: exact
    (measured exact)."""
    rng = np.random.default_rng(6)
    m = np.zeros((2, 40, 72), bool)
    m[0, 4:30, 6:60] = True
    m[1] = rng.uniform(size=(40, 72)) > 0.15
    dj = np.asarray(jax.vmap(jedt.distance_transform)(jnp.asarray(m)))
    dt = tedt.distance_transform(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(dt, dj)


# ---------------------------------------------------------------- warp


def _views():
    """Two spherical-warp inputs: the fixture crops with a small relative
    yaw, K and R as the BA would hand them over."""
    imgs = [c for c in _crops()]
    f = 180.0
    Ks, Rs = [], []
    for k, im in enumerate(imgs):
        h, w = im.shape[:2]
        Ks.append(np.array([[f, 0, w // 2], [0, f, h // 2], [0, 0, 1.0]]))
        a = 0.35 * k
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    return imgs, Ks, Rs, f


@pytest.fixture(scope="module")
def warped():
    """JAX warp_all of the two views, and the port's."""
    imgs, Ks, Rs, f = _views()
    sj = jcomp.warp_all("spherical", f, imgs, Rs, Ks, [1, 1])
    st = tcomp.warp_all("spherical", f, imgs, Rs, Ks, [1, 1], device="cpu")
    return sj, st


def test_warp_all_matches_jax(warped):
    """Spherical warp of both views into packed blocks. Tolerance: same
    ROIs, offsets and canvas; masks differ on at most 0.1% of pixels
    (measured 0); pixels within 0.05 on 0..255 where both masks hold
    (measured 1.6e-3: trigonometry of the backward map in another
    float order)."""
    sj, st = warped
    assert st.rois == [tuple(r) for r in sj.rois]
    assert st.canvas_hw == tuple(sj.canvas_hw)
    np.testing.assert_array_equal(_np(st.offs), np.asarray(sj.offs))
    mj, mt = np.asarray(sj.masks), _np(st.masks)
    assert mj.shape == mt.shape and mj.shape[2] % 128 == 0
    assert (mj != mt).mean() <= 1e-3
    both = mj & mt
    assert np.abs(_np(st.imgs)[both] - np.asarray(sj.imgs)[both]).max() <= 0.05


def test_roi_and_erode_match_jax():
    """roi_for_image for each projection and erode_mask. Tolerance:
    exact (host numpy on both sides; erosion is boolean)."""
    imgs, Ks, Rs, f = _views()
    for kind in ("spherical", "cylindrical", "stereographic"):
        for K, R in zip(Ks, Rs):
            assert tproj.roi_for_image(kind, f, R, K, 136, 200) == \
                tuple(jproj.roi_for_image(kind, f, R, K, 136, 200))
    rng = np.random.default_rng(7)
    m = rng.uniform(size=(2, 30, 40)) > 0.1
    np.testing.assert_array_equal(
        tproj.erode_mask(torch.from_numpy(m), 2).numpy(),
        np.asarray(jproj.erode_mask(jnp.asarray(m), iters=2)))


# ---------------------------------------------------------------- compose


def test_exposure_fields_match_jax(warped):
    """equalize_dev and apply_intensity_dev on the warped blocks.
    Tolerance: fields within 1e-4 (measured 3.6e-7), adjusted pixels
    within 1e-2 on 0..255 (measured 6.1e-5)."""
    sj, _ = warped
    st = compose_state_from_numpy(sj, device="cpu")
    fj = np.asarray(jcomp.equalize_dev(sj.imgs, sj.masks, sj.offs,
                                       tuple(sj.canvas_hw)))
    ft = tcomp.equalize_dev(st.imgs, st.masks, st.offs, st.canvas_hw)
    assert np.abs(ft.numpy() - fj).max() <= 1e-4
    aj = np.asarray(jcomp.apply_intensity_dev(sj.imgs, jnp.asarray(fj)))
    at = tcomp.apply_intensity_dev(st.imgs, torch.from_numpy(fj)).numpy()
    assert np.abs(at - aj).max() <= 1e-2


def test_dist_cut_matches_jax(warped):
    """Distance-transform seams. Tolerance: exact (measured exact)."""
    sj, _ = warped
    st = compose_state_from_numpy(sj, device="cpu")
    cj = np.asarray(jcomp.dist_cut_dev(sj.masks, sj.offs,
                                       tuple(sj.canvas_hw)))
    ct = tcomp.dist_cut_dev(st.masks, st.offs, st.canvas_hw).numpy()
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("method", ["MULTI_BLEND", "SIMPLE_BLEND",
                                    "NO_BLEND"])
def test_blend_dev_matches_jax(warped, method):
    """blend_dev to the uint8 panorama. Tolerance: at most 1 level of
    difference on at most 0.5% of the pixels, none above 1 (measured:
    exact for all three; the margin covers a float difference that
    flips the rounding at the uint8 cast)."""
    sj, _ = warped
    seams = jcomp.dist_cut_dev(sj.masks, sj.offs, tuple(sj.canvas_hw))
    sj.seam_masks = seams
    st = compose_state_from_numpy(sj, device="cpu")
    oj = np.asarray(jcomp.blend_dev(method, sj, sj.imgs, 2, 7.0))
    ot = tcomp.blend_dev(method, st, st.imgs, 2, 7.0)
    assert ot.dtype == np.uint8 and ot.shape == oj.shape
    diff = np.abs(ot.astype(np.int32) - oj.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3


def test_multiband_pieces_match_jax():
    """_blur_batch, _blur_fixed and mb_batch_contribution on random
    blocks. Tolerance: 1e-3 absolute on 0..255 (measured 3.1e-5: a
    43-tap float32 convolution in another order); the blurred alpha
    within 1e-5 (measured 1.8e-7)."""
    rng = np.random.default_rng(8)
    imgs = rng.uniform(0, 255, (2, 24, 40, 3)).astype(np.float32)
    seams = (rng.uniform(size=(2, 24, 40)) > 0.5).astype(np.float32)
    orig = np.ones((2, 24, 40), np.float32)
    bj = np.asarray(jblend._blur_batch(jnp.asarray(imgs), 9.9, 21))
    bt = tblend._blur_batch(torch.from_numpy(imgs), 9.9, 21).numpy()
    assert np.abs(bt - bj).max() <= 1e-3
    fj = np.asarray(jblend._blur_fixed(jnp.asarray(imgs[0]), 7.0, 21))
    ft = tblend._blur_fixed(torch.from_numpy(imgs[0]), 7.0, 21).numpy()
    assert np.abs(ft - fj).max() <= 1e-3
    cj, aj = jblend.mb_batch_contribution(*(jnp.asarray(a) for a in
                                            (imgs, seams, orig)), 2, 7.0)
    ct, at = tblend.mb_batch_contribution(*(torch.from_numpy(a) for a in
                                            (imgs, seams, orig)), 2, 7.0)
    assert np.abs(ct.numpy() - np.asarray(cj)).max() <= 1e-3
    assert np.abs(at.numpy() - np.asarray(aj)).max() <= 1e-5


# ---------------------------------------------------------------- stitcher


@pytest.mark.parametrize("cut", [False, True])
def test_set_config_on_jax_result_matches_jax(cut):
    """set_config + render_preview of both packages on one JAX
    StitchResult (the port's copy made by stitch_result_from_numpy): the
    compositing half of the pipeline without RANSAC or BA in the way.
    cut=False is the default config (distance-transform seams); cut=True
    the graph cut, for which both packages run the host Dinic solver on
    the CPU, and a min cut may tie.
    Tolerance: same preview shape, NCC >= 0.999 (measured 1 - 6e-9 for
    both; no pixel differs by more than 1 level)."""
    imgs, Ks, Rs, f = _views()
    res = JStitchResult(
        rot=np.stack(Rs), K=np.stack(Ks), adj=np.array([[0, 0.5], [0, 0]]),
        connectivity=np.array([1, 1]), order=[(0, -1), (1, 0)],
        nodes=[0, 1], center=0, sizes=[im.shape[:2] for im in imgs])
    pj = jstitcher.set_config(res, imgs, JConfig(cut=cut))
    prev_j = jstitcher.render_preview(pj, JConfig(cut=cut))
    pt = tstitcher.set_config(stitch_result_from_numpy(res), imgs,
                              TConfig(cut=cut), device="cpu")
    prev_t = tstitcher.render_preview(pt, TConfig(cut=cut))
    assert prev_t.dtype == np.uint8 and prev_t.shape == prev_j.shape
    a = prev_j.astype(np.float64).ravel() - prev_j.mean()
    b = prev_t.astype(np.float64).ravel() - prev_t.mean()
    ncc = (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum())
    assert ncc >= 0.999


# ---------------------------------------------------------------- helpers


def test_model_homography_and_pair_tables_match_jax():
    """ba.model_homography and ba.with_pair_tables on _ba_problem's
    tables. Tolerance: H within 1e-5 relative of the JAX package's
    (float32, the same chain); the pair tables equal."""
    data, rot0, f = _ba_problem()
    cams_j = jba.CamState(focal=jnp.full((4,), f, jnp.float32),
                          ppal=jnp.zeros((4, 2), jnp.float32),
                          rotvec=jnp.asarray(rot0), b=data.t)
    cams_t = tba.CamState(torch.full((4,), f), torch.zeros((4, 2)),
                          torch.from_numpy(rot0), torch.zeros((1, 2)))
    for i, j in ((0, 1), (2, 1), (3, 0)):
        Hj = np.asarray(jba.model_homography(cams_j, i, j))
        Ht = tba.model_homography(cams_t, i, j).numpy()
        np.testing.assert_allclose(Ht, Hj, rtol=1e-5, atol=1e-5 * abs(Hj).max())
    data_t = tba.with_pair_tables(tba.BAData(
        mi=torch.as_tensor(np.array(data.mi), dtype=torch.int64),
        mj=torch.as_tensor(np.array(data.mj), dtype=torch.int64),
        q=torch.as_tensor(np.array(data.q)),
        t=torch.as_tensor(np.array(data.t)),
        m_valid=torch.as_tensor(np.array(data.m_valid)),
        pi=None, pj=None, mp=None))
    for k in ("pi", "pj", "mp"):
        np.testing.assert_array_equal(getattr(data_t, k).numpy(),
                                      np.asarray(getattr(data, k)))


def test_normalize_2d_matches_jax():
    """homography.normalize_2d on random points, within 1e-5 relative."""
    pts = np.random.default_rng(3).uniform(-300, 300, (40, 2)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        thom.normalize_2d(torch.from_numpy(pts)).numpy(),
        np.asarray(jhom.normalize_2d(jnp.asarray(pts))), rtol=1e-5)
