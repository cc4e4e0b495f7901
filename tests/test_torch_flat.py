"""render/flat.py of the port against the JAX package's, on the CPU: the
four cases of tests/test_flat.py run through both packages."""

import numpy as np
import torch
import jax.numpy as jnp

from simplepanorama_tpu.geometry.canvas import \
    calc_stitch_from_adj as jcalc
from simplepanorama_tpu.render import flat as jflat
from simplepanorama_tpu_torch.geometry.canvas import \
    calc_stitch_from_adj as tcalc
from simplepanorama_tpu_torch.render import flat as tflat


def _warp_both(img, H_inv, out_h, out_w):
    wj, mj = jflat.warp_perspective(jnp.asarray(img), jnp.asarray(H_inv),
                                    out_h, out_w)
    wt, mt = tflat.warp_perspective(torch.from_numpy(img),
                                    torch.from_numpy(H_inv), out_h, out_w)
    return (np.asarray(wj), np.asarray(mj)), (wt.numpy(), mt.numpy())


def test_warp_perspective_identity_matches_jax():
    """Identity warp. Tolerance: masks equal; pixels within 1e-4 of the
    JAX package's (the same bilinear weights, float32) and within 1e-3 of
    the source (tests/test_flat.py's bound)."""
    img = np.random.default_rng(0).uniform(0, 255, (32, 48, 3)) \
        .astype(np.float32)
    (wj, mj), (wt, mt) = _warp_both(img, np.eye(3, dtype=np.float32), 32, 48)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(wt, wj, atol=1e-4)
    np.testing.assert_allclose(wt, img, atol=1e-3)
    assert mt.all()


def test_warp_perspective_translation_matches_jax():
    """A (+5, +3) translation. Tolerance: masks equal, pixels within 1e-3
    of the JAX package's; the shifted content within 1e-2 of the source
    (tests/test_flat.py's bound)."""
    img = np.random.default_rng(1).uniform(0, 255, (40, 40, 3)) \
        .astype(np.float32)
    H = np.eye(3)
    H[0, 2], H[1, 2] = 5.0, 3.0
    Hinv = np.linalg.inv(H).astype(np.float32)
    (wj, mj), (wt, mt) = _warp_both(img, Hinv, 40, 40)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(wt, wj, atol=1e-3)
    np.testing.assert_allclose(wt[3:, 5:], img[:-3, :-5], atol=1e-2)
    assert not mt[0, 0]


def test_pairwise_stitch_matches_jax():
    """The legacy pairwise stitch, attach 40 px right of base. Tolerance:
    the same canvas shape, uint8 pixels within 1 level of the JAX
    package's (a float32 sample can round to the other side of .5)."""
    rng = np.random.default_rng(2)
    base = rng.integers(40, 255, (50, 60, 3)).astype(np.uint8)
    attach = rng.integers(40, 255, (50, 60, 3)).astype(np.uint8)
    H = np.eye(3)
    H[0, 2] = 40.0
    oj = jflat.pairwise_stitch(base, attach, H)
    ot = tflat.pairwise_stitch(base, attach, H, device="cpu")
    assert ot.shape == oj.shape and ot.shape[1] >= 100
    assert np.abs(ot.astype(int) - oj.astype(int)).max() <= 1
    np.testing.assert_array_equal(ot[:50, :60], base)


def test_render_flat_two_image_chain_matches_jax():
    """The chained-homography panorama of two images 30 px apart, from
    each package's calc_stitch_from_adj. Tolerance: the same (40, 80)
    canvas; uint8 pixels within 1 level of the JAX package's; the first
    image pasted exactly."""
    rng = np.random.default_rng(3)
    imgs = [rng.integers(40, 255, (40, 50, 3)).astype(np.uint8)
            for _ in range(2)]
    adj = np.zeros((2, 2))
    adj[0, 1] = 1.0
    hom = np.zeros((2, 2, 3, 3))
    hom[:] = np.eye(3)
    hom[0, 1, 0, 2] = 30.0
    hom[1, 0, 0, 2] = -30.0
    conn = np.array([1.0, 0.5])
    args = (adj, conn, [(40, 50), (40, 50)], hom)
    oj = jflat.render_flat(jcalc(*args, focal=700.0, fast=False), imgs)
    ot = tflat.render_flat(tcalc(*args, focal=700.0, fast=False), imgs,
                           device="cpu")
    assert ot.shape[:2] == oj.shape[:2] == (40, 80)
    assert np.abs(ot.astype(int) - oj.astype(int)).max() <= 1
    np.testing.assert_array_equal(ot[:, :50], imgs[0])
