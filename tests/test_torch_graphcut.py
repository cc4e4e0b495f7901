"""Parity of the PyTorch graph-cut seams (render/graphcut.py) with the
JAX package's device chain, on the CPU (plain min-cut solver)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from simplepanorama_tpu.render import graphcut as jgc
from simplepanorama_tpu.render.compose import ComposeState as JState
from simplepanorama_tpu_torch.convert import compose_state_from_numpy
from simplepanorama_tpu_torch.render import graphcut as tgc

torch.set_num_threads(2)


def _blocks(seed=3):
    """The synthetic 3-image block set of tests/test_graphcut.py:231-244."""
    rng = np.random.default_rng(seed)
    n, Hb, Wb = 3, 48, 128
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    masks = np.zeros((n, Hb, Wb), bool)
    offs = np.array([[0, 0], [10, 60], [20, 120]], np.int32)
    rois = []
    for i in range(n):
        h, w = 40 + i, 100 + 5 * i
        masks[i, 1:h - 1, 1:w - 1] = True
        rois.append((int(offs[i, 1]), int(offs[i, 0]), w, h))
    return JState(imgs=jnp.asarray(imgs), masks=jnp.asarray(masks),
                  offs=jnp.asarray(offs), rois=rois, canvas_hw=(80, 256),
                  min_xy=(0, 0))


def test_graph_cut_state_matches_jax():
    """graph_cut_state against JAX graph_cut_state on the same blocks and
    order. Tolerance: per-image seam agreement > 0.995 (min-cut ties may
    break differently); measured 1.0."""
    jstate = _blocks()
    seq = [0, 1, 2]
    seams_j = np.asarray(jgc.graph_cut_state(jstate, seq))
    seams_t = tgc.graph_cut_state(
        compose_state_from_numpy(jstate, device="cpu"), seq)
    assert seams_t.dtype == torch.bool and seams_t.shape == seams_j.shape
    seams_t = seams_t.numpy()
    for i, r in enumerate(jstate.rois):
        agree = (seams_t[i, :r[3], :r[2]] == seams_j[i, :r[3], :r[2]]).mean()
        assert agree > 0.995, (i, agree)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_cut_graph_matches_jax(seed):
    """Seam graph (capacities, t-link excess, node set) of one overlap.
    Tolerance: capacities within 1e-5 relative (Scharr as integer-weight
    shifted sums vs an XLA convolution: float summation order); excess
    and nodes exact. Measured max relative capacity error ~1e-7."""
    rng = np.random.default_rng(seed)
    H, W = 40, 96
    g1 = rng.uniform(0, 255, (H, W)).astype(np.float32)
    g2 = rng.uniform(0, 255, (H, W)).astype(np.float32)
    m1 = np.zeros((H, W), np.float32)
    m1[2:H - 2, 2:60] = 255.0
    m2 = np.zeros((H, W), np.float32)
    m2[4:H - 1, 30:W - 3] = 255.0
    out_j = [np.asarray(a) for a in jgc._build_cut_graph(
        *(jnp.asarray(a) for a in (g1, g2, m1, m2)))]
    out_t = [a.numpy() for a in tgc._build_cut_graph(
        *(torch.from_numpy(a) for a in (g1, g2, m1, m2)))]
    for a, b in zip(out_j[:2], out_t[:2]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out_t[2], out_j[2])
    np.testing.assert_array_equal(out_t[3], out_j[3])


def test_scharr_and_boundary_match_jax():
    """_scharr and _boundary. Tolerance for the gradients: 1e-5 relative
    + 1e-3 absolute, the float32 rounding of a 6-term sum of magnitude up
    to 16*255 taken in another order (measured max 4.9e-4 absolute);
    boundaries exact."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (32, 48)).astype(np.float32)
    gxj, gyj = (np.asarray(a) for a in jgc._scharr(jnp.asarray(img)))
    gxt, gyt = (a.numpy() for a in tgc._scharr(torch.from_numpy(img)))
    np.testing.assert_allclose(gxt, gxj, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(gyt, gyj, rtol=1e-5, atol=1e-3)
    mask = np.zeros((32, 48), bool)
    mask[3:20, 5:40] = True
    mask[10:14, 10:14] = False
    np.testing.assert_array_equal(
        tgc._boundary(torch.from_numpy(mask)).numpy(),
        np.asarray(jgc._boundary(jnp.asarray(mask))))
