"""Parity of the PyTorch min-cut (ops/maxflow.py) with the JAX package.

grid_mincut_ref is the plain PyTorch version of the push-relabel solver
and the CPU path of grid_mincut; it is held against the JAX XLA solver,
the Pallas kernel in interpret mode, and scipy's exact max-flow. The
CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from simplepanorama_tpu.ops.maxflow import grid_mincut as jax_grid_mincut
from simplepanorama_tpu.ops.maxflow import grid_mincut_pallas
from simplepanorama_tpu_torch.fixtures import cut_grid, max_flow_value
from simplepanorama_tpu_torch.ops import maxflow as tmf

torch.set_num_threads(2)


def _grid(H, W, seed):
    """The 48x160 grid of tests/test_graphcut.py:280-288, or a 24x32 one
    with a smaller hole."""
    hole = (10, 20, 40, 70) if (H, W) == (48, 160) else (5, 9, 10, 14)
    return cut_grid(H, W, seed, hole)


@pytest.mark.parametrize("H,W,seed", [(24, 32, 0), (24, 32, 1), (48, 160, 7)])
def test_ref_matches_jax_and_scipy(H, W, seed):
    """grid_mincut_ref against JAX grid_mincut and the exact scipy cut.
    Tolerance: cut value within 1e-3 (relative) of scipy's (scipy works
    on capacities rounded to 1e-4); sides equal to JAX's on >= 99.9% of
    nodes. Measured: identical sides, equal cut values."""
    wh, wv, exc, node = _grid(H, W, seed)
    side_t = tmf.grid_mincut_ref(*(torch.from_numpy(a)
                                   for a in (wh, wv, exc, node))).numpy()
    side_j = np.asarray(jax_grid_mincut(*(jnp.asarray(a)
                                          for a in (wh, wv, exc, node))))
    exact = max_flow_value(wh, wv, exc, node)
    v_t = tmf.cut_value(wh, wv, exc, node, side_t)
    assert abs(v_t - exact) <= 1e-3 * max(1.0, exact), (v_t, exact)
    assert (side_t == side_j)[node].mean() >= 0.999


@pytest.mark.parametrize("H,W,seed", [(24, 32, 4), (48, 160, 7)])
def test_ref_matches_pallas_interpret(H, W, seed):
    """grid_mincut_ref against the Pallas kernel run in interpret mode,
    as tests/test_graphcut.py:199-220 runs it. Tolerance: cut values
    within 1e-3 relative, sides equal on >= 99.9% of nodes (measured:
    identical)."""
    wh, wv, exc, node = _grid(H, W, seed)
    side_t = tmf.grid_mincut_ref(*(torch.from_numpy(a)
                                   for a in (wh, wv, exc, node))).numpy()
    side_p = np.asarray(grid_mincut_pallas(
        *(jnp.asarray(a) for a in (wh, wv, exc, node)), interpret=True))
    v_t = tmf.cut_value(wh, wv, exc, node, side_t)
    v_p = tmf.cut_value(wh, wv, exc, node, side_p)
    assert abs(v_t - v_p) <= 1e-3 * max(1.0, v_p), (v_t, v_p)
    assert (side_t == side_p)[node].mean() >= 0.999


def test_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors grid_mincut runs grid_mincut_ref (same sides) and
    counts no kernel launch."""
    wh, wv, exc, node = (torch.from_numpy(a) for a in _grid(24, 32, 2))
    before = tmf.grid_mincut.launches
    side = tmf.grid_mincut(wh, wv, exc, node)
    assert tmf.grid_mincut.launches == before
    assert torch.equal(side, tmf.grid_mincut_ref(wh, wv, exc, node))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    """A wrong dtype, shape or layout raises before any solver runs."""
    wh, wv, exc, node = (torch.from_numpy(a) for a in _grid(24, 32, 2))
    if bad == "dtype":
        wh = wh.double()
    elif bad == "shape":
        wv = wv[:, :-1]
    else:
        exc = exc.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        tmf.grid_mincut(wh, wv, exc, node)
