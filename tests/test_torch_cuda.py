"""Tests that need a CUDA card; they skip without one.

The hand-written min-cut kernels against their plain PyTorch versions,
and the port on the card against the port on the CPU. This file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from simplepanorama_tpu_torch import Config, Panorama
from simplepanorama_tpu_torch.adjacency import torch_pair_draws
from simplepanorama_tpu_torch.fixtures import cut_grid, fkh360_views
from simplepanorama_tpu_torch.stitch import StitchResult
from simplepanorama_tpu_torch.ops import maxflow
from simplepanorama_tpu_torch.render import graphcut
from simplepanorama_tpu_torch.render.compose import ComposeState

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("H,W,seed", [(24, 32, 0), (48, 160, 7),
                                      (200, 328, 3)])
def test_kernel_matches_plain_version(cuda, H, W, seed):
    """grid_mincut (the CUDA kernel) against grid_mincut_ref on the same
    card: cut values within 1e-3 relative (float64 recount) and sides
    equal on >= 99.9% of nodes; one launch counted per call."""
    host = cut_grid(H, W, seed, (H // 5, H // 5 + H // 4, W // 4,
                                 W // 4 + W // 5))
    t = [torch.from_numpy(a).to(cuda) for a in host]
    before = maxflow.grid_mincut.launches
    side_k = maxflow.grid_mincut(*t)
    assert maxflow.grid_mincut.launches == before + 1
    side_r = maxflow.grid_mincut_ref(*t)
    torch.cuda.synchronize()
    v_k = maxflow.cut_value(*host, side_k)
    v_r = maxflow.cut_value(*host, side_r)
    assert abs(v_k - v_r) <= 1e-3 * max(1.0, v_r)
    assert (side_k.cpu().numpy() == side_r.cpu().numpy())[host[3]].mean() \
        >= 0.999


def test_graph_cut_state_card_matches_cpu(cuda):
    """Graph-cut seams of synthetic packed blocks on the card (CUDA
    kernel) and on the CPU (plain solver): seam masks equal on >= 99.9%
    of each block."""
    rng = np.random.default_rng(3)
    n, Hb, Wb = 3, 48, 128
    imgs = rng.uniform(0, 255, (n, Hb, Wb, 3)).astype(np.float32)
    masks = np.zeros((n, Hb, Wb), bool)
    offs = np.array([[0, 0], [10, 60], [20, 120]], np.int32)
    for i in range(n):
        masks[i, 1:39 + i, 1:99 + 5 * i] = True

    def state(dev):
        T = lambda a: torch.as_tensor(a, device=dev)
        return ComposeState(imgs=T(imgs), masks=T(masks), offs=T(offs),
                            rois=[], canvas_hw=(80, 256), min_xy=(0, 0))
    before = maxflow.grid_mincut.launches
    on_card = graphcut.graph_cut_state(state(cuda), [0, 1, 2]).cpu().numpy()
    assert maxflow.grid_mincut.launches == before + 2
    on_cpu = graphcut.graph_cut_state(state("cpu"), [0, 1, 2]).numpy()
    assert (on_card == on_cpu).mean(axis=(1, 2)).min() >= 0.999


def test_default_pair_draws_same_on_card(cuda):
    """The pipeline's RANSAC draws come from the CPU generator on every
    device, so the card samples what the CPU samples."""
    on_card = torch_pair_draws(0, 4, cuda)(1, 2, 300, 64)
    assert on_card.device.type == "cuda"
    on_cpu = torch_pair_draws(0, 4, "cpu")(1, 2, 300, 64)
    assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.parametrize("H,W,seed", [(24, 32, 0), (48, 160, 7),
                                      (200, 328, 3)])
def test_tiled_kernel_matches_plain_version(cuda, H, W, seed):
    """grid_mincut_tiled (the CUDA kernel, 2-D tiles) against
    grid_mincut_tiled_ref (row tiles of 16) on the same card: cut values
    within 1e-3 relative (float64 recount) and sides equal on >= 99.9% of
    nodes; one launch counted per call."""
    host = cut_grid(H, W, seed, (H // 5, H // 5 + H // 4, W // 4,
                                 W // 4 + W // 5))
    t = [torch.from_numpy(a).to(cuda) for a in host]
    before = maxflow.grid_mincut_tiled.launches
    side_k = maxflow.grid_mincut_tiled(*t)
    assert maxflow.grid_mincut_tiled.launches == before + 1
    side_r = maxflow.grid_mincut_tiled_ref(*t, tile_rows=16)
    torch.cuda.synchronize()
    v_k = maxflow.cut_value(*host, side_k)
    v_r = maxflow.cut_value(*host, side_r)
    assert abs(v_k - v_r) <= 1e-3 * max(1.0, v_r)
    assert (side_k.cpu().numpy() == side_r.cpu().numpy())[host[3]].mean() \
        >= 0.999


def _ncc(a, b):
    a = a.astype(np.float64).ravel() - a.mean()
    b = b.astype(np.float64).ravel() - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def test_get_panorama_card_matches_cpu(cuda, tmp_path):
    """get_preview and get_panorama of two 640-px views (preview 320 px)
    with their true geometry put in place of the BA result, graph-cut
    seams and gain compensation, on the card and on the CPU: the same
    shapes, NCC >= 0.98 for both."""
    paths, yaws, f = fkh360_views(2, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                                  out_dir=str(tmp_path))
    fp = f * 320 / 640
    K = np.array([[fp, 0, 160], [0, fp, 160], [0, 0, 1.0]])
    Rs = []
    for yaw in yaws:
        a = np.radians(yaw)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    res = StitchResult(rot=np.stack(Rs), K=np.stack([K, K]),
                       adj=np.array([[0, 0.5], [0, 0]]),
                       connectivity=np.array([1, 1]),
                       order=[(0, -1), (1, 0)], nodes=[0, 1], center=0,
                       sizes=[(320, 320), (320, 320)])
    cfg = Config(cut=True, init_size=320, gain_compensation=True)
    out = {}
    for dev in ("cpu", cuda):
        p = Panorama(paths, device=dev)
        p.result = res
        p.set_config(cfg)
        out[str(dev)] = (p.get_preview(), p.get_panorama())
    (prev_c, full_c), (prev_g, full_g) = out["cpu"], out["cuda"]
    assert prev_c.shape == prev_g.shape and full_c.shape == full_g.shape
    assert _ncc(prev_c, prev_g) >= 0.98 and _ncc(full_c, full_g) >= 0.98
