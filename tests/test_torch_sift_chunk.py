"""The port's SIFT chunk size (features._sift_chunk_size) against the JAX
package's memory model, on the CPU, and the chunking's effect: none on
the features, only on peak memory.
"""

import itertools

import cv2
import numpy as np
import pytest
import torch

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import features as jfeat
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import features as tfeat
from simplepanorama_tpu_torch.fixtures import fkh360_views

torch.set_num_threads(2)


@pytest.mark.parametrize("layers", [3, 4])
def test_chunk_size_equals_jax(layers, monkeypatch):
    """Over a grid of image counts, padded shapes (init_size 700, 1400,
    2800 and small ones) and budgets (SPT_SIFT_MEM_BUDGET, and its 9 GB
    default): the same chunk as the JAX package's _sift_chunk_size (no
    mesh, nothing learnt from a compile-time OOM). Exact."""
    monkeypatch.setattr(jfeat, "_SIFT_CHUNK_CACHE", {})
    jcfg, tcfg = JConfig(nOctaveLayers=layers), TConfig(nOctaveLayers=layers)
    for budget in (None, "100000000", "2000000000", "9000000000",
                   "40000000000"):
        if budget is None:
            monkeypatch.delenv("SPT_SIFT_MEM_BUDGET", raising=False)
        else:
            monkeypatch.setenv("SPT_SIFT_MEM_BUDGET", budget)
        for n, (Hp, Wp) in itertools.product(
                (1, 3, 6, 12, 40),
                ((240, 320), (704, 528), (704, 704), (1400, 1400),
                 (2800, 2800))):
            assert tfeat._sift_chunk_size(n, Hp, Wp, tcfg) == \
                jfeat._sift_chunk_size(n, Hp, Wp, jcfg), (budget, n, Hp)


def test_chunk_shrinks_with_the_budget(monkeypatch):
    """At init_size 1400 (the slice-2 loop) the default 9 GB budget runs
    one image a chunk, where the fixed chunk of 4 peaked at 25.47 GB on
    the card; at 700 px, 4; a larger budget, more, up to 8."""
    cfg = TConfig()
    monkeypatch.delenv("SPT_SIFT_MEM_BUDGET", raising=False)
    assert tfeat._sift_chunk_size(12, 1400, 1400, cfg) == 1
    assert tfeat._sift_chunk_size(12, 704, 704, cfg) == 4
    monkeypatch.setenv("SPT_SIFT_MEM_BUDGET", "40000000000")
    assert tfeat._sift_chunk_size(12, 1400, 1400, cfg) == 5
    assert tfeat._sift_chunk_size(12, 704, 704, cfg) == 8


def test_features_equal_for_chunks_of_1_and_4(tmp_path, monkeypatch):
    """6 views of 320 px through the list path with the budget set for
    chunks of 1 and of 4: identical keypoints, responses and
    descriptors."""
    paths, _, _ = fkh360_views(6, 320, yaw_step_deg=20.0, hfov_deg=45.0,
                               roll_deg=3.0, out_dir=str(tmp_path))
    imgs = [cv2.imread(p) for p in paths]
    cfg = TConfig(init_size=320)
    per_img = 320 * 320 * (cfg.nOctaveLayers + 3) * 550
    got = {}
    for G in (1, 4):
        monkeypatch.setenv("SPT_SIFT_MEM_BUDGET", str(G * per_img))
        assert tfeat._sift_chunk_size(6, 320, 320, cfg) == G
        got[G] = tfeat.extract_features(imgs, cfg, device="cpu")
    for a, b in zip(got[1], got[4]):
        for name in ("xy", "size", "response", "desc", "valid"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), name)
    assert sum(f.count for f in got[1]) > 0
