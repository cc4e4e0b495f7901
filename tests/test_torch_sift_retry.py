"""SIFT chunks that halve when the device runs out of memory
(features._extract_list and _extract_stream), on the CPU.

The JAX package halves its SIFT chunk on an out-of-memory at compile
time and remembers the size per shape (simplepanorama_tpu/features.py's
_SIFT_CHUNK_CACHE); the port does so on torch.OutOfMemoryError. Here
features._sift is wrapped to raise that error at chunks the test picks,
and the features must equal those of an unwrapped run, image for image
(results are per image). tests/test_torch_cuda.py runs it on the card
under a memory cap.
"""

import cv2
import numpy as np
import pytest
import torch

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import features as jfeat
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import features as tfeat
from simplepanorama_tpu_torch.fixtures import fkh360_views
from simplepanorama_tpu_torch.io import ImageSet

torch.set_num_threads(2)

N, SIZE = 5, 300
PAD = 304      # the padded shape: SIZE rounded up to a multiple of 8
NAMES = ("xy", "size", "response", "desc", "valid")


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    out = tmp_path_factory.mktemp("retry")
    paths, _, _ = fkh360_views(N, SIZE, yaw_step_deg=20.0, hfov_deg=45.0,
                               roll_deg=3.0, out_dir=str(out))
    return paths


@pytest.fixture(scope="module")
def reference(views):
    """The features of an unwrapped run (chunks of 1, the list path)."""
    imgs = [cv2.imread(p) for p in views]
    mp = pytest.MonkeyPatch()
    mp.setattr(tfeat, "_SIFT_CHUNK_CACHE", {})
    mp.setenv("SPT_SIFT_MEM_BUDGET", "1")
    try:
        return tfeat.extract_features(imgs, TConfig(init_size=SIZE),
                                      device="cpu")
    finally:
        mp.undo()


@pytest.fixture
def budget4(monkeypatch):
    """A budget of 4 images a chunk and no size learnt yet."""
    monkeypatch.setattr(tfeat, "_SIFT_CHUNK_CACHE", {})
    cfg = TConfig(init_size=SIZE)
    per_img = PAD * PAD * (cfg.nOctaveLayers + 3) * 550
    monkeypatch.setenv("SPT_SIFT_MEM_BUDGET", str(4 * per_img))
    assert tfeat._sift_chunk_size(N, PAD, PAD, cfg) == 4
    return cfg


def _wrap(monkeypatch, fails):
    """features._sift raising torch.OutOfMemoryError where ``fails(call,
    chunk size)`` holds; returns the list of (chunk size, raised)."""
    sift = tfeat._sift
    calls = []

    def wrapped(batch, hw, cfg):
        n = batch.shape[0]
        bad = fails(len(calls), n)
        calls.append((n, bad))
        if bad:
            raise torch.OutOfMemoryError(f"out of memory at {n} images")
        return sift(batch, hw, cfg)
    monkeypatch.setattr(tfeat, "_sift", wrapped)
    return calls


def _extract(paths, cfg, stream):
    images = ImageSet(paths)
    if stream:
        return tfeat.extract_features(
            images.load_resized_stream(cfg.init_size, cfg.threads), cfg,
            device="cpu")
    images.load_resized(cfg.init_size, cfg.threads)
    return tfeat.extract_features(images.img_data, cfg, device="cpu")


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for name in NAMES:
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), name)


# (name, images a chunk by the budget, which calls fail, the chunk sizes
# called with whether each raised, the size remembered)
CASES = [
    # every chunk over 2 images: the first chunk fails, G 4 -> 2, and the
    # extraction starts again from image 0
    ("above_2", 4, lambda call, n: n > 2,
     [(4, True), (2, False), (2, False), (1, False)], 2),
    # the second chunk (images 3-4) fails once: G 3 -> 1, and the
    # extraction goes on from image 3, not from the start
    ("second_chunk", 3, lambda call, n: call == 1,
     [(3, False), (2, True), (1, False), (1, False)], 1),
]


@pytest.mark.parametrize("stream", [False, True], ids=["list", "stream"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_chunk_halves_and_features_stay_equal(views, reference, budget4,
                                              monkeypatch, case, stream):
    """Both loops halve G on the error, go on from the chunk that failed
    and give the unwrapped run's features; the size that ran after a
    halving is remembered for the shape, and the next call starts from
    it."""
    _, per_chunk, fails, want_calls, remembered = case
    cfg = budget4
    per_img = PAD * PAD * (cfg.nOctaveLayers + 3) * 550
    monkeypatch.setenv("SPT_SIFT_MEM_BUDGET", str(per_chunk * per_img))
    calls = _wrap(monkeypatch, fails)
    _equal(_extract(views, cfg, stream), reference)
    assert calls == want_calls
    key = tfeat._shape_key(PAD, PAD, cfg)
    assert tfeat._SIFT_CHUNK_CACHE == {key: remembered}
    assert tfeat._sift_chunk_size(N, PAD, PAD, cfg) == remembered
    calls = _wrap(monkeypatch, lambda call, n: False)
    _equal(_extract(views, cfg, stream), reference)
    assert calls[0] == (remembered, False)
    assert all(n <= remembered for n, _ in calls)


@pytest.mark.parametrize("stream", [False, True], ids=["list", "stream"])
def test_other_errors_propagate(views, budget4, monkeypatch, stream):
    """Only torch.OutOfMemoryError splits a chunk: any other error of
    SIFT raises as it was, and nothing is remembered."""
    sift_calls = []

    def broken(batch, hw, cfg):
        sift_calls.append(batch.shape[0])
        raise RuntimeError("not a memory error")
    monkeypatch.setattr(tfeat, "_sift", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        _extract(views, budget4, stream)
    assert sift_calls == [4] and tfeat._SIFT_CHUNK_CACHE == {}


@pytest.mark.parametrize("stream", [False, True], ids=["list", "stream"])
def test_least_chunk_raises(views, budget4, monkeypatch, stream):
    """Running out of memory at one image a chunk raises the error itself
    after halving 4 -> 2 -> 1."""
    calls = _wrap(monkeypatch, lambda call, n: True)
    with pytest.raises(torch.OutOfMemoryError, match="at 1 images"):
        _extract(views, budget4, stream)
    assert calls == [(4, True), (2, True), (1, True)]


def test_world_chunk_stays_a_multiple_of_the_ranks(views, reference,
                                                   budget4, monkeypatch):
    """With ``step`` ranks (_extract_sharded passes the world's size) the
    chunk is a multiple of it and halves to one: G 4 -> 2 at step 2, as
    the JAX package's _sift_chunk_size and halving do with a mesh of 2
    (both packages' starting size compared here), and at 2 a further
    error raises."""
    jcfg = JConfig(init_size=SIZE)
    monkeypatch.setattr(jfeat, "_SIFT_CHUNK_CACHE", {})

    class Mesh:
        size = 2
    for n in (3, 5, 8):
        assert tfeat._sift_chunk_size(n, PAD, PAD, budget4, step=2) == \
            jfeat._sift_chunk_size(n, PAD, PAD, jcfg, Mesh()), n
    imgs = [cv2.imread(p) for p in views]
    calls = _wrap(monkeypatch, lambda call, n: n > 2)
    outs, _, _ = tfeat._extract_list(imgs, budget4, None, "cpu", step=2)
    assert calls == [(4, True), (2, False), (2, False), (1, False)]
    assert tfeat._SIFT_CHUNK_CACHE[tfeat._shape_key(PAD, PAD,
                                                    budget4)] == 2
    assert sum(o[0].shape[0] for o in outs) == N
    calls = _wrap(monkeypatch, lambda call, n: n > 1)
    with pytest.raises(torch.OutOfMemoryError):
        tfeat._extract_list(imgs, budget4, None, "cpu", step=2)
    assert calls == [(2, True)]
