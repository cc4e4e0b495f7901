"""The port's streaming decode (io.PendingLoad -> features._extract_stream
-> stitcher.run_pipeline) on the CPU: against its own list path, and
against the JAX package's extract_features.
"""

import numpy as np
import pytest
import torch

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import features as jfeat
from simplepanorama_tpu import io as jio
import simplepanorama_tpu_torch as T
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import features as tfeat
from simplepanorama_tpu_torch import io as tio
from simplepanorama_tpu_torch.fixtures import fkh360_views

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """6 views of 320 px (the well-posed views of
    tests/test_torch_slice.py): 6 images make 3 chunks of 2."""
    out = tmp_path_factory.mktemp("stream")
    paths, _, _ = fkh360_views(6, 320, yaw_step_deg=20.0, hfov_deg=45.0,
                               roll_deg=3.0, out_dir=str(out))
    return paths


def _stream(paths, cfg, **kw):
    images = tio.ImageSet(paths)
    pending = images.load_resized_stream(cfg.init_size, 3)
    return images, tfeat.extract_features(pending, cfg, device="cpu", **kw)


def test_stream_equals_list_path(views, monkeypatch):
    """The same files through the stream (chunks of 2, as decoded) and
    through the list path (one upload, one chunk of 6 under the default
    memory budget): identical keypoints,
    descriptors and device_images, the ImageSet filled in image order,
    and one SIFT call per chunk of at most (n + 2) // 3 images.
    Tolerance: exact (measured exact; SIFT's result for an image does
    not depend on the batch it runs in)."""
    cfg = TConfig(init_size=320)
    calls = []
    sift = tfeat.extract_sift_batch
    monkeypatch.setattr(tfeat, "extract_sift_batch",
                        lambda b, *a, **kw: calls.append(b.shape[0])
                        or sift(b, *a, **kw))
    images, got = _stream(views, cfg)
    assert calls == [2, 2, 2]
    assert images.loaded == list(views) and len(images.img_data) == 6
    listed = tio.ImageSet(views)
    listed.load_resized(cfg.init_size, 3)
    want = tfeat.extract_features(listed.img_data, cfg, device="cpu")
    for a, b in zip(listed.img_data, images.img_data):
        assert np.array_equal(a, b)
    assert torch.equal(got.device_images, want.device_images)
    for fg, fw in zip(got, want):
        for k in ("xy", "size", "response", "desc", "valid"):
            assert np.array_equal(getattr(fg, k), getattr(fw, k)), k
    for a, b in zip(got.device_batch, want.device_batch):
        assert torch.equal(a, b)


def test_stream_matches_jax(views):
    """The port's stream against the JAX package's extract_features on
    its own PendingLoad of the first 4 files, at
    tests/test_torch_modules.py's SIFT tolerances: the same number of
    valid keypoints per image, every JAX keypoint with a port keypoint
    within 1e-2 px (measured 7.8e-4) and the paired descriptors within
    2e-3 (measured 4.2e-4)."""
    paths = views[:4]
    cfg = TConfig(init_size=320)
    _, ft = _stream(paths, cfg)
    jimages = jio.ImageSet(paths)
    fj = jfeat.extract_features(jimages.load_resized_stream(320, 3),
                                JConfig(init_size=320))
    assert len(fj) == len(ft) == 4
    worst_xy = worst_desc = 0.0
    for a, b in zip(fj, ft):
        vj, vt = np.asarray(a.valid), b.valid
        assert vj.sum() == vt.sum() and vj.sum() > 50
        xj, xt = np.asarray(a.xy)[vj], b.xy[vt]
        d = np.abs(xj[:, None, :] - xt[None, :, :]).max(-1)
        worst_xy = max(worst_xy, d.min(1).max())
        dj = np.asarray(a.desc)[vj]
        worst_desc = max(worst_desc, np.abs(b.desc[vt][d.argmin(1)]
                                            - dj).max())
    assert worst_xy <= 1e-2 and worst_desc <= 2e-3


def test_failed_decode_raises(views, tmp_path):
    """A file whose header reads but whose pixels do not decode: the
    stream raises the loader's error, with no fallback to the list
    path."""
    good = open(views[0], "rb").read()
    bad = tmp_path / "broken.png"
    bad.write_bytes(good[:64] + b"\0" * 200)
    images = tio.ImageSet([views[1], str(bad), views[2]])
    pending = images.load_resized_stream(320, 2)
    assert all(d is not None for d in pending.dims)
    with pytest.raises(RuntimeError, match="decoding failed"):
        tfeat.extract_features(pending, TConfig(init_size=320),
                               device="cpu")


def test_stream_polls_cancel_between_chunks(views):
    """A cancel set after the first chunk stops the stream before the
    second: one poll before any work, then one per chunk."""
    polls = []
    with pytest.raises(RuntimeError, match="canceled"):
        _stream(views, TConfig(init_size=320),
                cancelled=lambda: polls.append(1) or len(polls) > 2)
    assert len(polls) == 3


def test_run_pipeline_streams(views, monkeypatch):
    """Panorama.stitch on 4 views decodes through the stream: SIFT
    receives the PendingLoad, all 4 connect, and the preview equals that
    of a stitch whose images were decoded first (the list path, taken
    for an ImageSet that already holds images). Tolerance: exact
    (measured exact)."""
    paths = views[:4]
    cfg = TConfig(init_size=320, RANSAC_iterations=300)
    seen = []
    extract = tfeat.extract_features
    monkeypatch.setattr(tfeat, "extract_features", lambda imgs, *a, **kw: (
        seen.append(type(imgs).__name__) or extract(imgs, *a, **kw)))
    streamed = T.Panorama(paths, device="cpu").stitch(cfg)
    listed = T.Panorama(paths, device="cpu")
    listed.images.load_resized(cfg.init_size, 2)
    listed.stitch(cfg)
    assert seen == ["PendingLoad", "list"]
    assert tuple(streamed.connected) == tuple(listed.connected) == (4, 4)
    assert streamed.images.loaded == list(paths)
    np.testing.assert_array_equal(streamed.result.K, listed.result.K)
    assert np.array_equal(streamed.get_preview(), listed.get_preview())
