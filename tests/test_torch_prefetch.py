"""The full-res source prefetch of the port's Panorama, on the CPU: the
background thread that decodes the full-res images and uploads their
packed stack while the preview composites, against the synchronous
render and against the JAX package's Panorama, which prefetches too.

Every test uses the setup of tests/test_torch_fullres.py::
test_get_panorama_matches_jax: two 640-px views (preview at init_size
320) with their true geometry put in place of the BA result, cut=True
and gain compensation.
"""

import threading
import time

import numpy as np
import pytest
import torch

import simplepanorama_tpu as J
from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu.render import fullres as jfull
from simplepanorama_tpu.stitch import StitchResult as JStitchResult
import simplepanorama_tpu_torch as T
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import io as tio
from simplepanorama_tpu_torch import pipeline as tpipeline
from simplepanorama_tpu_torch import stitcher as tstitcher
from simplepanorama_tpu_torch.convert import stitch_result_from_numpy
from simplepanorama_tpu_torch.fixtures import fkh360_views
from simplepanorama_tpu_torch.render import fullres as tfull

torch.set_num_threads(2)
KW = dict(cut=True, init_size=320, gain_compensation=True)


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """(paths, the JAX package's StitchResult of the true geometry)."""
    paths, yaws, f = fkh360_views(2, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                                  out_dir=str(tmp_path_factory.mktemp("v")))
    fp = f * 320 / 640
    K = np.array([[fp, 0, 160], [0, fp, 160], [0, 0, 1.0]])
    Rs = []
    for yaw in yaws:
        a = np.radians(yaw)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]))
    res = JStitchResult(rot=np.stack(Rs), K=np.stack([K, K]),
                        adj=np.array([[0, 0.5], [0, 0]]),
                        connectivity=np.array([1, 1]),
                        order=[(0, -1), (1, 0)], nodes=[0, 1], center=0,
                        sizes=[(320, 320), (320, 320)])
    return paths, res


def _port(views):
    """The port's Panorama on the CPU with the true geometry; its
    set_config starts the prefetch."""
    paths, res = views
    pt = T.Panorama(paths, device="cpu")
    pt.result = stitch_result_from_numpy(res)
    pt.set_config(TConfig(**KW))
    return pt


def _agree(a, b, max_frac, max_mean, tol):
    """tests/test_torch_fullres.py's _agree: the share of pixels more
    than ``tol`` levels apart, and the mean absolute difference."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(np.float32) - b.astype(np.float32))
    assert float((diff > tol).mean()) < max_frac
    assert float(diff.mean()) < max_mean


def test_prefetched_panorama_equals_synchronous(views):
    """get_panorama after the prefetch (the thread's images and stack)
    against stitcher.render_full_from_imageset, which decodes the images
    itself: equal, bit for bit. The prefetch ran: get_panorama kept the
    thread's decode and upload seconds and its wait at the join."""
    pt = _port(views)
    assert pt._full_prefetch is not None
    full = pt.get_panorama()
    stats = pt.prefetch_stats
    assert stats["decode_s"] > 0 and stats["upload_s"] >= 0
    assert stats["join_wait_s"] >= 0 and pt._full_prefetch is None
    want = tstitcher.render_full_from_imageset(pt.stitch_params, pt.config,
                                               pt.images)
    assert full.dtype == np.uint8 and np.array_equal(full, want)


def test_prefetched_panorama_matches_jax(views):
    """The port's get_panorama after its prefetch against the JAX
    package's Panorama.get_panorama, which prefetches (its thread) too.
    Tolerance: test_get_panorama_matches_jax's (same shape, under 0.01%
    of pixels more than 1 level apart, mean difference under 0.01)."""
    paths, res = views
    pj = J.Panorama(paths)
    pj.result = res
    pj.set_config(JConfig(**KW))
    pt = _port(views)
    _agree(np.asarray(pj.get_panorama()), pt.get_panorama(), max_frac=1e-4,
           max_mean=0.01, tol=1)


def test_prefetch_sources_matches_jax(views):
    """fullres.prefetch_sources of both packages on the same full-res
    images and stitch result: the same (m, Hs, Ws, 3) uint8 stack, byte
    for byte, on the device of the preview's blocks."""
    paths, res = views
    pj = J.Panorama(paths)
    pj.result = res
    pj.set_config(JConfig(**KW))
    pt = _port(views)
    full = pt.images.load_connected_images([True, True])
    sj = np.asarray(jfull.prefetch_sources(pj.stitch_params, full))
    st = tfull.prefetch_sources(pt.stitch_params, full)
    assert st.device == pt.stitch_params.state.imgs.device
    assert st.dtype == torch.uint8 and tuple(st.shape) == sj.shape
    assert np.array_equal(st.numpy(), sj)


def test_set_config_with_the_same_result_keeps_the_stack(views,
                                                         monkeypatch):
    """A set_config that keeps the stitch result keeps the prefetch: the
    sources are decoded and uploaded once, and get_panorama renders from
    that stack, equal to the synchronous render."""
    calls, stacks = [], []
    prefetch = tfull.prefetch_sources
    render_full = tstitcher.render_full

    def counted(*a, **kw):
        calls.append(prefetch(*a, **kw))
        return calls[-1]

    def recording(*a, src_stack=None, **kw):
        stacks.append(src_stack)
        return render_full(*a, src_stack=src_stack, **kw)
    monkeypatch.setattr(tfull, "prefetch_sources", counted)
    monkeypatch.setattr(tstitcher, "render_full", recording)
    pt = _port(views)
    first = pt._full_prefetch
    pt.set_config(TConfig(**KW))
    assert pt._full_prefetch is first
    full = pt.get_panorama()
    assert len(calls) == 1 and len(stacks) == 1 and stacks[0] is calls[0]
    monkeypatch.setattr(tstitcher, "render_full", render_full)
    assert np.array_equal(full, tstitcher.render_full_from_imageset(
        pt.stitch_params, pt.config, pt.images))


def test_new_result_cancels_and_joins_the_stale_prefetch(views,
                                                        monkeypatch):
    """A set_config with a new stitch result cancels the prefetch in
    flight and waits for its thread before the next one starts: the
    stale decode (held until its cancel event is set) ends before the
    new one begins, the stale thread stops after it (no stack), and
    get_panorama renders the new prefetch."""
    events, stale = [], []
    load = tio.ImageSet.load_connected_images

    def held(self, *a, **kw):
        me = threading.current_thread()
        events.append(("start", me))
        if len(events) == 1:       # the first decode: in flight until
            t0 = time.perf_counter()   # its prefetch is cancelled
            while not (stale and stale[0][3].is_set()):
                assert time.perf_counter() - t0 < 60
                time.sleep(0.01)
        out = load(self, *a, **kw)
        events.append(("end", me))
        return out
    monkeypatch.setattr(tio.ImageSet, "load_connected_images", held)
    pt = _port(views)
    stale.append(pt._full_prefetch)
    pt.result = stitch_result_from_numpy(views[1])
    pt.set_config(TConfig(**KW))
    _, thread, out, cancel = stale[0]
    assert cancel.is_set() and not thread.is_alive()
    assert "stack" not in out and "error" not in out
    assert pt._full_prefetch is not stale[0]
    full = pt.get_panorama()
    assert [e for e, _ in events] == ["start", "end", "start", "end"]
    (_, a), (_, b), (_, c), (_, d) = events
    assert a is b is thread and c is d is not thread
    assert pt.prefetch_stats["decode_s"] > 0
    monkeypatch.setattr(tio.ImageSet, "load_connected_images", load)
    assert np.array_equal(full, tstitcher.render_full_from_imageset(
        pt.stitch_params, pt.config, pt.images))


def test_exit_cancels_and_joins_a_running_prefetch(views, monkeypatch):
    """At exit (pipeline._join_prefetches, registered with atexit) a
    prefetch still decoding is cancelled and its thread joined, while
    the interpreter is whole: a daemon thread inside a torch call when
    it finalizes would abort the process. The upload after the decode
    does not run, and the thread leaves the set of running prefetches
    when it ends."""
    uploads, started = [], []
    load = tio.ImageSet.load_connected_images

    def held(self, *a, **kw):      # in flight until its prefetch is
        t0 = time.perf_counter()   # cancelled
        while not (started and started[0][3].is_set()):
            assert time.perf_counter() - t0 < 60
            time.sleep(0.01)
        return load(self, *a, **kw)

    def upload(*a, **kw):
        uploads.append(threading.current_thread())
    monkeypatch.setattr(tio.ImageSet, "load_connected_images", held)
    monkeypatch.setattr(tfull, "prefetch_sources", upload)
    pt = _port(views)
    started.append(pt._full_prefetch)
    _, thread, out, cancel = started[0]
    assert thread.is_alive() and (thread, cancel) in tpipeline._PREFETCHES
    tpipeline._join_prefetches()
    assert cancel.is_set() and not thread.is_alive()
    assert not uploads and "stack" not in out and "error" not in out
    assert (thread, cancel) not in tpipeline._PREFETCHES


def test_prefetch_error_is_raised_by_get_panorama(views, monkeypatch):
    """A decode that fails in the prefetch thread (io.file_to_array
    raising) is raised by get_panorama, not hidden behind a synchronous
    render."""
    class DecodeFailed(RuntimeError):
        pass

    def broken(path):
        raise DecodeFailed(path)
    paths, res = views
    pt = T.Panorama(paths, device="cpu")
    pt.result = stitch_result_from_numpy(res)
    pt.images.load_resized(320, threads=1)     # the preview's images
    monkeypatch.setattr(tio, "file_to_array", broken)
    pt.set_config(TConfig(**KW))
    with pytest.raises(DecodeFailed):
        pt.get_panorama()
    assert pt._full_prefetch is None and pt._full_pano is None
