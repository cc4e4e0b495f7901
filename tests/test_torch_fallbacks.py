"""The port's two fallbacks on the CPU, each where the JAX package falls
back too: the plain min-cut when the native solver cannot be built
(render/graphcut._solve_cut), and the chunked full-res render when the
prefetch's upload runs out of device memory (pipeline.Panorama)."""

import threading
import warnings

import numpy as np
import pytest
import torch

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import stitcher as jstitcher
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import io as tio
from simplepanorama_tpu_torch import native as tnative
from simplepanorama_tpu_torch import stitcher as tstitcher
from simplepanorama_tpu_torch.convert import stitch_result_from_numpy
from simplepanorama_tpu_torch.render import fullres as tfull
from simplepanorama_tpu_torch.render import graphcut as tgraphcut

from test_torch_native import _loop
from test_torch_prefetch import _port, views  # noqa: F401  (a fixture)

torch.set_num_threads(2)


class _NoCompiler(OSError):
    """An error of the build other than NativeUnavailable."""


@pytest.fixture
def failing_build(monkeypatch, tmp_path):
    """native._build raising what the test gives it, with nothing built
    in this process (_LIB reset, an empty build directory, no failure
    remembered) and the once-per-process warning not yet given."""
    def use(error):
        def build(so):
            raise error
        monkeypatch.setattr(tnative, "_build", build)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_FAILED", None)
    monkeypatch.setattr(tgraphcut, "_NATIVE_WARNED", False)
    return use


def test_failed_native_build_falls_back_to_the_plain_solver(failing_build,
                                                            tmp_path):
    """With the native build failing (NativeUnavailable), a CPU cut=True
    set_config on 4 views of 320 px takes the plain solver for its 3
    cuts, warns once, and gives the JAX package's seams (its native Dinic
    solver). Tolerance: test_torch_native.py::
    test_set_config_cut_seams_match_jax's, seam masks equal on >= 99.99%
    of the blocks' pixels (measured: all but 27 of 454,656; push-relabel
    and Dinic may settle a tied cut on different pixels)."""
    failing_build(tnative.NativeUnavailable("g++ refused the source"))
    imgs, res = _loop(tmp_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pt = tstitcher.set_config(stitch_result_from_numpy(res), imgs,
                                  TConfig(cut=True), device="cpu")
    native = [w for w in caught if "native min-cut" in str(w.message)]
    assert len(native) == 1 and "g++ refused" in str(native[0].message)
    pj = jstitcher.set_config(res, imgs, JConfig(cut=True))
    sj = np.asarray(pj.state.seam_masks)
    st = pt.state.seam_masks.numpy()
    assert st.shape == sj.shape and sj.any()
    assert (st == sj).mean() >= 0.9999, (st != sj).sum()


def test_other_native_errors_still_raise(failing_build, tmp_path):
    """An error of the native solver other than NativeUnavailable is not
    caught: the CPU cut=True set_config raises it."""
    failing_build(_NoCompiler("not a build failure"))
    imgs, res = _loop(tmp_path, n=2)
    with pytest.raises(_NoCompiler):
        tstitcher.set_config(stitch_result_from_numpy(res), imgs,
                             TConfig(cut=True), device="cpu")


def test_upload_out_of_memory_renders_the_decoded_images(views,
                                                         monkeypatch):
    """A prefetch whose upload (fullres.prefetch_sources) runs out of
    device memory: get_panorama renders the images the thread decoded,
    through the chunked route, equal bit for bit to the synchronous
    render (stitcher.render_full_from_imageset); the images were decoded
    once, and prefetch_stats says the upload ran out of memory."""
    decodes = []
    load = tio.ImageSet.load_connected_images

    def counted(self, *a, **kw):
        decodes.append(threading.current_thread())
        return load(self, *a, **kw)

    def out_of_memory(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory (test)")
    monkeypatch.setattr(tio.ImageSet, "load_connected_images", counted)
    monkeypatch.setattr(tfull, "prefetch_sources", out_of_memory)
    pt = _port(views)
    full = pt.get_panorama()
    assert len(decodes) == 1 and decodes[0] is not threading.main_thread()
    assert pt.prefetch_stats["upload_oom"] is True
    assert pt.prefetch_stats["decode_s"] > 0
    monkeypatch.setattr(tio.ImageSet, "load_connected_images", load)
    want = tstitcher.render_full_from_imageset(pt.stitch_params, pt.config,
                                               pt.images)
    assert full.dtype == np.uint8 and np.array_equal(full, want)
