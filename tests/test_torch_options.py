"""Compositing options through set_config + render_preview of both
packages, on the CPU: the cylindrical projection, SIMPLE_BLEND and
NO_BLEND, cut_seams=False, straighten=False, blend_intensity=False and
the little planet's LINEAR_SCALING stretch.

One known-geometry StitchResult, with no SIFT, RANSAC or BA: the 12-view
360-degree loop of 300-px views of tests/test_torch_sten.py, every camera
tilted by the same 4 degrees about the x axis, so that straightening
changes the rotations. The blend methods alone are held by
tests/test_torch_modules.py's test_blend_dev_matches_jax (spherical
blocks) and tests/test_torch_fullres.py's test_render_full_matches_jax;
none of the combinations below was held through set_config before.
chip_smoke.py's options phase runs them on the card.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch

from simplepanorama_tpu import Config as JConfig
from simplepanorama_tpu import stitcher as jstitcher
from simplepanorama_tpu.config import (Blending as JBlending,
                                       Projection as JProjection,
                                       Stretch as JStretch)
from simplepanorama_tpu_torch import Config as TConfig
from simplepanorama_tpu_torch import stitcher as tstitcher
from simplepanorama_tpu_torch.config import (Blending as TBlending,
                                             Projection as TProjection,
                                             Stretch as TStretch)
from simplepanorama_tpu_torch.convert import stitch_result_from_numpy
from simplepanorama_tpu_torch.fixtures import fkh360_views
from simplepanorama_tpu_torch.render import exposure as expo

from test_torch_sten import N_VIEWS, _result

torch.set_num_threads(2)

TILT = np.radians(4.0)

# (name, Config fields by enum name)
OPTIONS = [
    ("cylindrical_simple_blend",
     dict(proj="CYLINDRICAL", blend="SIMPLE_BLEND")),
    ("cylindrical_no_blend_no_cut_seams",
     dict(proj="CYLINDRICAL", blend="NO_BLEND", cut_seams=False)),
    ("no_straighten_no_blend_intensity",
     dict(straighten=False, blend_intensity=False)),
    ("stereographic_linear_scaling",
     dict(proj="STEREOGRAPHIC", stretching="LINEAR_SCALING")),
]


def _configs(fields):
    """The same Config in both packages."""
    enums = {"proj": (JProjection, TProjection),
             "blend": (JBlending, TBlending),
             "stretching": (JStretch, TStretch)}
    out = []
    for k, cls in enumerate((JConfig, TConfig)):
        kw = {name: enums[name][k][v] if name in enums else v
              for name, v in fields.items()}
        out.append(dataclasses.replace(cls(), **kw))
    return out


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The 300-px views and their geometry, every camera tilted."""
    out = tmp_path_factory.mktemp("options")
    paths, _, f = fkh360_views(N_VIEWS, 300, out_dir=str(out))
    imgs = [cv2.imread(p) for p in paths]
    res = _result(f, 300)
    c, s = np.cos(TILT), np.sin(TILT)
    tilt = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    res.rot = np.stack([tilt @ R for R in res.rot])
    return imgs, res


def test_the_tilt_is_straightened(loop):
    """The loop's tilt is what straighten removes: the straightened
    rotations move by more than half the tilt's sine."""
    _, res = loop
    assert np.abs(expo.straighten(res.rot.copy()) - res.rot).max() > \
        np.sin(TILT) / 2


@pytest.mark.parametrize("name,fields", OPTIONS, ids=[o[0] for o in OPTIONS])
def test_set_config_preview_matches_jax(loop, name, fields):
    """set_config + render_preview of both packages on one StitchResult.
    Tolerance: the same rotations, canvas, offsets and preview shape; the
    warped masks differ on at most 0.1% of the block pixels (as
    tests/test_torch_modules.py's warp test; measured 0 spherical, 122 of
    1.4M pixels (8.7e-5) cylindrical: a footprint's edge column in
    another float order); the preview as that file's blend tests, at most
    1 level apart after the uint8 cast on at most 0.5% of the pixels,
    except where a flipped mask hands a pixel to another image, which
    only NO_BLEND without seams shows (its footprints paste in order): no
    more pixels over 1 level apart than there are flipped mask pixels
    (measured 97 for the cylindrical NO_BLEND, 0 for the others)."""
    imgs, res = loop
    cj, ct = _configs(fields)
    pj = jstitcher.set_config(res, imgs, cj)
    pt = tstitcher.set_config(stitch_result_from_numpy(res), imgs, ct,
                              device="cpu")
    np.testing.assert_allclose(pt.rot, np.asarray(pj.rot), atol=1e-9)
    assert pt.state.canvas_hw == tuple(pj.state.canvas_hw)
    assert pt.state.min_xy == tuple(pj.state.min_xy)
    assert (pt.sten_circle is None) == (pj.sten_circle is None)
    mj, mt = np.asarray(pj.state.masks), pt.state.masks.numpy()
    assert mj.shape == mt.shape
    flips = int((mj != mt).sum())
    assert flips <= 1e-3 * mj.size
    oj = np.asarray(jstitcher.render_preview(pj, cj))
    ot = tstitcher.render_preview(pt, ct)
    assert ot.dtype == np.uint8 and ot.shape == oj.shape
    diff = np.abs(ot.astype(np.int32) - oj.astype(np.int32)).max(-1)
    over = int((diff > 1).sum())
    assert (diff > 0).mean() <= 5e-3, float((diff > 0).mean())
    assert over <= (flips if fields.get("blend") == "NO_BLEND" else 0), \
        (over, flips)


def test_compose_state_from_numpy_needs_a_card_by_default(loop):
    """convert.compose_state_from_numpy runs on the card unless asked:
    with no GPU its default raises, as every stage entry point's does,
    and device="cpu" carries the JAX package's state across."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default does not raise")
    from simplepanorama_tpu_torch.convert import compose_state_from_numpy
    imgs, res = loop
    pj = jstitcher.set_config(res, imgs, JConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compose_state_from_numpy(pj.state)
    st = compose_state_from_numpy(pj.state, device="cpu")
    assert st.imgs.device.type == "cpu"
    np.testing.assert_array_equal(st.masks.numpy(), np.asarray(pj.state.masks))
