"""The photo sets: the same seed gives the same files, and each view is
the source photo seen through its true camera."""

from __future__ import annotations

import math

import cv2
import numpy as np
import torch

from panobench import views
from panobench.reference import truth

TRAFFIC = {"views": 3, "size": 300, "hfov_deg": 60.0, "yaw_step_deg": 30.0,
           "roll_deg": [0.0, 3.0], "gain": [0.9, 1.1], "jpeg": 95,
           "pool": 2, "pool_seed": 2 ** 31 + 5}


def _bytes(sets):
    return [[open(p, "rb").read() for p in s.paths] for s in sets]


def test_same_seed_same_files(tmp_path):
    a = views.make_sets(TRAFFIC, str(tmp_path / "a"), "cpu")
    b = views.make_sets(TRAFFIC, str(tmp_path / "b"), "cpu")
    c = views.make_sets(dict(TRAFFIC, pool_seed=2 ** 31 + 6),
                        str(tmp_path / "c"), "cpu")
    assert _bytes(a) == _bytes(b)
    assert _bytes(a) != _bytes(c)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.yaw_deg, y.yaw_deg)
        np.testing.assert_array_equal(x.roll_deg, y.roll_deg)
        np.testing.assert_array_equal(x.gain, y.gain)


def test_draws_within_the_traffic(tmp_path):
    sets = views.make_sets(dict(TRAFFIC, pool=4, pool_seed=11), str(tmp_path),
                           "cpu")
    for s in sets:
        assert 0.0 <= s.yaw_deg[0] < 30.0
        np.testing.assert_allclose(np.diff(s.yaw_deg), 30.0)
        assert (np.abs(s.roll_deg) <= 3.0).all()
        # alternating sign
        assert (s.roll_deg[0::2] >= 0).all() and (s.roll_deg[1::2] <= 0).all()
        assert ((s.gain >= 0.9) & (s.gain <= 1.1)).all()
        for R in s.R:
            np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_views_show_the_true_cameras(tmp_path):
    """A pixel of a view is the source's colour at the ray its true
    camera gives it, times the view's gain (up to JPEG's loss)."""
    s = views.make_sets(dict(TRAFFIC, pool_seed=3), str(tmp_path),
                        "cpu")[0]
    src = views.load_source("cpu").to(torch.float64)
    K = truth.true_K(s.size, s.hfov_deg, s.size)
    rng = np.random.default_rng(0)
    for k, path in enumerate(s.paths):
        img = cv2.imread(path).astype(np.float64)
        px = rng.uniform(20, s.size - 20, (200, 2))
        rays = np.concatenate([px, np.ones((200, 1))], 1) @ \
            (s.R[k] @ np.linalg.inv(K)).T
        lon = torch.from_numpy(np.arctan2(rays[:, 0], rays[:, 2]))
        lat = torch.from_numpy(np.arctan2(rays[:, 1],
                                          np.hypot(rays[:, 0], rays[:, 2])))
        want = truth.equirect_sample(src, lon, lat).numpy() * s.gain[k]
        got = img[np.round(px[:, 1]).astype(int), np.round(px[:, 0]).astype(int)]
        # nearest pixel against the exact point: a fraction of a pixel
        # on a photo upsampled about 1.5 times, plus JPEG
        assert np.median(np.abs(got - want)) < 12.0
    assert abs(truth.focal_px(300, 60.0) * math.tan(math.radians(30)) - 150) < 1e-9
