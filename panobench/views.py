"""The traffic of the stitcher's cells: seeded sets of photos.

A frozen copy of the program's test fixture
``simplepanorama_tpu_torch.fixtures.fkh360_views``, extended with a seed:
square pinhole views cut out of the 360-degree equirectangular photo
``panobench/data/FKH360_300.jpg``, ``yaw_step_deg`` apart. From the
traffic's ``pool_seed`` each set draws the loop's starting yaw (uniform
over one yaw step), each view's roll about its optical axis (a magnitude
in ``roll_deg = [lo, hi]``, alternating in sign, as the fixture's rolls
alternate: pure-yaw pairs leave the homography focal estimate
degenerate) and each view's exposure gain (uniform in ``gain``, a
handheld camera under auto-exposure). The views are rendered on the
device, in one batch of rays per view, and written as JPEG files; the
stitcher receives only the files.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from concurrent.futures import ThreadPoolExecutor
from typing import List

import cv2
import numpy as np
import torch

from panobench.reference import truth

SOURCE = pathlib.Path(__file__).resolve().parent / "data" / "FKH360_300.jpg"


@dataclasses.dataclass
class ViewSet:
    """One set of photos and its true cameras."""
    paths: List[str]
    yaw_deg: np.ndarray      # (n,)
    roll_deg: np.ndarray     # (n,)
    gain: np.ndarray         # (n,)
    size: int
    hfov_deg: float
    yaw_step_deg: float

    @property
    def R(self) -> np.ndarray:
        return truth.true_rotations(self.yaw_deg, self.roll_deg)


def load_source(device) -> torch.Tensor:
    """The equirectangular photo as (H, W, 3) BGR float32 on ``device``."""
    img = cv2.imread(str(SOURCE), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(SOURCE)
    return torch.from_numpy(img).to(device=device, dtype=torch.float32)


def draw_params(rng: np.random.Generator, traffic: dict) -> dict:
    """One set's yaws, rolls and gains, drawn from ``rng``."""
    n = int(traffic["views"])
    step = float(traffic["yaw_step_deg"])
    lo, hi = traffic["roll_deg"]
    glo, ghi = traffic["gain"]
    yaw0 = rng.uniform(0.0, step)
    sign = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    return {"yaw_deg": yaw0 + step * np.arange(n),
            "roll_deg": sign * rng.uniform(lo, hi, n),
            "gain": rng.uniform(glo, ghi, n)}


def render_view(src: torch.Tensor, size: int, hfov_deg: float,
                R: np.ndarray, gain: float) -> np.ndarray:
    """One view as (size, size, 3) BGR uint8."""
    lon, lat = truth.view_rays(size, hfov_deg, R, src.device)
    img = truth.equirect_sample(src, lon, lat) * gain
    return torch.round(img).clamp(0, 255).to(torch.uint8).cpu().numpy()


def make_sets(traffic: dict, out_dir: str, device,
              threads: int = 4) -> List[ViewSet]:
    """The cell's pool of ``traffic["pool"]`` sets, drawn from the
    traffic's ``pool_seed`` (every run does the same work;
    ``visit_order`` draws the order from the run's seed) and written
    under ``out_dir`` as JPEG (quality ``traffic["jpeg"]``)."""
    rng = np.random.default_rng(int(traffic["pool_seed"]) % 2 ** 64)
    src = load_source(device)
    n_sets = int(traffic["pool"])
    size = int(traffic["size"])
    hfov = float(traffic["hfov_deg"])
    quality = [cv2.IMWRITE_JPEG_QUALITY, int(traffic["jpeg"])]
    sets = []
    with ThreadPoolExecutor(threads) as ex:
        writes = []
        for s in range(n_sets):
            p = draw_params(rng, traffic)
            d = os.path.join(out_dir, f"set{s}")
            os.makedirs(d, exist_ok=True)
            vs = ViewSet(paths=[], size=size, hfov_deg=hfov,
                         yaw_step_deg=float(traffic["yaw_step_deg"]), **p)
            for k, R in enumerate(vs.R):
                img = render_view(src, size, hfov, R, float(vs.gain[k]))
                path = os.path.join(d, f"view_{k:02d}.jpg")
                vs.paths.append(path)
                writes.append(ex.submit(_write, path, img, quality))
            sets.append(vs)
        for w in writes:
            w.result()
    return sets


def visit_order(seed: int, n_sets: int) -> List[int]:
    """The order in which a run visits the pool: the first set is the
    cold one of set-up, the window cycles through the others and then it."""
    rng = np.random.default_rng([seed % 2 ** 63, 3])
    return [int(k) for k in rng.permutation(n_sets)]


def _write(path: str, img: np.ndarray, params) -> None:
    if not cv2.imwrite(path, img, params):
        raise OSError(f"could not write {path}")
