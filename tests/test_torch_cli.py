"""The port's CLI, checkpoint and Lowe-objective stitch against the JAX
package, on the CPU.

* ``cli._build_config``: the same Config from the same argv in both
  packages, config files written by either one included;
* the checkpoint (.npz, ``version: 1``): written by one package, read by
  the other, both ways;
* ``cli.main(..., "--device", "cpu")`` on 4 small views: a Lowe-objective
  stitch that saves its state, then a full-res render resumed from it;
* a 4-view ``Config(fast=True)`` stitch through both packages' Panorama,
  the port with the JAX package's RANSAC draws injected.
"""

import dataclasses

import cv2
import numpy as np
import pytest
import torch
import jax

import simplepanorama_tpu as J
from simplepanorama_tpu import cli as jcli
from simplepanorama_tpu.config import write_config_file as jwrite
from simplepanorama_tpu.stitch import StitchResult as JStitchResult
from simplepanorama_tpu.utils import checkpoint as jck
import simplepanorama_tpu_torch as T
from simplepanorama_tpu_torch import cli as tcli
from simplepanorama_tpu_torch.config import write_config_file as twrite
from simplepanorama_tpu_torch.fixtures import fkh360_views
from simplepanorama_tpu_torch.stitch import StitchResult as TStitchResult
from simplepanorama_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)


def _cfg_dict(cfg):
    """Config fields with the enums as their integer values (the two
    packages have their own enum classes)."""
    return {k: (int(v) if hasattr(v, "name") else v)
            for k, v in dataclasses.asdict(cfg).items()}


def _ncc(a, b):
    a = a.astype(np.float64).ravel() - a.mean()
    b = b.astype(np.float64).ravel() - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


@pytest.mark.parametrize("argv", [
    [],
    ["--fast", "--init-size", "320", "--blend", "SIMPLE_BLEND",
     "--no-straighten", "--lambda", "0.5", "--RANSAC-iterations", "300"],
    ["--graph-cut", "--gain", "--proj", "CYLINDRICAL", "--stretching",
     "LINEAR_SCALING", "--bands", "3", "--sigma-blend", "5.5",
     "--no-blend-intensity", "--max-keypoints", "100", "--conf", "0.05"],
    ["--config", "{jax}"],
    ["--config", "{port}", "--no-fast", "--focal", "900"],
])
def test_build_config_matches_jax(argv, tmp_path):
    """The same argv gives the same Config in both packages, and each
    package writes it to the same key=value text. ``{jax}`` and
    ``{port}`` stand for a config file of non-default values written by
    that package."""
    src = J.Config(fast=True, init_size=500, blend=J.Blending.NO_BLEND,
                   gain_compensation=True, lambda_=0.25, nfeatures=800,
                   contrastThreshold=0.05)
    jwrite(tmp_path / "jax.cfg", src)
    twrite(tmp_path / "port.cfg", T.Config(**_cfg_dict(src)))
    argv = [a.format(jax=tmp_path / "jax.cfg", port=tmp_path / "port.cfg")
            for a in argv]
    jcfg = jcli._build_config(_jax_args(argv))
    tcfg = tcli._build_config(tcli._parser().parse_args(argv))
    assert _cfg_dict(tcfg) == _cfg_dict(jcfg)
    jwrite(tmp_path / "j.out", jcfg)
    twrite(tmp_path / "t.out", tcfg)
    assert (tmp_path / "j.out").read_text() == (tmp_path / "t.out").read_text()


def _jax_args(argv):
    """The JAX CLI's parsed arguments: its main() builds the parser
    inline, so parse with a copy of its flags."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("images", nargs="*")
    jcli._add_config_flags(p)
    return p.parse_args(argv)


def _result(cls):
    """A 3-node StitchResult of either package with non-trivial values."""
    rng = np.random.default_rng(2)
    return cls(rot=rng.normal(size=(3, 3, 3)), K=rng.normal(size=(3, 3, 3)),
               adj=np.triu(rng.uniform(size=(3, 3)), 1),
               connectivity=np.array([2, 1, 1]),
               order=[(1, -1), (0, 1), (2, 1)], nodes=[0, 2, 3], center=1,
               sizes=[(300, 400), (310, 400), (300, 420)])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_across_packages(direction, tmp_path):
    """A checkpoint written by one package loads in the other with every
    field equal, the image list included."""
    path = tmp_path / "state.npz"
    paths = ["a.jpg", "b.jpg", "c.jpg", "d.jpg"]
    if direction == "jax_to_port":
        src = _result(JStitchResult)
        jck.save_stitch_state(path, src, paths=paths)
        got, got_paths = tck.load_stitch_state(path, with_paths=True)
        assert isinstance(got, TStitchResult)
    else:
        src = _result(TStitchResult)
        tck.save_stitch_state(path, src, paths=paths)
        got, got_paths = jck.load_stitch_state(path, with_paths=True)
        assert isinstance(got, JStitchResult)
    assert got_paths == paths
    for f in ("rot", "K", "adj", "connectivity"):
        assert np.array_equal(getattr(got, f), getattr(src, f)), f
    for f in ("order", "nodes", "center", "sizes"):
        assert getattr(got, f) == getattr(src, f), f


@pytest.fixture(scope="module")
def four_views(tmp_path_factory):
    """4 views of 640 px, 20-degree yaw steps, 45-degree FOV, +-3 degree
    roll (the well-posed views of tests/test_torch_slice.py at 2x)."""
    out = tmp_path_factory.mktemp("views640")
    paths, _, f = fkh360_views(4, 640, yaw_step_deg=20.0, hfov_deg=45.0,
                               roll_deg=3.0, out_dir=str(out))
    return out, paths, f


@pytest.fixture(scope="module")
def cli_run(four_views, tmp_path_factory):
    """The user's two commands on the CPU: a Lowe-objective stitch of the
    view directory at init_size 320 that saves its state, then a full-res
    render resumed from that state; and a resumed preview."""
    views, _, _ = four_views
    out = tmp_path_factory.mktemp("cli")
    state, prev, full, prev2 = (str(out / n) for n in (
        "s.npz", "preview.png", "full.png", "preview2.png"))
    common = ["--device", "cpu", "--init-size", "320", "--quiet"]
    rc1 = tcli.main([str(views), "--fast", "--RANSAC-iterations", "300",
                     "--timing", "--save-state", state, "-o", prev]
                    + common)
    rc2 = tcli.main(["--from-state", state, "--full-res", "-o", full]
                    + common)
    rc3 = tcli.main(["--from-state", state, "-o", prev2] + common)
    return (rc1, rc2, rc3), state, [cv2.imread(p) for p in (prev, full,
                                                            prev2)]


def test_cli_stitch_saves_state(cli_run, four_views):
    """The stitch returns 0, writes the preview and a checkpoint that
    lists the 4 views and connects all of them. The preview spans the
    views' 105 degrees of yaw at about the 320-px working height
    (measured 310 x 711)."""
    rcs, state, (prev, _, _) = cli_run
    assert rcs[0] == 0 and prev is not None
    res, paths = tck.load_stitch_state(state, with_paths=True)
    assert paths == four_views[1] and res.nodes == [0, 1, 2, 3]
    assert 280 <= prev.shape[0] <= 360 and prev.shape[1] >= 2 * prev.shape[0]


def test_cli_resume_full_res(cli_run):
    """The resumed full-res render returns 0 and is about 2x the preview
    (views of 640 px at init_size 320), within 8 px on each side."""
    rcs, _, (prev, full, _) = cli_run
    assert rcs[1] == 0 and full is not None
    assert abs(full.shape[0] - 2 * prev.shape[0]) <= 8
    assert abs(full.shape[1] - 2 * prev.shape[1]) <= 8
    small = cv2.resize(full, (prev.shape[1], prev.shape[0]),
                       interpolation=cv2.INTER_AREA)
    both = (prev.max(axis=2) > 0) & (small.max(axis=2) > 0)
    assert _ncc(prev[both], small[both]) >= 0.95


def test_cli_resume_preview_equals_stitch_preview(cli_run):
    """A preview resumed from the checkpoint equals the stitch's own
    preview pixel for pixel: the checkpoint carries the whole BA state."""
    rcs, _, (prev, _, prev2) = cli_run
    assert rcs[2] == 0
    assert prev.shape == prev2.shape and np.array_equal(prev, prev2)


def test_cli_needs_two_images(tmp_path):
    """Fewer than two inputs and no checkpoint: exit code 1, no work."""
    assert tcli.main([str(tmp_path / "only.jpg"), "--device", "cpu"]) == 1


def test_cli_default_device_is_the_card(four_views, tmp_path):
    """--device defaults to cuda: without a card the CLI raises, as
    Panorama does, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(four_views[1][:2] + ["-o", str(tmp_path / "p.jpg")])


@pytest.mark.slow
def test_jax_lowe_focals_set_the_slice3_gate(tmp_path):
    """The reference behind chip_smoke.py's slice-3 focal gate: the JAX
    package's own Lowe-objective stitch (Config(fast=True), default
    init_size 700) of the loop that the slice3 phase stitches on the card
    (12 pure-yaw views of 1400 px over 360 degrees), on the CPU. All 12
    connect, and five times its largest relative focal error stays
    within the gate. Prints one JSON line (``-s`` shows it)."""
    import json
    import chip_smoke
    paths, _, f_full = fkh360_views(12, 1400, out_dir=str(tmp_path))
    f_true = f_full * 700 / 1400
    p = J.Panorama(paths).stitch(J.Config(fast=True))
    focals = np.asarray(p.result.K)[:, 0, 0]
    err = float(np.max(np.abs(focals / f_true - 1.0)))
    print(json.dumps({"objective": "lowe", "connected": list(p.connected),
                      "focal_true": f_true,
                      "focals": [float(f) for f in focals],
                      "max_rel_err": err,
                      "gate": chip_smoke.SLICE3_FOCAL_GATE}))
    assert tuple(p.connected) == (12, 12)
    assert 5 * err <= chip_smoke.SLICE3_FOCAL_GATE


def _jax_draws(n):
    """The JAX package's per-pair RANSAC uniforms (adjacency._pair_keys,
    homography.ransac_homography), for the port's draw hook."""
    master = jax.random.PRNGKey(0)

    def draws(i, j, n_iter, m):
        key = jax.random.fold_in(master, i * n + j)
        return np.array(jax.random.uniform(key, (n_iter, m)))
    return draws


def test_lowe_stitch_matches_jax(tmp_path):
    """Config(fast=True) at init_size 320 on 4 views of 320 px (the views
    of tests/test_torch_slice.py), default compositing (distance-
    transform seams, MULTI_BLEND): all connected in both packages, focals
    within 1e-3 relative of the JAX package's, previews of one shape
    with NCC >= 0.99."""
    paths, _, _ = fkh360_views(4, 320, yaw_step_deg=20.0, hfov_deg=45.0,
                               roll_deg=3.0, out_dir=str(tmp_path))
    cfg = dict(fast=True, init_size=320, RANSAC_iterations=300)
    pj = J.Panorama(paths).stitch(J.Config(**cfg))
    pt = T.Panorama(paths, device="cpu")
    pt.pair_draws = _jax_draws(len(paths))
    pt.stitch(T.Config(**cfg))
    assert tuple(pt.connected) == tuple(pj.connected) == (4, 4)
    np.testing.assert_allclose(pt.result.K[:, 0, 0], pj.result.K[:, 0, 0],
                               rtol=1e-3)
    prev_j, prev_t = np.asarray(pj.get_preview()), pt.get_preview()
    assert prev_t.shape == prev_j.shape
    assert _ncc(prev_j, prev_t) >= 0.99
