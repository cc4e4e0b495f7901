"""What the benchmark loads: never JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's); and a reference that loads nothing of the port."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "simplepanorama_tpu"}


def _top_level_after(code: str) -> set:
    prog = ("import json, sys; sys.path.insert(0, %r)\n" % str(REPO) + code
            + "\nprint(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_loads_no_jax():
    mods = _top_level_after(
        "import panobench.run, panobench.cell, panobench.views, "
        "panobench.devtrace, panobench.reference.judge\n"
        "import simplepanorama_tpu_torch.pipeline, "
        "simplepanorama_tpu_torch.stitcher, simplepanorama_tpu_torch.stitch,"
        " simplepanorama_tpu_torch.ops.maxflow, "
        "simplepanorama_tpu_torch.ops.ba_kernel, "
        "simplepanorama_tpu_torch.render.graphcut, "
        "simplepanorama_tpu_torch.render.fullres\n"
        "import glob, pathlib\n"
        "from panobench import cell\n"
        "for p in sorted(glob.glob('panobench/requests/*.py') + "
        "glob.glob('panobench/metrics/*.py')):\n"
        "    cell.load_module(pathlib.Path(p))\n")
    assert "simplepanorama_tpu_torch" in mods      # the port, allowed
    assert not (mods & FORBIDDEN), mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    mods = _top_level_after("import panobench.reference.truth, "
                            "panobench.reference.seams, "
                            "panobench.reference.judge")
    assert "simplepanorama_tpu_torch" not in mods
    assert not (mods & FORBIDDEN)
