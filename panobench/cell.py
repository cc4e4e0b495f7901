"""Find a cell's pieces by name.

A cell is ``<config>.<traffic>``, an entry of ``workloads`` in
``BENCHMARK.json``. Everything else is a file of its own under
``panobench/``, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the stitcher's settings (``stitcher``: the
  fields of the program's ``Config``), the source, ``assumed``,
  ``reduced`` and the guarantees the cell holds the program to;
- ``traffic/<traffic>.json``: the views (count, size, field of view,
  yaw step, roll, exposure gain, JPEG quality), the pool of sets, the
  request kinds of one panorama and how many panoramas are checked;
- ``requests/<kind>.py``: one request kind, ``run(req)``;
- ``metrics/<metric>.py``: one metric, ``read(ctx)``, which returns a
  number or None where it finds nothing to read;
- ``limits/<cell>.json``: the limit of each number the cell compares.

Adding a configuration, a traffic mix, a request kind or a metric adds
files; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable, Dict, List


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict             # configs/<config>.json
    traffic: dict            # traffic/<traffic>.json
    limits: Dict[str, float]
    end_to_end: List[dict]   # BENCHMARK.json entries this cell reports
    per_layer: List[dict]
    root: pathlib.Path

    def requests(self) -> Dict[str, Callable]:
        return {k: load_module(self.root / "panobench" / "requests"
                               / f"{k}.py").run
                for k in self.traffic["requests"]}

    def readers(self, metrics: List[dict]) -> Dict[str, Callable]:
        return {m["name"]: load_module(self.root / "panobench" / "metrics"
                                       / f"{m['name']}.py").read
                for m in metrics}


def load_module(path: pathlib.Path):
    """Import one file as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"panobench: no file {path}")
    spec = importlib.util.spec_from_file_location(
        "panobench_file_" + path.stem.replace("-", "_").replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"panobench: no file {path}")
    return json.loads(path.read_text())


def _in_cell(metric: dict, name: str, reported: set) -> bool:
    if "workloads" in metric:
        return name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"panobench: no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    traffic = _json(root / "panobench" / "traffic" / f"{w['traffic']}.json")
    limits = _json(root / "panobench" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _in_cell(m, name, reported)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, root=root)
