"""Find a cell of ``BENCHMARK.json`` and the files that belong to it, by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the ``file`` of its entry in ``configs``; the
traffic mix is ``port_bench/traffic/<traffic>.json``; each metric is read
by ``port_bench/metrics/<metric name>.py``. So a later change adds a cell, a
configuration, a traffic mix or a metric by adding files and entries, and
edits none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that cannot be found or
    is malformed."""


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    end_to_end: List[Dict] = field(default_factory=list)
    per_layer: List[Dict] = field(default_factory=list)
    root: str = ROOT

    @property
    def runner(self) -> str:
        return self.traffic["runner"]


def _load_json(path: str) -> Dict:
    try:
        with open(path, encoding="utf8") as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing file: {path}") from e


def load_benchmark(root: str = ROOT) -> Dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"bad {kind} name: {name!r}")
    return name


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its
    configuration, its traffic mix and the metrics it reports."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no cell {name!r}; cells: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_name = _check_name("config", w["config"])
    if cfg_name not in configs:
        raise SpecError(f"cell {name} names an unknown config {cfg_name!r}")
    config = _load_json(os.path.join(root, configs[cfg_name]["file"]))
    traffic_name = _check_name("traffic", w["traffic"])
    traffic = _load_json(os.path.join(root, "port_bench", "traffic", f"{traffic_name}.json"))
    if "runner" not in traffic:
        raise SpecError(f"traffic {traffic_name} names no runner")
    return Cell(
        name=name, chips=int(w["chips"]), config_name=cfg_name, config=config,
        traffic_name=traffic_name, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)], root=root)


def metric_reader(name: str, root: str = ROOT) -> ModuleType:
    """The module ``port_bench/metrics/<name>.py``; its ``read(run)``
    returns the metric's value, or None where the run holds nothing to
    read."""
    path = os.path.join(root, "port_bench", "metrics", f"{_check_name('metric', name)}.py")
    if not os.path.exists(path):
        raise SpecError(f"no reader for metric {name}: {path}")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"{path} has no read(run)")
    return mod


def read_metrics(metrics: List[Dict], run, root: str = ROOT) -> Dict[str, Dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read in ``run``."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
