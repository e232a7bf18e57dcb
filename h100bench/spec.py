"""What the benchmark reads from its files, found by name.

A cell is an entry of `workloads` in BENCHMARK.json. Its configuration
is the JSON file the `configs` entry names; its traffic mix is
`traffic/<traffic>.json`, whose 'driver' names the module under
`drivers/` that runs it; the limits of its correctness checks are
`limits/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`. Adding a configuration, a mix, a cell or a metric
is adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict                 # the configuration file as it is run
    traffic_name: str
    traffic: Dict
    limits: Dict                 # {check: limit}
    end_to_end: List[Dict]       # the metrics this cell reports
    per_layer: List[Dict]
    bench_dir: str = HERE

    def driver(self):
        return importlib.import_module(
            f"{__package__}.drivers.{self.traffic['driver']}")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root's BENCHMARK.json with its files."""
    bench = benchmark(root)
    bench_dir = os.path.join(root, os.path.basename(HERE))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    unnamed = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if unnamed:
        raise ValueError(f"per-layer metrics {unnamed} name no workloads: "
                         f"list the cells whose runs can read each")
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    limits_path = os.path.join(bench_dir, "limits", f"{name}.json")
    return Cell(
        name=name, chips=w["chips"], config_name=w["config"],
        config=_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=_json(os.path.join(bench_dir, "traffic",
                                   f"{w['traffic']}.json")),
        limits=_json(limits_path) if os.path.exists(limits_path) else {},
        end_to_end=e2e, per_layer=layer, bench_dir=bench_dir)


def metric_reader(bench_dir: str, name: str):
    """The `read(ctx)` of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    sp = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, ctx: Dict) -> Dict[str, Dict]:
    """{metric: value} of the cell's per-layer metrics; a reader that finds
    nothing to read gives None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(cell.bench_dir, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
