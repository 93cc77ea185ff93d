"""BENCHMARK.json and the files it names, found by name.

A cell of BENCHMARK.json's "workloads" names its configuration and its
traffic mix; each lives in a file of its own (the configuration's "file",
traffic/<traffic>.json), as do the cell's correctness limits
(limits/<cell>.json), every metric's reader (metrics/<metric>.py) and
every kernel's counts (rooflines/<kernel>.py).  A later cell, mix,
metric or kernel is new files and entries, and no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_module(path: str, name: str):
    """Import one reader or count file by its path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict                # the configuration's file
    traffic: dict               # traffic/<name>.json
    limits: dict                # limits/<cell>.json
    end_to_end: list            # BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: str = HERE

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        metric + ".py"),
                           "portbench_metric_" + metric.replace(".", "_"))


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load(workload: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"there are {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(bench_dir, "limits", workload + ".json")) as f:
        limits = json.load(f)
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, workload)],
                bench_dir=bench_dir)


def rooflines(bench_dir: str = HERE) -> dict:
    """Every kernel's count file under rooflines/, by kernel name."""
    out = {}
    folder = os.path.join(bench_dir, "rooflines")
    for fn in sorted(os.listdir(folder)):
        if fn.endswith(".py") and not fn.startswith("_") and fn != "peaks.py":
            out[fn[:-3]] = load_module(os.path.join(folder, fn),
                                       "portbench_roofline_" + fn[:-3])
    return out
