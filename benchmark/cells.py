"""Find a cell's files by the names in BENCHMARK.json.

A workload names a configuration (its `file`) and a traffic mix
(traffic/<traffic>.json); the cell's own settings are cells/<workload>.json;
a per-layer metric is metrics/<name>.py with a `read(ctx)` function. A later
cell, mix or metric is a new file and a new entry: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)  # the checkout


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict  # cells/<workload>.json
    end_to_end: list  # the BENCHMARK.json entries that this cell reports
    per_layer: list


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(by_name)}")
    w = by_name[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(os.path.join(root, config["file"])),
        traffic=_json(os.path.join(root, "benchmark", "traffic", w["traffic"] + ".json")),
        settings=_json(os.path.join(root, "benchmark", "cells", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def metric_reader(name: str, root: str = ROOT):
    """metrics/<name>.py's `read(ctx) -> float | None`."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
