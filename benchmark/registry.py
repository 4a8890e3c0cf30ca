"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations and the metrics. A configuration's file, a traffic mix's
file and a per-layer metric's reader are found from their names alone, so
that a later cell, mix or metric is added as files and entries, with no
edit to a file that is already here:

- ``benchmark/configs/<config>.json`` (the path the entry's ``file`` gives),
- ``benchmark/traffic/<mix>.json``, whose ``loop`` names a module of
  ``benchmark/loops/``,
- ``benchmark/metrics/<metric>.py``, which defines ``read(run)``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: str = ROOT) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            with open(os.path.join(root, entry["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", name + ".json")) as f:
        return json.load(f)


def load_loop(traffic: dict) -> ModuleType:
    """The general generator and loop that a traffic mix names."""
    return importlib.import_module(f"benchmark.loops.{traffic['loop']}")


def metric_names(spec: dict, cell: dict, trace: bool) -> list[str]:
    """The metrics this cell reports: the end-to-end ones untraced, the
    per-layer ones traced; a metric with ``workloads`` only in those."""
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        if "workloads" not in m or cell["name"] in m["workloads"]:
            out.append(m["name"])
    return out


def metric_entry(spec: dict, name: str) -> dict:
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == name:
            return m
    raise KeyError(name)


def load_metric(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The reader of a per-layer metric, from ``metrics/<name>.py`` (a
    metric's name may hold dots, so it is loaded by path)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
