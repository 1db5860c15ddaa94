"""The benchmark's files, found by name.

BENCHMARK.json at the root of the checkout names the cells, their
configurations and traffic mixes, and the metrics. Everything that
belongs to one of them sits in a file of its own under `port_bench/`:

  configs/<config>.json      the configuration as it is run
  traffic/<traffic>.json     the traffic mix's parameters; its "kind" names
                             the general generator generators/<kind>.py
  workloads/<cell>.json      how the cell runs the program ("driver" names
                             drivers/<driver>.py) and the limits of its
                             correctness check
  metrics/<metric>.py        the reader of one per-layer metric
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file by its path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    workload: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bench_dir = os.path.join(root, "port_bench")
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config_name=entry["config"],
        config=_load_json(os.path.join(root, conf["file"])),
        traffic_name=entry["traffic"],
        traffic=_load_json(os.path.join(bench_dir, "traffic", entry["traffic"] + ".json")),
        workload=_load_json(os.path.join(bench_dir, "workloads", name + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def generator(kind: str):
    return importlib.import_module("generators." + kind)


def driver(kind: str):
    return importlib.import_module("drivers." + kind)


def metric_reader(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "port_bench", "metrics", name + ".py"),
                       "port_bench_metric_" + name.replace(".", "_"))
