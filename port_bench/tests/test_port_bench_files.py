"""The benchmark's files: every name BENCHMARK.json uses is found, and the
file keeps to the limits of its contract."""

from __future__ import annotations

import json
import os
import re

import pytest

import tiny  # noqa: F401  (puts port_bench and the root on the path)
from pbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.join(spec.ROOT, "port_bench")
# the cells' per-layer metrics read from their traced runs
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    c = spec.cell(cell)
    assert c.chips == 1
    assert os.path.exists(os.path.join(HERE, "drivers", c.workload["driver"] + ".py"))
    assert os.path.exists(os.path.join(HERE, "generators", c.traffic["kind"] + ".py"))
    for m in c.per_layer:
        assert hasattr(spec.metric_reader(m["name"]), "read")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:  # each per-layer metric moves a metric its cell reports
        assert m["moves"] in e2e


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert conf["file"].startswith("port_bench/configs/")
    assert cfg["reduced"] == conf["reduced"]
    # no width is ever cut
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in conf["reduced"])
    assert cfg["hidden_size"] == 4096 and cfg["intermediate_size"] == 14336
    assert cfg["num_attention_heads"] == 32 and cfg["num_key_value_heads"] == 8
    assert cfg["vocab_size"] == 32000


def test_every_metric_file_is_named():
    files = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics")) if f.endswith(".py")}
    assert files == {m["name"] for m in BENCH["per_layer"]}
