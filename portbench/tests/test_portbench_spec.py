"""``BENCHMARK.json`` as the harness and the benchmark's contract read
it: every cell resolves to its files, names and units use the allowed
characters, and each per-layer reader agrees with its entry."""
import json
import re

import pytest
from conftest import CELLS, ROOT

from portbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_cells_in_order_on_one_chip():
    assert tuple(w["name"] for w in BENCH["workloads"]) == CELLS
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    spec = harness.load_spec(ROOT, cell)
    assert (harness.HERE / "patterns"
            / f"{spec.config['pattern']}.py").is_file()
    assert spec.traffic["direction"] in ("read", "write")
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and spec.per_layer
    for m in spec.per_layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


def test_names_units_and_entries():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    names = [e["name"] for e in entries]
    assert all(NAME.fullmatch(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert set(c["reduced"]) <= set(json.loads(
            (ROOT / c["file"]).read_text()))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["traffic"]) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_each_reader_agrees_with_its_entry():
    e2e = {m["name"]: set(m.get("workloads", CELLS))
           for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        mod = harness.load_module(harness.HERE / "metrics"
                                  / f"{m['name']}.py")
        assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"]
        assert set(m["workloads"]) <= e2e[m["moves"]]
