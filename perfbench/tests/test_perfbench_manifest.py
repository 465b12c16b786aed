"""``BENCHMARK.json``'s shape: its keys, names and units, the limits on
its sizes, and every cell, metric and configuration found by name in
files of its own."""
import json
import re
from pathlib import Path

import pytest

from perfbench import cell as C

ROOT = Path(C.__file__).resolve().parent.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(MAN["workloads"])
    # the full check of 24 cells fits its time
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24


def test_configs_and_cells():
    names = [c["name"] for c in MAN["configs"]]
    assert len(set(names)) == len(names)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        for k in c["reduced"]:
            assert NAME.match(k) and conf["published"][k] != conf[k]
            assert not k.endswith(("_dim", "_rank", "_size"))
        assert (ROOT / "perfbench" / "reference"
                / f"{conf['reference']}.py").is_file()
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    assert used == set(names)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN[kind]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys, m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        C.metric_reader(m["name"])                 # a reader of its own
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0 < m["bound"] <= 0.25
        else:
            assert m["moves"] in e2e
            moved = set(e2e[m["moves"]].get("workloads", cells))
            assert set(m["workloads"]) <= moved
    for w in cells:                  # every cell: setup_s, another, a layer
        cell = C.load_cell(w)
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
