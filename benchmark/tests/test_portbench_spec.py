"""BENCHMARK.json against the contract's limits, and every cell resolved
by name to its files."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.run import load_json, load_module
from benchmark.tests.conftest import REPO, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    b = spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["benchmark"] and all(one_line(w) for w in b["command"])
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert one_line(m["layer"]) and m["moves"] in {e["name"] for e in b["end_to_end"]}
    assert len(names) == len(set(names))
    assert len(json.dumps(b).encode()) <= 64 * 1024


def test_config_files_hold_the_shape_as_run():
    b = spec()
    for c in b["configs"]:
        f = load_json(ROOT, "configs", c["name"])
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert set(f["published"]) == set(c["reduced"])
        for k in c["reduced"]:
            assert f[k] != f["published"][k]


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_cell_resolves_by_name(cell):
    b = spec()
    w = next(x for x in b["workloads"] if x["name"] == cell)
    f = load_json(ROOT, "workloads", cell)
    assert (f["config"], f["traffic"], f["chips"], f["why"]) == (w["config"], w["traffic"],
                                                                  w["chips"], w["why"])
    assert os.path.exists(os.path.join(ROOT, "configs", f"{f['config']}.json"))
    drv = load_module(ROOT, "traffic", f["driver"])
    assert callable(drv.setup) and callable(drv.window)
    for m in f["per_layer"]:
        mod = load_module(ROOT, "metrics", m)
        assert callable(mod.read) and UNIT.match(mod.UNIT)
        assert mod.UNIT == next(x["unit"] for x in b["per_layer"] if x["name"] == m)
    # the cell reports what BENCHMARK.json says it does
    e2e = {m["name"] for m in b["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(f["end_to_end"]) == e2e
    per = {m["name"] for m in b["per_layer"] if cell in m.get("workloads", [cell])}
    assert set(f["per_layer"]) == per
    moved = {m["moves"] for m in b["per_layer"] if m["name"] in per}
    assert moved <= e2e and "setup_s" in e2e
