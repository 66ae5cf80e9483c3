"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, the files each entry names, and the check's time budget."""
from __future__ import annotations

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def _line(s, limit=200):
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def test_keys_and_names(bench):
    assert set(bench) == KEYS["top"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert KEYS[group] <= set(e) <= KEYS[group] | extra, e
            assert NAME.match(e["name"]), e["name"]
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_command_and_paths(bench):
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(ROOT, p))
        assert not p.rstrip("/").endswith("_torch")
    for w in cmd:
        assert not w.startswith("/") and ".." not in w.split("/")


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert c["name"] in used
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert _line(c["why"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        with open(os.path.join(ROOT, c["file"])) as f:
            spec = json.load(f)
        assert spec["reduced"] == c["reduced"] and spec["source"] == c["source"]
        assert os.path.exists(os.path.join(ROOT, spec["yaml"]))


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    four = 0
    for w in bench["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert _line(w["why"])
        traffic = os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json")
        with open(traffic) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "drivers", driver + ".py"))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "limits", w["name"] + ".json"))
    assert 1 <= len(bench["workloads"]) <= 24
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= set(cells)
    layers = {}
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        movers = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(movers), m["name"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline_pct") or "_roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        mine = [m for m in bench["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])


def test_time_budget(bench):
    """A full check of 24 cells fits its 12 hours at this run length."""
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
