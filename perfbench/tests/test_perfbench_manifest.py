"""``BENCHMARK.json`` against the rules a manifest is held to: its keys,
the characters of every name and unit, the files each entry names, the
metrics each cell reports, and the run length a full check can afford."""

import json
import re

import pytest

import perfbench_tiny as tiny
from harness import manifest

MAN = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(MAN) == KEYS
    assert len((tiny.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert not any(p.endswith("_torch") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90
    # s of compiling a cell, 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in MAN[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"])


def test_files_and_metrics_of_each_cell():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    configs = {c["name"]: c for c in MAN["configs"]}
    assert {w["config"] for w in MAN["workloads"]} == set(configs)
    for c in configs.values():
        conf = json.loads((tiny.ROOT / c["file"]).read_text())
        assert c["file"].startswith("perfbench/") and conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"] and conf["source"] == c["source"]
    for w in MAN["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.limits, f"{w['name']} has no limits file"
        reports = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reports and len(reports) >= 2
        assert cell.per_layer
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert (tiny.BENCH / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w]), (m["name"], w)
        manifest.reader(m["name"])


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_reader_returns_nothing_on_an_empty_trace(name):
    """A reader that finds nothing to read returns None, or a share of
    idle time; never a zero share of a roofline or peak."""
    from harness import tracing

    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 0.0,
               "dur": 1000.0}]
    tr = tracing.Trace(events, 1, tracing.Spans(), 1, frozenset())
    value = manifest.reader(name)(tr)
    if "roofline" in name or "mfu" in name:
        assert value is None
