"""``BENCHMARK.json`` keeps to its contract's form, and every entry finds
its files by name: configuration, traffic mix, loop, reference, readers."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

BENCH = spec.load()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in BENCH["workloads"]]


def text_ok(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and all(PATH.fullmatch(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(text_ok(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_keys_and_names(group):
    entries = BENCH[group]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == KEYS[group], e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert text_ok(e[key]), (e["name"], key)
        for cell in e.get("workloads", ()):
            assert cell in CELLS


def test_metric_names_are_unique_across_groups():
    names = [m["name"] for g in ("end_to_end", "per_layer") for m in BENCH[g]]
    assert len(set(names)) == len(names)


def test_bounds():
    by = {m["name"]: m for m in BENCH["end_to_end"]}
    assert by["setup_s"]["bound"] == 0.25 and "workloads" not in by["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_metrics_name_their_cells():
    # a later cell is added by new entries alone, never by editing a
    # metric's list; only setup_s is every cell's
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert ("workloads" in m) == (m["name"] != "setup_s"), m["name"]


def test_configs():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/") and (spec.ROOT / c["file"]).is_file()
        cfg = spec.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == [] and cfg["precision"] == "exact"
        assert {"method", "src_w", "src_h", "dst_w", "dst_h", "reference"} <= set(cfg)
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files(cell):
    w = spec.cell(BENCH, cell)
    assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] == 1
    traffic = spec.traffic(w["traffic"])
    loop = spec.loop(traffic["loop"])
    strata, per_stratum, per_call = loop.sampling(traffic)
    assert loop.pool_frames(traffic) > 0 and min(strata, per_stratum, per_call) > 0
    cfg = spec.config(BENCH, w["config"])
    assert hasattr(spec.reference(cfg["reference"]), "Frame")
    e2e = [m["name"] for m in spec.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.per_layer(BENCH, cell)
    assert layers and all(m["moves"] in e2e for m in layers)
    for m in spec.end_to_end(BENCH, cell) + layers:
        assert callable(spec.reader(m["name"]))


def test_per_layer_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_a_missing_file_is_named():
    with pytest.raises(KeyError, match="metrics/no_such_metric.py"):
        spec.reader("no_such_metric")
