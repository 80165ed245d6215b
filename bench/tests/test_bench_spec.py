"""BENCHMARK.json and the files the harness finds by name in it."""
import json
import math
import re
import shutil

import pytest

import run
from reference import hemm as ref

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_entry_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")


def test_rooflines_and_peak_shares_are_percent():
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%", m["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = run.load_cell(cell)
    assert c.chips == 1
    assert set(c.settings) == {"profile_requests", "sample", "limits"}
    assert list(c.settings["limits"]) == list(ref.NUMBERS)
    kind = run.kind_module(c)
    assert callable(kind.Session) and kind.SPANS
    assert {m["name"] for m in c.end_to_end} == {"request_ms", "peak_mem_gb",
                                                 "setup_s"}
    assert len(c.per_layer) == len(SPEC["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"]
                                    + SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(run.reader(metric))


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


SOURCE_VALUES = {"fame-m-setb": dict(logN=15, L=15, k=8, beta=2, m=128,
                                     l=128, n=128, logq_paper=855 / 16),
                 "fame-l-setc": dict(logN=16, L=31, k=12, beta=3, m=160,
                                     l=160, n=160, logq_paper=1693 / 32)}


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_configuration_keeps_the_source_but_what_it_reduces(entry):
    """Table II / III values; a changed key is listed in ``reduced``."""
    assert entry["file"].startswith("bench/configs/")
    cfg = json.loads((run.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    for key, want in SOURCE_VALUES[entry["name"]].items():
        if key in entry["reduced"]:
            assert cfg[key] != want and cfg["source_shape"][key] == want
        else:
            assert math.isclose(cfg[key], want), key


def test_a_traffic_setting_that_the_kind_does_not_serve_is_refused():
    c = run.load_cell(CELLS[0])
    kind = run.kind_module(c)
    for extra in ({"clients": 4}, {"arrival": "poisson"}):
        with pytest.raises(ValueError, match="traffic takes exactly"):
            kind.pairs(c.config, dict(c.traffic, **extra), 1)


def test_a_per_layer_metric_without_its_cells_is_refused(toy, tmp_path):
    spec = json.loads((toy / "BENCHMARK.json").read_text())
    del spec["per_layer"][0]["workloads"]
    shutil.copytree(toy, tmp_path, dirs_exist_ok=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(SystemExit, match="lists no workloads"):
        run.load_cell(spec["workloads"][0]["name"], tmp_path)
