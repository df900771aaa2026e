"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it resolved to its files."""
import importlib
import json
import re

import pytest

from bench import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_KEY = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|"
                       r"_rank$|head|expansion|experts_per_tok|d_model|"
                       r"d_ff|embed)")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    # a full check with 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_text_fields():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert all(not WIDTH_KEY.search(k) for k in c["reduced"])


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        have = harness.metrics_of(BENCH, cell, "end_to_end")
        assert "setup_s" in {m["name"] for m in have}
        assert len(have) >= 2


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader_and_moves_its_cells_metric(metric):
    m = {x["name"]: x for x in BENCH["per_layer"]}[metric]
    reader = harness.load_reader(metric)
    assert callable(reader.read)
    moves = {x["name"]: x for x in BENCH["end_to_end"]}[m["moves"]]
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in moves.get("workloads", CELLS)
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    if metric.split(".")[0].endswith("_roofline") or "mfu" in metric:
        assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    files = harness.resolve(BENCH, cell)
    mod = importlib.import_module(f"bench.drivers.{files['driver']}")
    assert hasattr(mod, "Driver")
    assert files["limits"], "a cell compares at least one number"
    assert harness.metrics_of(BENCH, cell, "per_layer")
    conf = {c["name"]: c for c in BENCH["configs"]}[
        files["workload"]["config"]]
    assert conf["file"].startswith("bench/configs/")
    assert files["config"]["name"] == conf["name"]
