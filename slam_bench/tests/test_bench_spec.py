"""BENCHMARK.json against the contract's form, and the harness's lookup of
every configuration, traffic and per-layer metric by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from slam_bench import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return spec.load()


def test_benchmark_json_loads_with_the_contract_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["slam_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_names_and_units_use_only_the_allowed_characters(bench):
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    names += [w[k] for w in bench["workloads"] for k in ("config", "traffic")]
    names += [r for c in bench["configs"] for r in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert "\n" not in m["layer"] and "\t" not in m["layer"] and len(m["layer"]) <= 200
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def check_cell(bench: dict, name: str, bench_dir=spec.BENCH_DIR) -> None:
    """One cell finds its files, loop and readers: its limits name exactly
    its loop's numbers (an online cell's also its experiment, its traffic's
    frame rate and the three numbers every online check compares), and it
    reports setup_s, another end-to-end metric and a per-layer metric."""
    e2e = {m["name"] for m in bench["end_to_end"]}
    cell = spec.Cell(bench, name, bench_dir)
    assert set(cell.limits["limits"]) == set(cell.loop.NUMBERS)
    if cell.loop is spec.load_loop("online", bench_dir):
        assert cell.config["experiment"] and cell.traffic["fps"]
        assert set(cell.loop.NUMBERS) == set(check.NUMBERS)
        assert {"track_loss_gap", "map_loss_gap", "map_step_gap"} <= set(cell.limits["limits"])
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and reported <= e2e
    assert cell.per_layer, name
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)


def test_every_cell_finds_its_files_and_readers(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        check_cell(bench, w["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_a_new_metric_is_picked_up_from_its_file_alone(tmp_path, bench):
    root = tmp_path / "copy"
    shutil.copytree(spec.BENCH_DIR, root / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "slam_bench").rglob("*") if p.is_file()}
    (root / "slam_bench" / "metrics" / "extra_ms.py").write_text(
        "def read(trace):\n    return 42.0\n")
    bench = dict(bench, per_layer=bench["per_layer"] + [
        {"name": "extra_ms", "unit": "ms/frame", "better": "lower", "source": "program_span",
         "layer": "phases: tracking (slam/steps.py)", "moves": "memory_peak_gb",
         "workloads": ["replica_bench.fr1_desk"]}])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell(spec.load(root), "replica_bench.fr1_desk", root / "slam_bench")
    assert "extra_ms" in [m["name"] for m in cell.per_layer]
    assert cell.reader("extra_ms").read(None) == 42.0
    assert all(p.read_bytes() == b for p, b in before.items())
