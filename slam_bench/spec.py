"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Each is a file of its own under slam_bench/: configs/<config>.json (the
experiment config as it runs, with its camera, sensor and scene),
limits/<config>.json (what the correctness check follows and the limit of
each number it compares), traffic/<traffic>.json (the parameters the one
frame generator, slam_bench/traffic.py, reads) and, for each per-layer
metric, metrics/<metric>.py (a reader with `read(trace) -> float | None`).
A later cell or metric is added as files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def _json(kind: str, name: str, bench_dir: Path) -> dict:
    path = bench_dir / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


class Cell:
    """One workload with everything it names, read from its files."""

    def __init__(self, bench: dict, name: str, bench_dir: Path = BENCH_DIR):
        self.entry = _by_name(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg_entry = _by_name(bench["configs"], self.entry["config"], "config")
        self.config = json.loads((bench_dir.parent / cfg_entry["file"]).read_text())
        self.limits = _json("limits", self.entry["config"], bench_dir)
        self.traffic = _json("traffic", self.entry["traffic"], bench_dir)
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name]) and m["moves"] in reported]
        self.bench_dir = bench_dir

    def reader(self, metric: str):
        """The per-layer metric's reader module, metrics/<metric>.py."""
        return load_reader(metric, self.bench_dir)


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{metric}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path} for the per-layer metric {metric}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
