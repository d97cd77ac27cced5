"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Each is a file of its own under slam_bench/: configs/<config>.json (the
configuration as it runs: the experiment config, its camera, sensor and
scene, and under "loop" the loop that runs it, "online" where it names
none), limits/<config>.json (what the correctness check follows and the
limit of each number it compares), traffic/<traffic>.json (the parameters
the loop's generator reads, with the units a run spends in set-up,
`setup_frames`, and a --trace 1 run profiles, `trace_frames`),
loops/<loop>.py (the loop, below) and, for each per-layer metric,
metrics/<metric>.py (a reader with `read(trace) -> float | None`).
A later cell, loop or metric is added as files and entries; no file here
changes.

A loop file provides, at module level:
  NUMBERS           the names of the numbers its check compares; the
                    limits file of a configuration that runs the loop
                    gives a limit for each of them and for no other
  make_inputs(cell, seed, n_units, device)
                    everything made from the seed that units 0 to
                    n_units - 1 read, made before the device's memory
                    peak is reset
  Loop(config, inputs, device, workdir)
                    an object with `.device` and `.frame(i, mark=None)`,
                    which runs unit i (a sensor frame, a trainer's chunk),
                    calls mark(stage) as each of its stages closes (the
                    traced run times the stages from those calls), closes
                    the unit with a synchronize and returns its wall seconds
  check(loop, i, follow)
                    runs unit i through loop.frame, observed, and holds it
                    against the plain reference, as far as the limits
                    file's `follow` says; returns a Judged (below)
  FAULTS, planted(fault)
                    the faults the check has to catch, and a context
                    manager that plants one in the program
  control_readings(loop, judged, follow)
                    the control's readings (the reference in the next
                    precision down, in the program's place) on the unit
                    that `judged`, check's return on that loop, judged
slam_bench/README.md maps the offline 3DGS trainer onto it.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
_LOOPS: dict = {}  # a loop file's resolved path -> its module


class Judged(NamedTuple):
    """What a loop's check returns about the unit it judged."""

    readings: dict  # keyed by the loop's NUMBERS
    line: str  # one line about them, for standard error
    extras: dict  # JSON values control.py's lines carry beside the readings
    state: object = None  # what the loop's control_readings needs of the unit


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
        self.loop = load_loop(self.config.get("loop", "online"), bench_dir)
        if set(self.limits["limits"]) != set(self.loop.NUMBERS):
            raise ValueError(f"limits/{self.entry['config']}.json limits "
                             f"{sorted(self.limits['limits'])}, not the numbers of its loop "
                             f"{self.loop.__file__}: {sorted(self.loop.NUMBERS)}")
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


def load_loop(name: str, bench_dir: Path = BENCH_DIR):
    """The loop file loops/<name>.py, loaded once per path and process, so
    that a wrapper put on the module (slam_bench/peak_owner.py's) is what
    every later Cell of that path hands out."""
    path = (bench_dir / "loops" / f"{name}.py").resolve()
    if path not in _LOOPS:
        if not path.is_file():
            raise FileNotFoundError(f"no loop file {path} for the loop {name}")
        spec = importlib.util.spec_from_file_location(f"slam_bench_loop_{len(_LOOPS)}_{name}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        # in sys.modules, as for an import: dataclasses and pickle look a class's module up there
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
        _LOOPS[path] = module
    return _LOOPS[path]
