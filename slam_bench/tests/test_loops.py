"""The loop a configuration names (slam_bench/loops/<loop>.py, spec.Cell.loop):
a new loop with numbers of its own runs, untraced and traced, from files
alone, passes test_bench_spec's checks of a cell and feeds control.py;
every accepted cell runs the online loop; a loop or a
limit that is missing fails when the cell is read. Runs go through
slam_bench.run.main in a subprocess of their own (run.main refuses a
process that has loaded the JAX package)."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from slam_bench import check, control, spec
from slam_bench.tests.conftest import make_tiny_root
from slam_bench.tests.test_bench_spec import check_cell

STANDIN = textwrap.dedent('''
    """A stand-in loop: two stages a unit, a check with fixed readings."""
    import contextlib
    import time

    from slam_bench import spec

    NUMBERS = ("standin_gap", "standin_count")
    FAULTS = ("standin_fault",)


    def make_inputs(cell, seed, n_units, device):
        return {"seed": seed, "n_units": n_units}


    class Loop:
        def __init__(self, config, inputs, device, workdir):
            self.device, self.n_units, self.ran = device, inputs["n_units"], []

        def frame(self, i, mark=None):
            if not 0 <= i < self.n_units:
                raise IndexError(f"unit {i} is past the run's {self.n_units}")
            t0 = time.perf_counter()
            for stage in ("first", "second"):
                time.sleep(0.002)
                if mark is not None:
                    mark(stage)
            self.ran.append(i)
            return time.perf_counter() - t0


    def check(loop, i, follow):
        loop.frame(i)
        gap = 2.0 if _PLANTED else 0.25
        return spec.Judged({"standin_gap": gap, "standin_count": 0.0},
                           f"stand-in check of unit {i} after {len(loop.ran) - 1} units",
                           {"units_run": len(loop.ran)}, i)


    _PLANTED = []


    @contextlib.contextmanager
    def planted(fault):
        _PLANTED.append(fault)
        try:
            yield
        finally:
            _PLANTED.pop()


    def control_readings(loop, judged, follow):
        return {"standin_gap": 1.0, "standin_count": float(judged.state)}
''')
READER = textwrap.dedent('''
    """The stand-in loop's second stage, ms a unit."""


    def read(trace):
        return trace.mean_stage_ms("second")
''')
RUN = textwrap.dedent("""
    import sys
    from pathlib import Path
    from slam_bench import run
    sys.exit(run.main(["--workload", "standin.tiny_fr1_desk", "--seed", "3000000019",
                       "--seconds", "1", "--trace", sys.argv[2]], device="cpu",
                      root=Path(sys.argv[1])))
""")


def _add_standin(root) -> None:
    """The stand-in loop and its cell standin.tiny_fr1_desk, a configuration
    naming the loop, its limits and a reader, as files and entries alone."""
    bench_dir = root / "slam_bench"
    (bench_dir / "loops" / "standin.py").write_text(STANDIN)
    (bench_dir / "metrics" / "standin_second_ms.py").write_text(READER)
    (bench_dir / "configs" / "standin.json").write_text(
        json.dumps({"loop": "standin", "window": {"frame_s": 0.5}}))
    (bench_dir / "limits" / "standin.json").write_text(
        json.dumps({"follow": {}, "limits": {"standin_gap": 0.5, "standin_count": 0}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "standin", "source": "https://example.org/standin",
                             "file": "slam_bench/configs/standin.json", "reduced": [],
                             "why": "a loop added as files"})
    bench["workloads"].append({"name": "standin.tiny_fr1_desk", "config": "standin",
                               "traffic": "tiny_fr1_desk", "chips": 1, "why": "CPU tests"})
    bench["per_layer"].append({"name": "standin_second_ms", "unit": "ms/frame",
                               "better": "lower", "source": "program_span",
                               "layer": "stand-in loop", "moves": "memory_peak_gb",
                               "workloads": ["standin.tiny_fr1_desk"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _bench_files() -> dict:
    return {p: p.read_bytes() for p in spec.BENCH_DIR.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_loop_runs_from_its_files_alone(tmp_path):
    before = _bench_files()
    root = make_tiny_root(tmp_path / "bench")
    _add_standin(root)
    lines = {}
    # the check unit follows 3 set-up units, the window's 2 and, traced, 1
    for trace, i in (("0", 5), ("1", 6)):
        out = subprocess.run([sys.executable, "-c", RUN, str(root), trace], cwd=spec.ROOT,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        lines[trace] = json.loads(out.stdout.strip().splitlines()[-1])
        assert f"; stand-in check of unit {i} after {i} units" in out.stderr
        assert out.stderr.strip().splitlines()[-2:] == [
            "check standin_gap 0.25 limit 0.5", "check standin_count 0.0 limit 0"]
    for line in lines.values():
        assert line["correct"] is True and line["failed"] == 0
        assert list(line)[-1] == "checks"
        assert line["checks"] == {"standin_gap": {"value": 0.25, "limit": 0.5},
                                  "standin_count": {"value": 0.0, "limit": 0}}
    # the window: round(1 s / 0.5 s) units; the CPU has no device memory to read
    assert lines["0"]["attempted"] == 2 and set(lines["0"]["metrics"]) == {"setup_s"}
    assert set(lines["1"]["metrics"]) == {"standin_second_ms"}
    assert lines["1"]["metrics"]["standin_second_ms"]["value"] >= 2.0
    assert lines["1"]["attempted"] == 3  # the window and the one traced unit
    assert _bench_files() == before


def test_a_new_loop_passes_every_cell_check_and_feeds_control(tmp_path, capsys):
    root = make_tiny_root(tmp_path / "bench")
    _add_standin(root)
    bench = spec.load(root)
    for w in bench["workloads"]:
        check_cell(bench, w["name"], root / "slam_bench")
    assert control.main(["--workload", "standin.tiny_fr1_desk", "--seeds", "3000000023",
                         "--control", "--faults"], device="cpu", root=root) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    by_kind = {line["kind"]: line for line in lines}
    assert list(by_kind) == ["sound", "control", "standin_fault"]
    # the check unit follows the 3 set-up units; the control reads the unit check judged
    assert by_kind["sound"]["line"] == "stand-in check of unit 3 after 3 units"
    assert by_kind["sound"]["units_run"] == 4
    assert by_kind["sound"]["readings"] == {"standin_gap": 0.25, "standin_count": 0.0}
    assert by_kind["control"]["readings"] == {"standin_gap": 1.0, "standin_count": 3.0}
    assert by_kind["standin_fault"]["readings"]["standin_gap"] == 2.0


@pytest.mark.parametrize("workload", ["replica_bench.fr1_desk", "tum.fr1_desk",
                                      "replica.fr1_desk"])
def test_every_accepted_cell_runs_the_online_loop(workload):
    cell = spec.Cell(spec.load(), workload)
    online = spec.load_loop("online")
    assert "loop" not in cell.config and cell.loop is online
    assert set(cell.limits["limits"]) == set(online.NUMBERS) == set(check.NUMBERS)
    assert spec.Cell(spec.load(), workload).loop is online  # loaded once


def test_a_missing_loop_or_limit_fails_when_the_cell_is_read(tmp_path):
    root = make_tiny_root(tmp_path / "bench")
    bench_dir = root / "slam_bench"
    cfg = json.loads((bench_dir / "configs" / "tiny.json").read_text())
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(dict(cfg, loop="nowhere")))
    with pytest.raises(FileNotFoundError, match="nowhere.py"):
        spec.Cell(spec.load(root), "tiny.fr1_desk", bench_dir)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(cfg))
    assert spec.Cell(spec.load(root), "tiny.fr1_desk", bench_dir).loop.NUMBERS == check.NUMBERS
    limits = json.loads((bench_dir / "limits" / "tiny.json").read_text())
    del limits["limits"]["map_step_gap"]
    (bench_dir / "limits" / "tiny.json").write_text(json.dumps(limits))
    with pytest.raises(ValueError, match="map_step_gap"):
        spec.Cell(spec.load(root), "tiny.fr1_desk", bench_dir)
