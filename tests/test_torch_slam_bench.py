"""The benchmark's hooks into the port, in tier-1: slam_bench's tiny CPU
cell (slam_bench/tests/conftest.py, `tiny.fr1_desk`: replica_bench at
64x48) run once, traced, through slam_bench.run.main on the port's plain
versions, in a subprocess of its own (run.main refuses a process that has
loaded the JAX package, as this suite's conftest does). The run is `correct`, reports
the per-layer metrics read from run_frame's marks and build_bins.totals,
and the ones read from the port's span recorder; the CPU has no device
trace, so nothing that needs one is reported."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from slam_bench import spec
from slam_bench.tests.conftest import make_tiny_root

HOST_MS = ("build", "render", "loss", "backward", "adam")
RUN = textwrap.dedent("""
    import sys
    from pathlib import Path
    from slam_bench import run
    sys.exit(run.main(["--workload", "tiny.fr1_desk", "--seed", "3000000007",
                       "--seconds", "1", "--trace", "1"], device="cpu", root=Path(sys.argv[1])))
""")


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("bench"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", RUN, str(root)], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_traced_tiny_cell_is_correct(line):
    assert line["correct"] is True and line["failed"] == 0
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_marks_and_the_pair_counter_are_read(line):
    assert {"frame_s.loop", "frame_s_p90.loop", "track_ms", "map_ms", "densify_ms",
            "pairs_per_frame"} <= set(line["metrics"])
    assert line["metrics"]["pairs_per_frame"]["value"] > 0


def test_the_host_syncs_are_counted(line):
    assert line["metrics"]["host_syncs_per_frame"]["value"] > 0
    assert line["metrics"]["host_wait_ms"]["value"] >= 0


@pytest.mark.parametrize("name", HOST_MS)
def test_each_layer_has_host_time(line, name):
    assert line["metrics"][f"host_ms.{name}"]["value"] > 0


def test_without_a_device_trace_no_idle_is_attributed(line):
    assert "idle_attributed_pct" not in line["metrics"]
    assert "idle_pct" not in line["metrics"]
    assert "idle_by_span" not in line["breakdown"]
