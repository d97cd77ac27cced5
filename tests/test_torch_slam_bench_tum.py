"""The tum cell's route in tier-1: `tinytum.fr1_desk`, slam_bench's
configuration `tum` (upstream TUM RGB-D as written: no tpu section, so a
structure build every iteration, and Kinect-like depth noise) cut to 64x48
and a few iterations, run once, traced, through slam_bench.run.main on the
port's plain versions, in a subprocess of its own (run.main refuses a
process that has loaded the JAX package, as this suite's conftest does).
The run is `correct`; the generic route ran (K1 and K2 recorded by the
trace, K4 and K5 never); and the readers of the projection's span and of
the builds a frame read what the program recorded, a build for every
iteration and one for densification."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from slam_bench import spec
from slam_bench.tests.conftest import make_tiny_root

TRACK_ITERS, MAP_ITERS = 4, 3
# above what the cell's sound runs read on the CPU over three seeds (loss gaps
# up to 1.0e-5, gradient gaps up to 3.4e-5, the step 7.7e-8, densification 0)
TINY_TUM_LIMITS = {"track_loss_gap": 1e-4, "track_grad_gap": 1e-3, "map_loss_gap": 1e-4,
                   "map_grad_gap": 1e-3, "map_step_gap": 1e-3, "densify_px_gap": 1e-2,
                   "densify_new_gap": 1e-4, "keyframe_mismatch": 0}
RUN = textwrap.dedent("""
    import json
    import sys
    from pathlib import Path
    from slam_bench import run, trace

    seen = {}
    trace_frame = trace.trace_frame

    def spy(loop, i, tr):
        out = trace_frame(loop, i, tr)
        seen.update(counted=dict(tr.counted), frames=tr.frames)
        return out

    trace.trace_frame = spy
    rc = run.main(["--workload", "tinytum.fr1_desk", "--seed", "2000000011", "--seconds", "1",
                   "--trace", "1"], device="cpu", root=Path(sys.argv[1]))
    Path(sys.argv[2]).write_text(json.dumps(seen))
    sys.exit(rc)
""")


def make_tiny_tum_root(root):
    """make_tiny_root's copy plus the cell tinytum.fr1_desk: configs/tum.json
    at 64x48 (fr1's intrinsics scaled with it) and TRACK_ITERS / MAP_ITERS
    iterations, limits/tum.json's `follow`, the tiny traffic."""
    root = make_tiny_root(root)
    bench_dir = root / "slam_bench"
    cfg = json.loads((spec.BENCH_DIR / "configs" / "tum.json").read_text())
    s = 64 / cfg["camera"]["width"]
    cam = cfg["camera"]
    cam.update(height=48, width=64, fx=cam["fx"] * s, fy=cam["fy"] * s, cx=cam["cx"] * s,
               cy=cam["cy"] * s)
    exp = cfg["experiment"]
    assert "tpu" not in exp  # the port's defaults: rebin_every 1
    exp["data"].update(desired_image_height=48, desired_image_width=64)
    exp["tracking"]["num_iters"] = TRACK_ITERS
    exp["mapping"]["num_iters"] = MAP_ITERS
    cfg["window"]["frame_s"] = 0.5
    (bench_dir / "configs" / "tinytum.json").write_text(json.dumps(cfg))
    limits = json.loads((spec.BENCH_DIR / "limits" / "tum.json").read_text())
    limits["limits"] = TINY_TUM_LIMITS
    (bench_dir / "limits" / "tinytum.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinytum", "source": "https://example.org/tinytum",
                             "file": "slam_bench/configs/tinytum.json", "reduced": [],
                             "why": "tum at 64x48 for CPU tests"})
    bench["workloads"].append({"name": "tinytum.fr1_desk", "config": "tinytum",
                               "traffic": "tiny_fr1_desk", "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tinytum.fr1_desk")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = make_tiny_tum_root(tmp_path_factory.mktemp("bench"))
    seen = root / "seen.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", RUN, str(root), str(seen)], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), json.loads(seen.read_text())


def test_the_traced_tiny_tum_cell_is_correct(run):
    line, _ = run
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == set(TINY_TUM_LIMITS)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_generic_route_ran(run):
    """Every render of the traced frame went through K1 (and each
    differentiated one through K2), none through the fused kernels."""
    _, seen = run
    assert seen["frames"] == 1
    counted = seen["counted"]
    assert counted.get("composite_forward", 0) == TRACK_ITERS + MAP_ITERS + 1
    assert counted.get("composite_backward", 0) == TRACK_ITERS + MAP_ITERS
    assert counted.get("fused_forward", 0) == 0 and counted.get("fused_backward", 0) == 0


def test_the_projection_and_the_builds_are_read(run):
    line, _ = run
    assert line["metrics"]["host_ms.project"]["value"] > 0
    assert line["metrics"]["builds_per_frame"]["value"] == TRACK_ITERS + MAP_ITERS + 1


def test_without_a_device_trace_no_kernel_metric_is_read(run):
    line, _ = run
    for name in ("kernel_ms.composite_backward", "composite_backward_roofline",
                 "kernel_ms.composite_forward", "composite_forward_roofline"):
        assert name not in line["metrics"]


def _records(monkeypatch, names):
    from slam_bench import host_spans
    from splatam_tpu_torch.utils import spans

    trace = type("Trace", (), {"frames": 1})()
    records = spans.Records([spans.SpanRecord(n, 3, -1, 10 * k, 10 * k + 5)
                             for k, n in enumerate(names)], {})
    monkeypatch.setattr(host_spans, "_TAKEN", [trace, records])
    return trace


@pytest.mark.parametrize("names, project, builds", [
    (["build", "build", "render"], None, 2.0),
    (["render", "project", "build", "project"], 10e-6, 1.0),
])
def test_the_new_readers_on_a_program_with_and_without_the_span(monkeypatch, names, project,
                                                                builds):
    """A program without the `project` span (the benchmark's parent) reads
    no host_ms.project; builds_per_frame counts the `build` spans."""
    trace = _records(monkeypatch, names)
    got = spec.load_reader("host_ms.project").read(trace)
    assert got == pytest.approx(project) if project is not None else got is None
    assert spec.load_reader("builds_per_frame").read(trace) == builds
