"""The replica cell in tier-1: `tinyreplica.fr1_desk`, slam_bench's
configuration `replica` (upstream SplaTAM's Replica setting as written: no
tpu section, so a structure build every iteration, noise-free depth) cut to
64x36 and a few iterations, run once, traced, through slam_bench.run.main
on the port's plain versions, in a subprocess of its own (run.main refuses
a process that has loaded the JAX package, as this suite's conftest does).
The run is `correct`; the generic route ran (K1 and K2 recorded by the
trace, K4 and K5 never); a build for every iteration and one for
densification; pairs_per_build is the frame's pairs over those builds. And
the configuration's experiment is configs/replica/splatam.py as loaded, but
for the keys its entry's `reduced` and its `assumed` name."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from slam_bench import spec
from slam_bench.tests.conftest import make_tiny_root

TRACK_ITERS, MAP_ITERS = 4, 3
# the tiny tum cell's, above what this cell's sound runs read on the CPU over
# three seeds (loss gaps up to 4.8e-7, gradient gaps up to 1.2e-5, the step
# 8.1e-8, densification 0)
TINY_REPLICA_LIMITS = {"track_loss_gap": 1e-4, "track_grad_gap": 1e-3, "map_loss_gap": 1e-4,
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
        seen.update(counted=dict(tr.counted), frames=tr.frames, pairs=list(tr.pairs))
        return out

    trace.trace_frame = spy
    rc = run.main(["--workload", "tinyreplica.fr1_desk", "--seed", "2100000013", "--seconds",
                   "1", "--trace", "1"], device="cpu", root=Path(sys.argv[1]))
    Path(sys.argv[2]).write_text(json.dumps(seen))
    sys.exit(rc)
""")


def make_tiny_replica_root(root):
    """make_tiny_root's copy plus the cell tinyreplica.fr1_desk:
    configs/replica.json at 64x36 (Replica's intrinsics scaled with it) and
    TRACK_ITERS / MAP_ITERS iterations, limits/replica.json's `follow`, the
    tiny traffic; every per-layer metric's list of cells names it."""
    root = make_tiny_root(root)
    bench_dir = root / "slam_bench"
    cfg = json.loads((spec.BENCH_DIR / "configs" / "replica.json").read_text())
    cam = cfg["camera"]
    s = 64 / cam["width"]
    cam.update(height=36, width=64, fx=cam["fx"] * s, fy=cam["fy"] * s, cx=cam["cx"] * s,
               cy=cam["cy"] * s)
    exp = cfg["experiment"]
    assert "tpu" not in exp  # the port's defaults: rebin_every 1
    exp["data"].update(desired_image_height=36, desired_image_width=64)
    exp["tracking"]["num_iters"] = TRACK_ITERS
    exp["mapping"]["num_iters"] = MAP_ITERS
    cfg["window"]["frame_s"] = 0.5
    (bench_dir / "configs" / "tinyreplica.json").write_text(json.dumps(cfg))
    limits = json.loads((spec.BENCH_DIR / "limits" / "replica.json").read_text())
    limits["limits"] = TINY_REPLICA_LIMITS
    (bench_dir / "limits" / "tinyreplica.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyreplica", "source": "https://example.org/tinyreplica",
                             "file": "slam_bench/configs/tinyreplica.json", "reduced": [],
                             "why": "replica at 64x36 for CPU tests"})
    bench["workloads"].append({"name": "tinyreplica.fr1_desk", "config": "tinyreplica",
                               "traffic": "tiny_fr1_desk", "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tinyreplica.fr1_desk")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = make_tiny_replica_root(tmp_path_factory.mktemp("bench"))
    seen = root / "seen.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", RUN, str(root), str(seen)], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), json.loads(seen.read_text())


def test_the_traced_tiny_replica_cell_is_correct(run):
    line, _ = run
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == set(TINY_REPLICA_LIMITS)
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


def test_a_build_every_iteration_and_the_pairs_a_build(run):
    line, seen = run
    builds = TRACK_ITERS + MAP_ITERS + 1
    assert line["metrics"]["builds_per_frame"]["value"] == builds
    assert seen["pairs"] and seen["pairs"][0] > 0
    got = line["metrics"]["pairs_per_build"]["value"]
    assert got == pytest.approx(sum(seen["pairs"]) / (builds * seen["frames"]) / 1e6, rel=1e-12)


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_the_experiment_is_the_source_as_written(monkeypatch):
    """configs/replica/splatam.py as the port loads it, key for key, but for
    the keys BENCHMARK.json's `reduced` and the file's `assumed` name; no
    tpu section; the camera is configs/data/replica.yaml's."""
    from splatam_tpu_torch.data import yaml_subset
    from splatam_tpu_torch.slam.config import load_experiment_config

    for var in ("SCENE_NUM", "SEED"):
        monkeypatch.delenv(var, raising=False)
    entry = next(c for c in spec.load()["configs"] if c["name"] == "replica")
    assert entry["reduced"] == ["data.num_frames"]
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    named = set(entry["reduced"]) | set(cfg["assumed"])
    source = _flat(load_experiment_config(str(spec.ROOT / "configs" / "replica" / "splatam.py")))
    ours = _flat(cfg["experiment"])
    assert not [k for k in ours if k.startswith("tpu.")]
    differ = {k for k in set(source) | set(ours) if source.get(k, KeyError) != ours.get(k, KeyError)}
    assert differ <= named, sorted(differ - named)
    assert differ == {"workdir"}  # the harness's temporary directory; the rest is as loaded
    yaml = yaml_subset.load(str(spec.ROOT / "configs" / "data" / "replica.yaml"))
    cam = yaml["camera_params"]
    assert cfg["camera"] == {"height": cam["image_height"], "width": cam["image_width"],
                             **{k: cam[k] for k in ("fx", "fy", "cx", "cy", "png_depth_scale",
                                                    "crop_edge")}}


def _records(monkeypatch, names, frames=1):
    from slam_bench import host_spans
    from splatam_tpu_torch.utils import spans

    trace = type("Trace", (), {"frames": frames, "pairs": []})()
    records = spans.Records([spans.SpanRecord(n, k % frames, -1, 10 * k, 10 * k + 5)
                             for k, n in enumerate(names)], {})
    monkeypatch.setattr(host_spans, "_TAKEN", [trace, records])
    return trace


@pytest.mark.parametrize("names, pairs, frames, expected", [
    (["build", "render", "build", "build", "render", "build"], [3e6, 5e6], 2, 2.0),
    (["build", "build", "render"], [4.5e6], 1, 2.25),
    ([], [4e6], 1, None),  # a program without spans
    (["render", "project", "render"], [4e6], 1, None),  # no build ran
    (["build", "build"], [], 1, None),  # no pairs counted
])
def test_pairs_per_build_on_a_made_up_trace(monkeypatch, names, pairs, frames, expected):
    trace = _records(monkeypatch, names, frames)
    trace.pairs = pairs
    got = spec.load_reader("pairs_per_build").read(trace)
    assert got == pytest.approx(expected) if expected is not None else got is None
