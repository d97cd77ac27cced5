"""Shared fixtures of the benchmark's own tests: a benchmark root with one
extra cell, `tiny.fr1_desk`, which is replica_bench cut to 64x48 and a few
iterations, for runs on the CPU with the port's plain versions."""
from __future__ import annotations

import json
import shutil

import pytest

from slam_bench import spec

# limits for the tiny cell, above what its sound runs read on the CPU
# (loss gaps up to 2e-5, gradient gaps up to 2e-5, step gaps 1e-7)
TINY_LIMITS = {"track_loss_gap": 1e-4, "track_grad_gap": 1e-3, "map_loss_gap": 2e-4,
               "map_grad_gap": 1e-3, "map_step_gap": 1e-3, "densify_px_gap": 1e-2,
               "densify_new_gap": 1e-4, "keyframe_mismatch": 0}


def make_tiny_root(root):
    """A copy of BENCHMARK.json and slam_bench's data files under `root`,
    plus the tiny cell; returns root."""
    bench_dir = root / "slam_bench"
    bench_dir.mkdir(parents=True)
    for d in ("metrics", "configs", "limits", "traffic", "loops"):
        shutil.copytree(spec.BENCH_DIR / d, bench_dir / d)
    bench = spec.load()
    cfg = json.loads((spec.BENCH_DIR / "configs" / "replica_bench.json").read_text())
    cfg["camera"].update(height=48, width=64, fx=32.0, fy=32.0, cx=31.5, cy=23.5)
    exp = cfg["experiment"]
    exp["data"].update(desired_image_height=48, desired_image_width=64)
    exp["tracking"]["num_iters"] = 4
    exp["mapping"]["num_iters"] = 4
    exp["tpu"]["capacity"] = 1 << 13
    cfg["window"]["frame_s"] = 0.5
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(cfg))
    limits = json.loads((spec.BENCH_DIR / "limits" / "replica_bench.json").read_text())
    limits["limits"] = TINY_LIMITS
    (bench_dir / "limits" / "tiny.json").write_text(json.dumps(limits))
    traffic = json.loads((spec.BENCH_DIR / "traffic" / "fr1_desk.json").read_text())
    # three set-up frames and two measured ones: the check frame, frame 5, densifies new surface
    traffic.update(setup_frames=3, trace_frames=1)
    (bench_dir / "traffic" / "tiny_fr1_desk.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": "tiny", "source": "https://example.org/tiny",
                             "file": "slam_bench/configs/tiny.json", "reduced": [],
                             "why": "replica_bench at 64x48 for CPU tests"})
    bench["workloads"].append({"name": "tiny.fr1_desk", "config": "tiny",
                               "traffic": "tiny_fr1_desk", "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.fr1_desk")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
