"""Benchmark: per-frame track+map wall-clock on a Replica-scale workload.

Counterpart of bench.py (:28-190). Runs the online SLAM loop (40 tracking
iterations, densification, 60 mapping iterations a frame) on the
procedural synthetic sequence at 1200x680 (configs/synthetic/splatam.py
with bench.py's changes), and times each frame from compact to the end of
mapping, closed by a synchronize: the dataset read (the synthetic
sequence's host ray cast), the upload and the pose init stay outside the
window (slam/pipeline.py prepare_frame), as does the keyframe append.

    python -m splatam_tpu_torch.scripts.bench
    BENCH_PLATFORM=cpu BENCH_H=48 BENCH_W=64 BENCH_FRAMES=3 BENCH_WARMUP=1 \\
        python -m splatam_tpu_torch.scripts.bench

The environment variables are bench.py's, with its defaults: BENCH_H (680),
BENCH_W (1200), BENCH_FRAMES (12), BENCH_WARMUP (3), BENCH_CAP
(tpu.capacity: 2^19, doubled until it holds 2 H W), BENCH_REBIN (8),
BENCH_SHARDS (0), BENCH_DIRECT_J (0), BENCH_TILE_CULL (1 = on) and
BENCH_STAGES (1 = per-stage times, with a synchronize at each stage's end).
BENCH_PLATFORM=cpu runs the kernels' plain versions on the CPU; otherwise
the run is on the card, and with no card the script exits 2. BENCH_PAIR_CAP
and BENCH_TILE_K have no counterpart (the port's pair buffers and tile
lists are exact), nor has a BENCH_BACKEND other than auto or pallas (the
loop always runs the kernels): setting one exits 2 with the reason.

Prints a line per frame on stderr (seconds, Gaussians, the pairs of the
frame's structure builds and, under the cull, the pairs culled), then the
kernels' launch counts and the peak device memory; last, ONE JSON line on
stdout: bench.py's keys (metric, value, unit, vs_baseline against the
reference's 2.5 s/frame, aggregation, warmup_frames, rebin_every,
frame0_s, max_frame_s, n_gaussians_final) and `device`, the card's name
and power limit as nvidia-smi gives them (or "cpu").
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from splatam_tpu_torch import kernels
from splatam_tpu_torch.render import binning
from splatam_tpu_torch.scripts import harness

REFERENCE_FRAME_SECONDS = 2.5  # the reference's per-frame track+map (BASELINE.md)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAGES = ("compact", "track", "densify", "select_kf", "stage_kf", "map")
NO_COUNTERPART = {
    "BENCH_PAIR_CAP": "the port sizes its pair buffers exactly; there is no pair cap",
    "BENCH_TILE_K": "the port's tile lists are the sorted stream itself; there is no "
                    "tile_k_max",
}


def refuse(reason: str) -> None:
    print(f"bench: {reason}", file=sys.stderr)
    sys.exit(2)


def read_env() -> dict:
    """bench.py's settings from the environment; exits 2 on a variable
    without a counterpart."""
    for var, why in NO_COUNTERPART.items():
        if var in os.environ:
            refuse(f"{var} has no counterpart: {why}")
    backend = os.environ.get("BENCH_BACKEND", "auto")
    if backend not in ("auto", "pallas"):
        refuse(f"BENCH_BACKEND={backend} has no counterpart: the port's loop always runs "
               "its kernels (auto or pallas)")
    height = int(os.environ.get("BENCH_H", 680))
    width = int(os.environ.get("BENCH_W", 1200))
    cap = 1 << 19
    while cap < 2 * height * width:
        cap <<= 1
    return dict(
        height=height, width=width,
        frames=int(os.environ.get("BENCH_FRAMES", 12)),
        warmup=int(os.environ.get("BENCH_WARMUP", 3)),
        tpu=dict(capacity=int(os.environ.get("BENCH_CAP", cap)),
                 backend=backend,
                 rebin_every=int(os.environ.get("BENCH_REBIN", 8)),
                 spatial_shards=int(os.environ.get("BENCH_SHARDS", 0)),
                 direct_j=int(os.environ.get("BENCH_DIRECT_J", 0)),
                 tile_cull=os.environ.get("BENCH_TILE_CULL", "0") == "1"),
        stages=os.environ.get("BENCH_STAGES") == "1",
    )


def bench_config(env: dict, workdir: str) -> dict:
    """configs/synthetic/splatam.py with bench.py:53-78's changes."""
    from splatam_tpu_torch.slam.config import load_experiment_config

    config = load_experiment_config(os.path.join(ROOT, "configs", "synthetic", "splatam.py"))
    config["workdir"] = workdir
    config["data"]["desired_image_height"] = env["height"]
    config["data"]["desired_image_width"] = env["width"]
    config["data"]["num_frames"] = env["frames"]
    config["tracking"]["num_iters"] = 40
    config["mapping"]["num_iters"] = 60
    config["mapping_window_size"] = 24
    config["keyframe_every"] = 5
    config["tpu"] = dict(env["tpu"])
    return config


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them; "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(env: dict, device: torch.device, workdir: str) -> dict:
    """The frame loop (bench.py:88-148); returns the result dict."""
    from splatam_tpu_torch.slam.config import seed_everything
    from splatam_tpu_torch.slam.pipeline import SLAMRuntime, prepare_frame, run_frame

    config = bench_config(env, workdir)
    seed_everything(0)
    print(f"device: {harness.describe(device)}", file=sys.stderr)
    rt = SLAMRuntime(config, device)
    kernels.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    frame_times, all_frame_times = [], []
    for time_idx in range(rt.num_frames):
        frame = prepare_frame(rt, time_idx)
        binning.reset_pair_totals()
        marks = []

        def mark(stage: str) -> None:
            if env["stages"] or stage == "map":
                _sync(device)
                marks.append(time.time())

        t0 = time.time()
        run_frame(rt, time_idx, frame, mark)
        dt = marks[-1] - t0
        if env["stages"] and time_idx > 0:
            deltas = np.diff([t0, *marks])
            print("  " + "  ".join(f"{n}={d:.3f}s" for n, d in zip(STAGES, deltas)),
                  file=sys.stderr)
        totals = binning.build_bins.totals
        culled = ""
        if rt.bin_opts.tile_cull:
            share = totals["culled"] / max(totals["pairs"] + totals["culled"], 1)
            culled = f" culled={totals['culled']} ({100.0 * share:.2f}%)"
        print(f"frame {time_idx}: {dt:.3f}s  (n_gauss={rt.gm.num_active()}) "
              f"pairs={totals['pairs']} in {totals['builds']} builds{culled}", file=sys.stderr)
        all_frame_times.append(dt)
        if time_idx >= env["warmup"]:
            frame_times.append(dt)
    print(f"launches: {json.dumps(kernels.launch_counts())}", file=sys.stderr)
    if device.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB",
              file=sys.stderr)

    per_frame = float(np.median(frame_times))
    rebin = int(config["tpu"]["rebin_every"])
    frames, warmup = env["frames"], env["warmup"]
    return {
        "metric": (f"per-frame track+map seconds (synthetic {env['width']}x{env['height']}, "
                   f"40 track + 60 map iters, rebin_every={rebin}, "
                   f"median of frames {warmup}..{frames - 1})"),
        "value": round(per_frame, 4),
        "unit": "s/frame",
        "vs_baseline": round(REFERENCE_FRAME_SECONDS / per_frame, 3),
        "aggregation": "median",
        "warmup_frames": warmup,
        "rebin_every": rebin,
        "frame0_s": round(all_frame_times[0], 3) if all_frame_times else None,
        "max_frame_s": round(max(all_frame_times[1:]), 3) if len(all_frame_times) > 1 else None,
        "n_gaussians_final": int(rt.gm.num_active()),
        "device": card_line(device),
    }


def main() -> dict:
    env = read_env()
    plat = os.environ.get("BENCH_PLATFORM", "")
    if plat not in ("", "cpu", "cuda", "gpu"):
        refuse(f"BENCH_PLATFORM={plat}: the port runs on cpu or on the card (cuda)")
    if plat != "cpu" and not torch.cuda.is_available():
        refuse("no CUDA device; BENCH_PLATFORM=cpu runs the kernels' plain versions on the CPU")
    device = torch.device("cpu" if plat == "cpu" else "cuda")
    workdir = tempfile.mkdtemp(prefix="splatam_bench_")
    try:
        result = run(env, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
