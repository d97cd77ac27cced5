"""Run one cell of the benchmark once and print its result line.

    python3 -m slam_bench.run --workload replica_bench.fr1_desk --seed 7 \\
        --seconds 30 --trace 0

The cell's loop (slam_bench/loops/<loop>.py, which its configuration
names; the online SLAM loop where it names none) runs it in units: a
sensor frame of the online loop. Set-up: the port's kernels (built into
build/splatam_tpu_torch/ inside the checkout at first use, found there
after), the loop's inputs made from --seed (the online loop's frames, on
the card, slam_bench/traffic.py), the loop built on them (SLAMRuntime),
and the traffic's set-up units run through the same call the window uses.
Then the window: units one after another, each closed by a synchronize
(the online loop's prepare_frame + run_frame). The window holds a fixed
number of units, round(--seconds / the configuration's window.frame_s):
the same work for a faster or a slower program, lasting about --seconds
for the program the cell was defined on (the trajectory's later frames
cost more than its earlier ones, as the map and the keyframes grow).
--trace 0 reports the end-to-end metrics: setup_s and the device memory's
peak over set-up and the window. --trace 1 also profiles the traffic's
trace_frames units after the window and reports the per-layer metrics
(slam_bench/metrics/<name>.py), the window's seconds a unit among them.
Either way one more unit, the check unit, is held against the plain
reference by the loop's check (the online loop's: slam_bench/check.py),
and the last line on standard output is one JSON object: correct,
attempted (units measured), failed, metrics, device, with --trace 1
breakdown, and last `checks`, each number compared with its limit (also
the last lines on standard error).

Exits 2 without a result where there is no CUDA device, or fewer than the
cell asks for; exits 3 when jax, jaxlib, flax or splatam_tpu is loaded once
the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from slam_bench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "splatam_tpu")
TRACE_RETRIES = 4  # frames a traced run adds where the profiler dropped launches


def process_age() -> float:
    """Seconds since this process started (Linux /proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = spec.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit(device) -> tuple[str, float | None]:
    import torch

    if device.type != "cuda":
        return "cpu", None
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=30).stdout
        return name, float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return name, None


def window_length(config: dict, seconds: float) -> int:
    """Frames in the measured window."""
    return max(1, round(seconds / float(config["window"]["frame_s"])))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str | None = None, root=spec.ROOT) -> int:
    """The run; `device` "cpu" (for tests) runs the kernels' plain versions
    on the CPU in place of the card and skips the look for one; `root`
    (for tests) is the directory holding BENCHMARK.json and slam_bench/."""
    args = parse(argv)
    cache_dirs()
    cell = spec.Cell(spec.load(root), args.workload, root / "slam_bench")
    import numpy as np
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"slam_bench: the cell needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
                  file=sys.stderr)
            return 2
        device = "cuda"
    dev = torch.device(device)

    from slam_bench import trace

    np.random.seed(args.seed % 2**32)  # the runtime's keyframe draws use np.random
    torch.manual_seed(args.seed)
    window_frames = window_length(cell.config, args.seconds)
    setup_frames = int(cell.traffic["setup_frames"])
    trace_frames = int(cell.traffic["trace_frames"])
    traced = trace_frames + TRACE_RETRIES if args.trace else 0
    n_frames = setup_frames + window_frames + traced + 1
    t_frames = time.perf_counter()
    inputs = cell.loop.make_inputs(cell, args.seed, n_frames, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory(prefix="slam_bench_") as workdir:
        loop = cell.loop.Loop(cell.config, inputs, dev, workdir)
        t_warm = time.perf_counter()
        warm = [loop.frame(i) for i in range(setup_frames)]
        i = setup_frames
        setup_s = process_age()
        print(f"slam_bench: set-up {setup_s:.3f} s: frames made in {t_warm - t_frames:.3f} s, "
              f"set-up frames " + " ".join(f"{t:.3f}" for t in warm), file=sys.stderr)
        times = []
        start = time.perf_counter()
        for _ in range(window_frames):
            times.append(loop.frame(i))
            i += 1
        window = time.perf_counter() - start
        window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        print(f"slam_bench: {len(times)} frames in {window:.4f} s "
              f"({window / len(times):.6f} s a frame); per frame: "
              + " ".join(f"{t:.4f}" for t in times), file=sys.stderr)
        attempted = len(times)
        metrics = {}
        tr = None
        if args.trace:
            tr = trace.Trace(device=dev.type, loop_s=window, loop_frames=times)
            for _ in range(trace_frames + TRACE_RETRIES):
                seen, launched = trace.trace_frame(loop, i, tr)
                if seen != launched:
                    print(f"slam_bench: frame {i} not traced: the profiler saw {seen} of "
                          f"{launched} launches of the port's kernels", file=sys.stderr)
                i += 1
                if tr.frames == trace_frames:
                    break
            attempted += tr.frames
        else:
            values = {"setup_s": setup_s}
            if window_peak:  # the card's memory; a CPU run has none to read
                values["memory_peak_gb"] = window_peak / 1e9
            for m in cell.end_to_end:
                if m["name"] in values:
                    metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        t_check = time.perf_counter()
        judged = cell.loop.check(loop, i, cell.limits["follow"])
        readings = judged.readings
        print(f"slam_bench: check frame {i} and reference {time.perf_counter() - t_check:.3f} s; "
              f"{judged.line}", file=sys.stderr)
        del judged, loop
    found = forbidden_modules()
    if found:
        print(f"slam_bench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3

    name, limit_w = power_limit(dev)
    result = {"correct": False, "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                         "count": 1, "memory_peak_bytes": int(peak),
                         "power_limit_w": limit_w}}
    if tr is not None:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    checks = {n: {"value": readings[n], "limit": limit}
              for n, limit in cell.limits["limits"].items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result["correct"] = correct
    result["checks"] = checks
    for number, c in checks.items():
        print(f"check {number} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
