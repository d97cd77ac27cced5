"""What the program's span recorder (splatam_tpu_torch/utils/spans.py)
costs on the card, and where the card's idle time falls among its spans.

    python3 -m slam_bench.span_cost --workload replica_bench.fr1_desk \\
        --seed 7 --seconds 30 --pairs 4 --traced 3

After the cell's set-up frames and window:
  * off: the host's time per call of a disabled `span` and `waited`
    (their `with` included, a bare loop taken away), times the spans and
    waits of one recorded frame, over the window's median frame
    (off_cost_pct);
  * on: the same per call of an enabled one over a frame with the
    recorder on (on_calls_pct); and untraced frames with the recorder on
    and off in turns (on, off, off, on, ...), their wall seconds compared
    (on_cost_pct), with the first recorded frame's host syncs and wait
    milliseconds by `waited` site;
  * `--traced` frames under torch.profiler (device activity only), each
    recording its spans as every profiled frame does: the card's idle
    time in them (idle_pct, as slam_bench/metrics/idle_pct.py reads it
    from a `--trace 1` run) and the share of it inside a program span
    (idle_attributed_pct), with the ten innermost spans that left the card
    idle longest, in seconds a frame (idle_by_span; slam_bench/host_spans.py).
Prints one JSON line; needs the card, as slam_bench.run does.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from collections import defaultdict

from slam_bench import host_spans, run, spec


def per_call_ns(fn, n: int = 20_000) -> float:
    """Host ns per `with fn(...)`, a bare loop taken away."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    bare = time.perf_counter_ns() - t0
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with fn("site"):
            pass
    return (time.perf_counter_ns() - t0 - bare) / n


def device_ns(prof) -> list:
    """The device events' [start, end) in Unix ns, by start: kineto's trace
    start plus each event's time_range (microseconds)."""
    from torch.autograd import DeviceType

    t0 = prof.profiler.kineto_results.trace_start_ns()
    return sorted((t0 + round(e.time_range.start * 1e3), t0 + round(e.time_range.end * 1e3))
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def main(argv=None, device: str | None = None, root=spec.ROOT) -> int:
    """`device` "cpu" and `root` as slam_bench.run.main takes them (for a
    rehearsal on the CPU, where no time is worth reading)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--traced", type=int, default=3)
    args = ap.parse_args(argv)
    run.cache_dirs()
    cell = spec.Cell(spec.load(root), args.workload, root / "slam_bench")
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device is None and not torch.cuda.is_available():
        print("slam_bench.span_cost: needs a CUDA device", file=sys.stderr)
        return 2
    from splatam_tpu_torch.utils import spans

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    np.random.seed(args.seed % 2**32)
    torch.manual_seed(args.seed)
    window = run.window_length(cell.config, args.seconds)
    setup_frames = int(cell.traffic["setup_frames"])
    n_frames = setup_frames + window + 4 * args.pairs + args.traced
    inputs = cell.loop.make_inputs(cell, args.seed, n_frames, dev)
    off_ns = {"span": per_call_ns(spans.span), "waited": per_call_ns(spans.waited)}
    spans.enable()
    on_ns = {"span": per_call_ns(spans.span), "waited": per_call_ns(spans.waited)}
    spans.disable()
    spans.take()
    walls = {"on": [], "off": []}
    counts = waits = None
    idle = defaultdict(int)
    idle_ns = wall_ns = 0
    with tempfile.TemporaryDirectory(prefix="slam_bench_") as workdir:
        loop = cell.loop.Loop(cell.config, inputs, dev, workdir)
        for i in range(setup_frames):
            loop.frame(i)
        i = setup_frames
        times = []
        for _ in range(window):
            times.append(loop.frame(i))
            i += 1
        for turn in ["on", "off", "off", "on"] * args.pairs:
            if turn == "on":
                spans.enable()
            walls[turn].append(loop.frame(i))
            spans.disable()
            records = spans.take()
            i += 1
            if turn == "on" and counts is None:
                n_waits = sum(records.syncs.values())
                counts = {"spans": len(records.spans) - n_waits, "waits": n_waits}
                waits = {site: [n, 0.0] for site, n in records.syncs.items()}
                for s in records.spans:
                    if s.name.startswith("wait/"):
                        waits[s.name[5:]][1] += (s.end_ns - s.start_ns) / 1e6
        for _ in range(args.traced):
            with profile(activities=[ProfilerActivity.CUDA] if cuda
                         else [ProfilerActivity.CPU]) as prof:
                t0 = time.time_ns()
                loop.frame(i)
                t1 = time.time_ns()
            i += 1
            records = spans.take()
            events = device_ns(prof) if cuda else []
            by_path, frame_idle = host_spans.idle_by_path(records.spans, events, (t0, t1))
            for path, ns in by_path.items():
                idle[path] += ns
            idle_ns += frame_idle
            wall_ns += t1 - t0
    frame_s = statistics.median(times)

    def per_frame_ns(ns):
        return counts["spans"] * ns["span"] + counts["waits"] * ns["waited"]

    med = {k: statistics.median(v) for k, v in walls.items() if v}
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    name, limit_w = run.power_limit(dev)
    result = {
        "device": name, "power_limit_w": limit_w,
        "window_frame_s": frame_s, "off_ns_per_call": off_ns, "on_ns_per_call": on_ns,
        "frame_counts": counts, "waits_by_site": waits,
        "off_cost_pct": 100.0 * per_frame_ns(off_ns) * 1e-9 / frame_s if counts else None,
        "on_calls_pct": (100.0 * per_frame_ns(on_ns) * 1e-9 / med["on"]
                         if counts and "on" in med else None),
        "untraced_wall_s": walls, "on_cost_pct": (100.0 * (med["on"] / med["off"] - 1.0)
                                                  if len(med) == 2 else None),
        "traced_frames": args.traced,
        "idle_pct": 100.0 * idle_ns / wall_ns if cuda and wall_ns else None,
        "idle_attributed_pct": (100.0 * sum(idle.values()) / idle_ns
                                if cuda and idle_ns else None),
        "idle_by_span": [[path, ns * 1e-9 / args.traced] for path, ns in top] if cuda else None}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
