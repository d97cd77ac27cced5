"""Readings that set the limits of the correctness check: the program's
sound readings over many seeds, the control's, and the planted faults'.

    python3 -m slam_bench.control --workload replica_bench.fr1_desk \\
        --seeds 11 12 13 --control --faults

For every seed, in one process, through the cell's loop
(slam_bench/loops/<loop>.py): the cell's set-up (the loop's inputs from
the seed, the loop, the set-up units, and --after more units), then check
units through the window's own call:
  * sound: the program as it is, against the reference;
  * with --control, on that same check unit, the control: the reference
    in the next precision down (the online loop's: TF32, where the
    configuration states float32 with TF32 off) put in the program's place
    and judged by the same numbers;
  * with --faults, one more check unit per fault the loop plants (the
    online loop's: every optimizer step returning its state unchanged, the
    loss over half of the frame, every render's colour altered by 1% where
    the render is made, densification's new Gaussians placed 1% too deep).
Prints one JSON line per reading: {"workload", "seed", "kind", "seconds",
"readings"}, with the check's own line and its extras (the online loop's:
both sides' losses, tracking's first gradient and step by leaf) beside the
sound's and the faults'.
Never run by the benchmark's own runs; slam_bench/tests/test_control.py
runs it on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time

from slam_bench import spec

# the online loop's faults, under the names they have had here
FAULTS = spec.load_loop("online").FAULTS
planted = spec.load_loop("online").planted


def readings_for_seed(cell: spec.Cell, seed: int, device, control: bool, faults: bool,
                      emit, after: int = 0) -> None:
    import numpy as np
    import torch

    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)
    i = int(cell.traffic["setup_frames"]) + after
    inputs = cell.loop.make_inputs(cell, seed, i + 1, device)
    follow_cfg = cell.limits["follow"]
    with tempfile.TemporaryDirectory(prefix="slam_bench_") as workdir:
        for kind in ["sound", *(cell.loop.FAULTS if faults else ())]:
            loop = cell.loop.Loop(cell.config, inputs, device, workdir)
            for j in range(i):
                loop.frame(j)
            t0 = time.perf_counter()
            with cell.loop.planted(kind) if kind in cell.loop.FAULTS else contextlib.nullcontext():
                judged = cell.loop.check(loop, i, follow_cfg)
            emit(seed, kind, judged.readings, time.perf_counter() - t0, line=judged.line,
                 **judged.extras)
            if kind == "sound" and control:
                t1 = time.perf_counter()
                emit(seed, "control", cell.loop.control_readings(loop, judged, follow_cfg),
                     time.perf_counter() - t1)
            del judged, loop
            if device.type == "cuda":
                torch.cuda.empty_cache()


def main(argv=None, device: str | None = None, root=spec.ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--after", type=int, default=0,
                    help="frames run after the set-up frames before the check frame")
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load(root), args.workload, root / "slam_bench")
    import torch

    if device is None and not torch.cuda.is_available():
        print("slam_bench.control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(device or "cuda")

    def emit(seed, kind, readings, seconds, **extra):
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                          "seconds": seconds, "readings": readings, **extra}), flush=True)

    for seed in args.seeds:
        readings_for_seed(cell, seed, dev, args.control, args.faults, emit, args.after)
    return 0


if __name__ == "__main__":
    sys.exit(main())
