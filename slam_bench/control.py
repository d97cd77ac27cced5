"""Readings that set the limits of the correctness check: the program's
sound readings over many seeds, the control's, and the planted faults'.

    python3 -m slam_bench.control --workload replica_bench.fr1_desk \\
        --seeds 11 12 13 --control --faults

For every seed, in one process: the cell's set-up (frames from the seed,
SLAMRuntime, the set-up frames, and --after more frames), then check
frames through the window's own frame call (slam_bench/check.py):
  * sound: the program as it is, against the float32 reference;
  * with --control, on that same check frame, the control: the reference
    in TF32 (the configuration states float32 with TF32 off) put in the
    program's place and judged by the same numbers;
  * with --faults, one more check frame per planted fault: every optimizer
    step returning its state unchanged, the loss over half of the frame
    (its bottom half's depth left out), every render's colour altered by 1%
    where the render is made, and densification's new Gaussians placed 1%
    too deep along their rays where they are made.
Prints one JSON line per reading: {"seed", "kind", "readings"}. Never run by
the benchmark's own runs; slam_bench/tests/test_control.py runs it on the
card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time

from slam_bench import spec

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "densify_altered")


@contextlib.contextmanager
def planted(fault: str):
    """The program with one fault planted, for the duration."""
    from splatam_tpu_torch.render import api
    from splatam_tpu_torch.slam import optim, steps

    if fault == "state_unchanged":
        module, name, orig = optim, "adam_step", optim.adam_step

        def broken(state, params, grads, lrs, eps):
            return tuple(params), orig(state, params, grads, lrs, eps)[1]
    elif fault == "half_batch":
        module, name, orig = steps, "get_loss", steps.get_loss

        def broken(gm, q, t, color, depth_gt, cam, *args, **kwargs):
            half = depth_gt.clone()
            half[half.shape[0] // 2:] = 0.0
            return orig(gm, q, t, color, half, cam, *args, **kwargs)
    elif fault == "answer_altered":
        module, name, orig = api, "_public", api._public

        def broken(img, radii, n_pairs):
            out = orig(img, radii, n_pairs)
            return out._replace(im=out.im * 1.01)
    elif fault == "densify_altered":
        module, name, orig = steps, "backproject_pointcloud", steps.backproject_pointcloud

        def broken(color, depth, *args):
            return orig(color, depth * 1.01, *args)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(module, name, broken)
    try:
        yield
    finally:
        setattr(module, name, orig)


def readings_for_seed(cell: spec.Cell, seed: int, device, control: bool, faults: bool,
                      emit, after: int = 0) -> None:
    import numpy as np
    import torch

    from slam_bench import check, traffic
    from slam_bench.loop import Loop

    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)
    plan = traffic.Plan(cell.traffic, seed, int(cell.traffic["setup_frames"]) + after + 1)
    frames = traffic.make_frames(plan, cell.config["camera"], cell.config["sensor"],
                                 cell.config["scene"], seed, device)
    follow_cfg = cell.limits["follow"]
    with tempfile.TemporaryDirectory(prefix="slam_bench_") as workdir:
        kinds = ["sound", *(FAULTS if faults else ())]
        for kind in kinds:
            loop = Loop(cell.config, plan, frames, device, workdir)
            i = plan.n_frames - 1
            for j in range(i):
                loop.frame(j)
            t0 = time.perf_counter()
            with planted(kind) if kind in FAULTS else contextlib.nullcontext():
                readings, obs, ref = check.check(loop, i, follow_cfg)
            first = obs.first.get("track", {}).get("step", [])
            emit(seed, kind, readings, time.perf_counter() - t0,
                 losses={"track": [obs.track_losses[:len(ref.track["losses"])],
                                   ref.track["losses"]],
                         "map": [obs.map_losses[:len(ref.map["losses"])], ref.map["losses"]]},
                 track_grad=[[v.tolist() for v in obs.first.get("track", {}).get("grads", [])],
                             [v.tolist() for v in ref.track["grads"]]],
                 track_step=[[v.tolist() for v in first], [v.tolist() for v in ref.track["step"]]])
            if kind == "sound" and control:
                t1 = time.perf_counter()
                emit(seed, "control", check.control_readings(obs, cell.config, loop.stream, device,
                                                             follow_cfg),
                     time.perf_counter() - t1)
            del obs, ref, loop
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
