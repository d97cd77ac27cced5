"""Split the fused forward's time: its memory walk against its math.

Counterpart of scripts/probe_dma.py. Times, on one pair structure:

  full       K4, the fused forward (the reference point)
  dma_only   K4's walk over the world rows, 128 rows per step staged into
             shared memory, one add per row (no compositing)
  dma_b2/b4  the same walk staging 2 or 4 times as many rows per step
  math_only  K4's per-pair math on each tile's first 128 pairs only,
             composited as many times as the tile has 128-pair chunks (no
             walk over memory)

dma_only ~ full  -> the memory walk bounds K4 (staging more rows per step pays)
math_only ~ full -> the per-pixel compositing chain bounds K4

    python -m splatam_tpu_torch.scripts.probe_dma [--n 1272155] [--opacity_logit 1.0]
    python -m splatam_tpu_torch.scripts.probe_dma --device cpu --n 20000 --h 48 --w 64

Each kernel is timed with CUDA events over --iters launches after one
warm-up launch, median of --reps. The TPU script's --pair_cap is gone: the
port's pair buffers are exact.
"""
from __future__ import annotations

from splatam_tpu_torch.render import fused_iso, probes
from splatam_tpu_torch.scripts import harness, scene


def run(ps, pose, width: int, height: int, device, iters: int = 10, reps: int = 3,
        note: str = "") -> dict:
    """Time K4 and the four probes on one structure; returns name ->
    harness.Timing."""
    w8, ts = ps.world8, ps.tile_start
    lens = ts[1:] - ts[:-1]
    chunks = int(((lens + probes.C - 1) // probes.C).sum())
    print(f"device={harness.describe(device)} pairs={ps.n_pairs} tiles={lens.shape[0]} "
          f"chunks={chunks} (of {probes.C} pairs) {note}".rstrip(), flush=True)

    runs = {
        "full": lambda: fused_iso.fused_forward(w8, pose, ts, width, height),
        "dma_only": lambda: probes.dma_walk(w8, ts, 1),
        "dma_b2": lambda: probes.dma_walk(w8, ts, 2),
        "dma_b4": lambda: probes.dma_walk(w8, ts, 4),
        "math_only": lambda: probes.math_only(w8, pose, ts, width, height),
    }
    times = {}
    for name, fn in runs.items():
        times[name] = harness.time_calls(fn, device, iters, reps)
        tm = times[name]
        print(f"{name:<12s} {tm.wall:9.3f} ms/iter wall, {harness.fmt_ms(tm.event)} events",
              flush=True)
    return times


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--n", type=int, default=1272155)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--opacity_logit", type=float, default=1.0)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "probe_dma")
    gm, q, t, cam = scene.synthetic_scene(args.n, args.w, args.h, args.opacity_logit, device)
    ps, pose = scene.fused_inputs(gm, q, t, cam)
    return run(ps, pose, args.w, args.h, device, args.iters, args.reps,
               f"opacity_logit={args.opacity_logit}")


if __name__ == "__main__":
    main()
