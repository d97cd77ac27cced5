"""Two-batch probe of the fused forward: fwd2 against K4 on one structure.

Counterpart of scripts/probe_unroll.py. fwd2 (render/probes.py,
csrc/fused_probes.cu) computes K4's image with two 256-pair batches per loop
step: each thread loads both of its pairs' world rows before it projects
either, and the block walks 512 pairs between barriers. The probe checks
fwd2 against K4 (torch.equal: the same pairs in the same order under the
same arithmetic), then times both with CUDA events.

    python -m splatam_tpu_torch.scripts.probe_unroll [--n 1272155] [--opacity_logit -2.0]
    python -m splatam_tpu_torch.scripts.probe_unroll --device cpu --n 20000 --h 48 --w 64

The TPU script's --pair_cap is gone: the port's pair buffers are exact.
"""
from __future__ import annotations

import sys

import torch

from splatam_tpu_torch.render import fused_iso, probes
from splatam_tpu_torch.scripts import harness, scene


def run(ps, pose, width: int, height: int, device, iters: int = 10, reps: int = 3,
        note: str = "") -> dict:
    """Check fwd2 against K4 on one structure (exits 1 if they differ), then
    time both; returns {"full", "fwd2"} -> harness.Timing."""
    lens = ps.tile_start[1:] - ps.tile_start[:-1]
    batches = int(((lens + probes.STEP2 - 1) // probes.STEP2).sum())
    print(f"device={harness.describe(device)} pairs={ps.n_pairs} tiles={lens.shape[0]} "
          f"batches={batches} (of {probes.STEP2} pairs) {note}".rstrip(), flush=True)

    def full():
        return fused_iso.fused_forward(ps.world8, pose, ps.tile_start, width, height)

    def fwd2():
        return probes.fwd2(ps.world8, pose, ps.tile_start, width, height)

    ref, got = full(), fwd2()
    equal = torch.equal(ref, got)
    print(f"parity fwd2 vs K4: equal={equal} max|diff|={float((ref - got).abs().max()):.3e}",
          flush=True)
    if not equal:
        print("probe_unroll: fwd2 differs from K4", file=sys.stderr)
        sys.exit(1)
    times = {}
    for name, fn in (("full", full), ("fwd2", fwd2)):
        times[name] = harness.time_calls(fn, device, iters, reps)
        tm = times[name]
        print(f"{name:<10s} {tm.wall:9.3f} ms/iter wall, {harness.fmt_ms(tm.event)} events",
              flush=True)
    return times


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--n", type=int, default=1272155)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--opacity_logit", type=float, default=-2.0,
                    help="-2.0 (~0.12 alpha) keeps most pixels' walks to the tile's "
                         "end; 1.0 saturates")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "probe_unroll")
    gm, q, t, cam = scene.synthetic_scene(args.n, args.w, args.h, args.opacity_logit, device)
    ps, pose = scene.fused_inputs(gm, q, t, cam)
    return run(ps, pose, args.w, args.h, device, args.iters, args.reps,
               f"opacity_logit={args.opacity_logit}")


if __name__ == "__main__":
    main()
