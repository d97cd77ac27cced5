"""Row gathers at the SLAM loop's shapes, and tracking's per-rebin gather
against reading rows through pair_gauss.

Counterpart of scripts/exp_gather.py. Part 1, its experiment: a table
[pad, 16] of float32 (pad = --pad, else P * 1.08 rounded down to 128 rows,
the JAX package's padded pair count) and P = --p indices, a random
permutation's first P or the same sorted; the row gather (index_select) of
16 columns and of 8 (a [pad, 8] table, world-8's width), and index_add_ of
P rows of 16 as the scatter-add. Part 2 (the roadmap's follow-up on
tracking's gather): on a map at one pose, the per-rebin gather of the
world-8 rows per sorted pair (slam/steps.py loss_pair_structure), the
world-16 gather an anisotropic map takes there, K4 + K5 on the gathered
per-pair rows (tracking's mode), K4 + K5 reading the per-Gaussian rows
through pair_gauss (mapping's mode), and the per-pair means gather
[P, 3] that tracking's pose contraction (fused_iso._pose_grads) would
still need each iteration in that mode; then both modes per tracking
iteration at rebin_every=8.
Each line: wall (host clock, ending in a synchronize) and CUDA-event ms per
call, median of --reps runs of --iters calls.

    python -m splatam_tpu_torch.scripts.exp_gather [--p 1835008] [--pad 0] [--n 950272]
    python -m splatam_tpu_torch.scripts.exp_gather --device cpu --p 20000 --n 20000 --h 48 --w 64

Gone from the TPU script: the split gathers (the table cut into 2 or 4
column groups gathered apart, a workaround for XLA's gather lowering;
index_select reads whole rows in one kernel) and the --transposed variants,
which measure the Pallas kernels' [16, pad] attribute layout: the port keeps
rows [P, k], so there is no transposed table to gather from.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_tpu_torch.render import fused_iso, pairspace
from splatam_tpu_torch.scripts import harness, scene

REBIN_EVERY = 8  # bench.py's tpu.rebin_every


def _line(name: str, tm) -> None:
    print(f"{name:<44s} wall {tm.wall:9.3f} ms  events {harness.fmt_ms(tm.event)}", flush=True)


def table_gathers(p: int, pad: int, device, iters: int, reps: int, seed: int = 0) -> dict:
    """Part 1: name -> harness.Timing."""
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.uniform(-1, 1, (pad, 16)).astype(np.float32), device=device)
    table8 = table[:, :8].contiguous()
    idx_rand = torch.tensor(rng.permutation(pad)[:p].astype(np.int64), device=device)
    idx_seq = torch.sort(idx_rand).values
    src = table[:p]
    print(f"device={harness.describe(device)} p={p} pad={pad}", flush=True)
    out = {}
    for kind, idx in (("random", idx_rand), ("sorted", idx_seq)):
        cases = ((f"gather {kind} 16col", lambda idx=idx: table.index_select(0, idx)),
                 (f"gather {kind} 8col", lambda idx=idx: table8.index_select(0, idx)),
                 (f"scatter-add {kind} (index_add_)",
                  lambda idx=idx: torch.zeros_like(table).index_add_(0, idx, src)))
        for name, fn in cases:
            out[name] = harness.time_calls(fn, device, iters, reps)
            _line(name, out[name])
    return out


def tracking_gather(gm, q, t, cam, device, iters: int, reps: int, seed: int = 0) -> dict:
    """Part 2 on map gm at pose (q, t): name -> harness.Timing, and the two
    modes per tracking iteration (ms, from the event times on the card,
    the wall times elsewhere)."""
    w, h = cam.width, cam.height
    ps, pose = scene.fused_inputs(gm, q, t, cam)
    idx = ps.pair_gauss.long()
    with torch.no_grad():
        rows8 = fused_iso.pack_world8(gm.means3d, gm.logit_opacities, gm.log_scales,
                                      gm.rgb_colors, gm.active).contiguous()
        rows16 = pairspace.pack_world_rows(gm.means3d, gm.unnorm_rotations, gm.logit_opacities,
                                           gm.log_scales, gm.rgb_colors, gm.active).contiguous()
    gen = torch.Generator(device).manual_seed(seed)
    g = torch.randn((6, h, w), device=device, generator=gen)
    print(f"map: {gm.means3d.shape[0]} Gaussians, {ps.n_pairs} pairs, {w}x{h}", flush=True)

    def per_pair():
        state = fused_iso.fused_forward(ps.world8, pose, ps.tile_start, w, h)
        return fused_iso.fused_backward(ps.world8, pose, ps.tile_start, w, h, state, g)

    def through_pair_gauss():
        state = fused_iso.fused_forward(rows8, pose, ps.tile_start, w, h, ps.pair_gauss)
        return fused_iso.fused_backward(rows8, pose, ps.tile_start, w, h, state, g,
                                        ps.pair_gauss)

    cases = (("world8 gather per rebin [P, 8]", lambda: rows8[idx].contiguous()),
             ("world16 gather per rebin [P, 13]", lambda: rows16[idx].contiguous()),
             ("K4 + K5 on per-pair rows", per_pair),
             ("K4 + K5 through pair_gauss", through_pair_gauss),
             ("per-pair means gather [P, 3]", lambda: rows8[idx, 0:3]))
    out = {}
    for name, fn in cases:
        out[name] = harness.time_calls(fn, device, iters, reps)
        _line(name, out[name])

    def ms(name):
        tm = out[name]
        return tm.event if tm.event is not None else tm.wall

    gathered = ms("K4 + K5 on per-pair rows") + ms("world8 gather per rebin [P, 8]") / REBIN_EVERY
    direct = ms("K4 + K5 through pair_gauss") + ms("per-pair means gather [P, 3]")
    clock = "events" if out["K4 + K5 on per-pair rows"].event is not None else "wall"
    print(f"per tracking iteration at rebin_every={REBIN_EVERY} ({clock}): gathered rows "
          f"{gathered:.4f} ms, through pair_gauss {direct:.4f} ms", flush=True)
    return dict(times=out, gathered_ms=gathered, direct_ms=direct, n_pairs=ps.n_pairs)


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--p", type=int, default=1835008)
    ap.add_argument("--pad", type=int, default=0)
    ap.add_argument("--n", type=int, default=950272)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "exp_gather")
    pad = args.pad or int(args.p * 1.08) // 128 * 128
    part1 = table_gathers(args.p, pad, device, args.iters, args.reps)
    gm, q, t, cam = scene.synthetic_scene(args.n, args.w, args.h, 1.0, device)
    return dict(tables=part1, tracking=tracking_gather(gm, q, t, cam, device, args.iters,
                                                       args.reps))


if __name__ == "__main__":
    main()
