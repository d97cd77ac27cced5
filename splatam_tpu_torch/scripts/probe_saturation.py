"""The saturation trim: how many pairs a per-tile cut at the deepest contributor keeps.

Counterpart of scripts/probe_saturation.py. K1 stops a pixel's walk once it
is saturated and reports n_contrib, the deepest pair that pixel applied;
every pair of a tile past its deepest n_contrib contributes nothing
forward or backward, yet the structure build, K2, K3 and the per-pair
gathers still carry it. This probe runs the SLAM loop (the synthetic
config at --h x --w, 40 tracking / 60 mapping iterations (--track_iters,
--map_iters), rebin_every=8,
each frame starting from the previous frame's pose) for --frames frames,
builds the generic render's structure at the last frame's pose, runs one
K1 forward, and reports:
  - the pairs per tile (the structure's tile_start);
  - the deepest contributor per tile (the max of K1's n_contrib over the
    tile's pixels);
  - the pairs a per-tile trim at ceil(n_contrib * slack) would keep, for
    slack 1.0, 1.25 and 1.5.

    python -m splatam_tpu_torch.scripts.probe_saturation [--frames 6] [--h 680] [--w 1200]
    python -m splatam_tpu_torch.scripts.probe_saturation --device cpu --frames 2 --h 48 --w 64 \
        --track_iters 2 --map_iters 2

The TPU script's padded128 / padded64 counts are gone: they measure the
Pallas kernels' tile lists padded to 128 (or 64) lanes, a layout the port
does not have (its tiles hold exactly their pairs), so the counts here are
the exact ones.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from splatam_tpu_torch.core import gaussians as G
from splatam_tpu_torch.render import api, composite
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.slam import steps
from splatam_tpu_torch.slam.config import load_experiment_config, seed_everything
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs", "synthetic", "splatam.py")
SLACKS = (1.0, 1.25, 1.5)


def loop_config(frames: int, h: int, w: int, workdir: str, track_iters: int = 40,
                map_iters: int = 60) -> dict:
    """The JAX script's configuration: the synthetic config at h x w,
    rebin_every 8, every frame starting from the previous frame's pose (no
    forward_prop)."""
    config = load_experiment_config(CONFIG)
    config["workdir"] = workdir
    config["data"].update(desired_image_height=h, desired_image_width=w, num_frames=frames)
    config["tracking"].update(num_iters=track_iters, forward_prop=False)
    config["mapping"]["num_iters"] = map_iters
    cap = 1 << 19
    while cap < 2 * h * w:
        cap <<= 1
    config["tpu"] = dict(capacity=cap, rebin_every=8)
    return config


def run_loop(frames: int, h: int, w: int, device, workdir: str, track_iters: int = 40,
             map_iters: int = 60) -> SLAMRuntime:
    """The JAX script's loop: pipeline.run_frame for each frame of
    loop_config's run."""
    seed_everything(0)
    rt = SLAMRuntime(loop_config(frames, h, w, workdir, track_iters, map_iters), device)
    for time_idx in range(rt.num_frames):
        run_frame(rt, time_idx)
        print(f"frame {time_idx}: n_gauss={rt.gm.num_active()}", flush=True)
    return rt


def trim_counts(gm, q, t, cam) -> dict:
    """Pairs per tile, the deepest contributor per tile and the trimmed
    totals of one K1 forward of gm at pose (q, t)."""
    with torch.no_grad():
        ps = steps.loss_pair_structure(gm, q, t, cam)
        means_cam, rots_cam = steps.transform_to_frame(gm, q, t, False, False)
        proj, _ = api.project_gaussians(cam, means_cam, rots_cam, gm.logit_opacities,
                                        gm.log_scales, gm.active)
        z = proj.depth[:, None]
        attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, z, z * z],
                          1).contiguous()
        out = composite.composite_forward(attrs, ps.pair_gauss, ps.tile_start, cam.width,
                                          cam.height)
        nc_tile = composite.to_tiles(out[composite.CH + 1:])[0].amax(1)
    lens = (ps.tile_start[1:] - ps.tile_start[:-1]).cpu().numpy().astype(np.int64)
    nc_tile = nc_tile.cpu().numpy()
    total = int(lens.sum())
    trimmed = {s: int(np.minimum(lens, np.ceil(nc_tile * s).astype(np.int64)).sum())
               for s in SLACKS}
    return dict(tiles=len(lens), total=total, lens=lens, nc_tile=nc_tile, trimmed=trimmed)


def report(r: dict, n_active: int) -> None:
    lens, nc = r["lens"], r["nc_tile"]
    print(f"n_active={n_active} tiles={r['tiles']} pairs total={r['total']}", flush=True)
    print(f"lens: mean={lens.mean():.0f} p50={np.median(lens):.0f} "
          f"p90={np.percentile(lens, 90):.0f} max={lens.max()}", flush=True)
    print(f"nc_tile: mean={nc.mean():.0f} p50={np.median(nc):.0f} "
          f"p90={np.percentile(nc, 90):.0f} max={nc.max():.0f}", flush=True)
    for s, kept in r["trimmed"].items():
        print(f"slack={s}: trimmed={kept} ({kept / max(r['total'], 1):.3f}x)", flush=True)


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--track_iters", type=int, default=40)
    ap.add_argument("--map_iters", type=int, default=60)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "probe_saturation")
    print(f"device={harness.describe(device)}", flush=True)
    workdir = tempfile.mkdtemp(prefix="probe_saturation_")
    try:
        rt = run_loop(args.frames, args.h, args.w, device, workdir, args.track_iters,
                      args.map_iters)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    last = rt.num_frames - 1
    q = torch.as_tensor(rt.cam_rots[last], device=device)
    t = torch.as_tensor(rt.cam_trans[last], device=device)
    view = G.slice_prefix(rt.gm, rt.gm.span())
    r = trim_counts(view, q, t, rt.cam)
    report(r, rt.gm.num_active())
    return r


if __name__ == "__main__":
    main()
