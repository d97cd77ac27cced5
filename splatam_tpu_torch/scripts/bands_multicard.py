"""Row bands spread over several cards against the same bands on one card.

parallel.spatial.make_bands places band k on visible card k mod (cards);
each kernel wrapper launches on the card its inputs lie on. This script
holds the spread placement to the one-card placement, which the
single-card checks hold to the unbanded image:
  1. on profile_sharded's seeded map (--n Gaussians at --h x --w) at the
     identity pose, for each band count in --shards: steps.get_loss for
     tracking on the rebin structure (the fused kernels, pose gradients),
     for mapping on the fused render and on the generic render with the
     3DGS harvest (every parameter's gradient), and densify_step's added
     count. The images are the same kernels on the same inputs, so the
     loss must be equal; a replicated input's gradient is summed over the
     bands in whatever order autograd's per-card threads finish, so each
     gradient column must lie within 5e-5 of its largest value;
  2. --frames frames of probe_saturation's SLAM loop (the synthetic config
     at --h x --w, --track_iters / --map_iters) with tpu.spatial_shards =
     the largest band count, spread and on one card: ATE, PSNR, Gaussians
     and the wall time per frame of both.
Exits 1 if a check fails, 2 with fewer than two visible cards (on the CPU
both placements are the CPU, which runs the code path only).

    python -m splatam_tpu_torch.scripts.bands_multicard [--shards 2 4] [--frames 3]
    python -m splatam_tpu_torch.scripts.bands_multicard --device cpu --n 2000 --h 48 --w 64 \\
        --frames 2 --track_iters 2 --map_iters 2
"""
from __future__ import annotations

import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from splatam_tpu_torch.data import frame_to_tensors
from splatam_tpu_torch.eval.evaluate import report_progress
from splatam_tpu_torch.parallel import spatial
from splatam_tpu_torch.scripts import harness, probe_saturation, profile_sharded
from splatam_tpu_torch.slam import steps
from splatam_tpu_torch.slam.config import seed_everything
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, _w2c_from_qt, run_frame

ROUTES = ("tracking", "mapping fused", "generic")


def route_inputs(route: str, gm, q, t, cam, bands):
    """(map, q, t, pair structure, means2d_dummy, what the gradients are
    taken of) of one get_loss route with `bands` (None: the full image):
    "tracking" on the rebin structure (the fused kernels, pose gradients),
    "mapping fused" on a reused structure, "generic" the mapping render
    with the 3DGS harvest (the means2d_dummy gradient among the
    columns)."""
    tracking = route == "tracking"
    q_, t_ = q.clone().requires_grad_(tracking), t.clone().requires_grad_(tracking)
    keys = ("means3d", "rgb_colors", "logit_opacities", "log_scales")
    params = {k: getattr(gm, k).detach().requires_grad_(not tracking) for k in keys}
    g = gm._replace(**params)
    ps, dummy = None, None
    if route == "generic":
        dummy = torch.zeros((gm.means3d.shape[0], 2), device=q.device, requires_grad=True)
    else:
        ps = steps.loss_pair_structure(g, q, t, cam, with_world16=tracking, bands=bands)
    wrt = (q_, t_) if tracking else tuple(params.values()) + ((dummy,) if dummy is not None
                                                             else ())
    return g, q_, t_, ps, dummy, wrt


def columns(grads) -> list:
    """Gradients -> their columns: one per parameter column, the pose's q
    and t one each."""
    return [c for x in grads for c in (x.reshape(x.shape[0], -1).T if x.dim() > 1 else x[None])]


def route_loss(route: str, gm, q, t, cam, color, depth, bands, pcfg=None):
    """(loss, aux, gradient columns) of steps.get_loss on one route
    (route_inputs) with `bands`; pcfg defaults to profile_sharded's."""
    tracking = route == "tracking"
    if pcfg is None:
        pcfg = profile_sharded.TRACK_CFG if tracking else profile_sharded.MAP_CFG
    g, q_, t_, ps, dummy, wrt = route_inputs(route, gm, q, t, cam, bands)
    loss, aux = steps.get_loss(g, q_, t_, color, depth, cam, pcfg, tracking, not tracking, ps,
                               means2d_dummy=dummy, bands=bands)
    return float(loss.detach()), aux, columns(torch.autograd.grad(loss, wrt))


def check_parity(gm, cam, color, depth, n: int, device) -> bool:
    """Part 1 at n bands: spread against one card. True if every check
    passes."""
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    t = torch.zeros(3, device=device)
    spread, one = spatial.make_bands(n, device), spatial.make_bands(n, device, cards=1)
    ok = True
    for route in ROUTES:
        loss_s, _, cols_s = route_loss(route, gm, q, t, cam, color, depth, spread)
        loss_o, _, cols_o = route_loss(route, gm, q, t, cam, color, depth, one)
        err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                  for a, b in zip(cols_s, cols_o))
        good = loss_s == loss_o and err <= 5e-5
        ok &= good
        print(f"{n} bands, {route}: loss {loss_s!r} spread, {loss_o!r} on one card; worst "
              f"gradient column {err:.1e} of its largest {'ok' if good else 'FAIL'}",
              flush=True)
    big = type(gm)(*(torch.cat([a, torch.zeros((cam.width * cam.height,) + a.shape[1:],
                                               dtype=a.dtype, device=a.device)]) for a in gm))
    ts = torch.zeros((big.means3d.shape[0],), device=device)
    added = [steps.densify_step(big, ts, color, depth, q, t, 1, cam, 0.5, b)[2]
             for b in (spread, one)]
    good = added[0] == added[1]
    ok &= good
    print(f"{n} bands, densify_step: {added[0]} added spread, {added[1]} on one card "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return ok


def slam_run(n: int, cards: int | None, args, device) -> dict:
    """Part 2: probe_saturation's loop with n bands over `cards` cards."""
    workdir = tempfile.mkdtemp(prefix="bands_multicard_")
    try:
        config = probe_saturation.loop_config(args.frames, args.h, args.w, workdir,
                                              args.track_iters, args.map_iters)
        config["tpu"]["spatial_shards"] = n
        seed_everything(0)
        rt = SLAMRuntime(config, device)
        rt.bands = spatial.make_bands(n, device, cards)
        walls = []
        for i in range(rt.num_frames):
            t0 = time.perf_counter()
            run_frame(rt, i)
            if device.type == "cuda":
                for dev in sorted(set(rt.bands), key=str):
                    torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    last = rt.num_frames - 1
    color_np, depth_np, _, _ = rt.dataset[last]
    color, depth = frame_to_tensors(color_np, depth_np, device)
    span = rt.gm.span()
    m = report_progress(type(rt.gm)(*(a[:span] for a in rt.gm)), rt.cam_rots[last],
                        rt.cam_trans[last], color, depth, rt.cam, 0.99, tracking=True,
                        gt_w2c_list=rt.gt_w2c_all,
                        est_w2c_list=[_w2c_from_qt(rt.cam_rots[i], rt.cam_trans[i])
                                      for i in range(rt.num_frames)])
    return dict(bands=[str(d) for d in rt.bands], ate_cm=m["ate_rmse"] * 100, psnr=m["psnr"],
                gaussians=rt.gm.num_active(), walls=walls,
                poses=np.concatenate([np.stack(rt.cam_rots[:rt.num_frames]),
                                      np.stack(rt.cam_trans[:rt.num_frames])], 1))


def main(argv=None) -> bool:
    ap = harness.parser(__doc__)
    ap.add_argument("--shards", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--n", type=int, default=200000)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--track_iters", type=int, default=40)
    ap.add_argument("--map_iters", type=int, default=60)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "bands_multicard")
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    print(f"device={harness.describe(device)}, {cards} visible cards", flush=True)
    if device.type == "cuda" and cards < 2:
        print("bands_multicard: needs two visible cards or more", file=sys.stderr)
        sys.exit(2)
    gm, cam, color, depth = profile_sharded.make_scene(args.n, args.w, args.h, device)
    ok = all([check_parity(gm, cam, color, depth, n, device) for n in args.shards])
    del gm, color, depth
    n = max(args.shards)
    runs = {name: slam_run(n, c, args, device) for name, c in (("spread", None),
                                                               ("one card", 1))}
    for name, r in runs.items():
        print(f"SLAM, {n} bands {name} on {', '.join(r['bands'])}: ATE {r['ate_cm']:.4f} cm, "
              f"PSNR {r['psnr']:.4f} dB, {r['gaussians']} Gaussians, wall per frame "
              f"{', '.join(f'{w:.3f}' for w in r['walls'])} s", flush=True)
    drift = float(np.abs(runs["spread"]["poses"] - runs["one card"]["poses"]).max())
    good = all(np.isfinite([r["ate_cm"], r["psnr"]]).all() for r in runs.values())
    ok &= good
    print(f"SLAM: largest pose component difference spread vs one card {drift:.2e} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    print(f"bands_multicard {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        sys.exit(1)
    return ok


if __name__ == "__main__":
    main()
