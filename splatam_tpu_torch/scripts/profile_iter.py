"""Per-stage timing of one tracking and one mapping iteration.

Counterpart of scripts/profile_iter.py, both modes:
  (default)  pair-structure build, forward render, tracking fwd+bwd and
             mapping fwd+bwd with a reused structure, and the implied
             per-iteration times;
  --stages   projection, binning, K1, K2, K3 at 11 columns, the mapping
             forward alone, tracking fwd+bwd through the generic and the
             pair-space render, mapping fwd+bwd.

Each stage line gives, per call:
  wall    host clock over --iters calls ending in a synchronize (what the
          JAX script reports);
  events  CUDA events around the same calls (the device timeline from the
          first launch to the last, idle gaps included);
  busy    the device time of the kernels those calls launch (torch.profiler,
          device activity only, over another --iters calls), with how many
          of the port's kernel launches the profiler recorded; "unverified"
          unless it recorded every launch the wrappers counted;
  idle    1 - busy / wall: the share of the call the card waits for the host;
and the launches of the hand-written kernels per call, so the route that
get_loss took is visible. On the CPU only the wall time is measured.

    python -m splatam_tpu_torch.scripts.profile_iter [--n 262144] [--h 340] [--w 600] [--stages]
    python -m splatam_tpu_torch.scripts.profile_iter --device cpu --n 20000 --h 48 --w 64

The TPU script's --pair_cap, --direct_j and --tile_cull are gone (exact pair
buffers; the port has neither binning variant), and so is its dispatch
round-trip correction: every call here is timed on the card's own clock.
"""
from __future__ import annotations

import torch

from splatam_tpu_torch.render import api, binning, composite
from splatam_tpu_torch.scripts import harness, scene
from splatam_tpu_torch.slam import steps

TRACK_CFG = steps.PhaseConfig(use_sil_for_loss=True, sil_thres=0.99, use_l1=True,
                              ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0)
MAP_CFG = steps.PhaseConfig(use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
                            ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0)
# The TPU script's stages that the port does not have, and why.
ABSENT = {
    "padded layout + grouped sort":
        "the pair buffers are exact; build_bins emits tile_start, offsets and dst",
    "attr gather + transpose": "K1 and K2 read per-Gaussian rows through pair_gauss",
    "grouped grad gather": "K3 reads the per-pair gradient rows through dst",
    "end-slot totals extract": "K3 writes each Gaussian's total itself",
}


class Profiler:
    """Times stages and prints one line each."""

    def __init__(self, device, iters: int, reps: int):
        self.device, self.iters, self.reps = device, iters, reps
        self.results: dict[str, harness.Timing] = {}

    def stage(self, name: str, fn) -> harness.Timing:
        before = harness.launch_counts()
        fn()  # the first warm-up call, whose launches show the route
        after = harness.launch_counts()
        tm = harness.time_calls(fn, self.device, self.iters, self.reps, warmup=1, busy=True)
        self.results[name] = tm
        route = " ".join(f"{harness.SHORT.get(k, k)}x{after[k] - before[k]}"
                         for k in harness.KERNELS if after[k] != before[k]) or "none"
        busy = harness.verified_ms(tm.busy)
        idle = "" if busy is None else f" idle {100.0 * (1.0 - busy / tm.wall):5.1f}%"
        print(f"{name:<44s} wall {tm.wall:9.3f} ms  events {harness.fmt_ms(tm.event)}  "
              f"busy {harness.fmt_busy(tm.busy)}{idle}  launches {route}", flush=True)
        return tm

    @staticmethod
    def absent(name: str) -> None:
        print(f"{name:<44s} absent in the port: {ABSENT[name]}", flush=True)


def _track_grad(gm, q, t, color, depth_gt, cam, ps):
    def fn():
        q_, t_ = q.clone().requires_grad_(True), t.clone().requires_grad_(True)
        loss, _ = steps.get_loss(gm, q_, t_, color, depth_gt, cam, TRACK_CFG, True, False, ps)
        return torch.autograd.grad(loss, (q_, t_))
    return fn


def _map_grad(gm, q, t, color, depth_gt, cam, ps):
    keys = [k for k in steps.MAP_PARAMS if not (gm.isotropic and k == "unnorm_rotations")]

    def fn():
        params = {k: getattr(gm, k).detach().requires_grad_(True) for k in keys}
        loss, _ = steps.get_loss(gm._replace(**params), q, t, color, depth_gt, cam, MAP_CFG,
                                 False, True, ps)
        return torch.autograd.grad(loss, tuple(params.values()))
    return fn


def run_stages(prof: Profiler, gm, q, t, cam, color, depth_gt) -> None:
    """Stage-by-stage breakdown of one fwd+bwd iteration (scripts/profile_iter.py:74-258)."""
    w, h = cam.width, cam.height

    def proj_fn():
        return api.project_gaussians(cam, gm.means3d, gm.unnorm_rotations, gm.logit_opacities,
                                     gm.log_scales, gm.active)

    def bins_fn():
        proj, aux = proj_fn()
        return binning.build_bins(proj, aux, w, h, far=cam.far)

    prof.stage("projection fwd", proj_fn)
    prof.stage("ps build (proj + bins)", lambda: steps.loss_pair_structure(gm, q, t, cam))
    prof.stage("  proj + build_bins (expansion + key sort)", bins_fn)
    prof.absent("padded layout + grouped sort")
    prof.absent("attr gather + transpose")

    proj, _ = proj_fn()
    b = bins_fn()
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d],
                      1).contiguous()
    state = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h)
    prof.stage("K1 composite forward",
               lambda: composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h))
    g = torch.ones((composite.CH + 1, h, w), device=attrs.device)
    dattrs = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, state, g)
    prof.stage("K2 composite backward",
               lambda: composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h,
                                                    state, g))
    prof.absent("grouped grad gather")
    prof.stage("K3 segment reduce (11 columns)",
               lambda: composite.segment_reduce(dattrs, b.dst, b.offsets, b.counts))
    prof.absent("end-slot totals extract")

    ps = steps.loss_pair_structure(gm, q, t, cam)

    def map_fwd_only():
        with torch.no_grad():
            return steps.get_loss(gm, q, t, color, depth_gt, cam, MAP_CFG, False, True, ps)[0]

    prof.stage("mapping get_loss fwd ONLY (reused ps)", map_fwd_only)
    prof.stage("tracking get_loss fwd+bwd (reused ps)",
               _track_grad(gm, q, t, color, depth_gt, cam, ps))
    ps_w = steps.loss_pair_structure(gm, q, t, cam, with_world16=True)
    prof.stage("tracking get_loss fwd+bwd (pair-space)",
               _track_grad(gm, q, t, color, depth_gt, cam, ps_w))
    prof.stage("mapping get_loss fwd+bwd (reused ps)",
               _map_grad(gm, q, t, color, depth_gt, cam, ps))


def run_summary(prof: Profiler, gm, q, t, cam, color, depth_gt) -> None:
    """Structure build, forward, and the two fwd+bwd flavours, with the
    per-iteration times they imply (scripts/profile_iter.py:323-393)."""
    ps = steps.loss_pair_structure(gm, q, t, cam)
    print(f"n_pairs={ps.n_pairs}", flush=True)
    t_ps = prof.stage("pair_structure build", lambda: steps.loss_pair_structure(gm, q, t, cam))

    def fwd():
        with torch.no_grad():
            means_cam, rots_cam = steps.transform_to_frame(gm, q, t, False, False)
            return api.render_rgbd_sil(cam, means_cam, gm.rgb_colors, rots_cam,
                                       gm.logit_opacities, gm.log_scales, gm.active,
                                       pair_structure=ps).im

    t_fwd = prof.stage("forward render (reused ps)", fwd)
    t_tb = prof.stage("tracking fwd+bwd (reused ps)",
                      _track_grad(gm, q, t, color, depth_gt, cam, ps))
    t_mb = prof.stage("mapping  fwd+bwd (reused ps)",
                      _map_grad(gm, q, t, color, depth_gt, cam, ps))
    for label, get in (("wall", lambda x: x.wall),
                       ("busy", lambda x: harness.verified_ms(x.busy))):
        ms = [get(x) for x in (t_ps, t_fwd, t_tb, t_mb)]
        if None in ms:
            continue
        p, f, tb, mb = ms
        print(f"summary ({label}) @ n={gm.capacity}, {cam.width}x{cam.height}: ps={p:.3f}ms "
              f"fwd={f:.3f}ms track_bwd={tb:.3f}ms map_bwd={mb:.3f}ms; implied track iter "
              f"(rebin 8): {tb + p / 8:.3f}ms; map iter (1 ps / 24 kf window / 60 iters): "
              f"{mb + p * min(1.0, 24 / 60):.3f}ms", flush=True)


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--h", type=int, default=340)
    ap.add_argument("--w", type=int, default=600)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--stages", action="store_true", help="stage-by-stage breakdown")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "profile_iter")
    print(f"device={harness.describe(device)} n={args.n} {args.w}x{args.h} "
          f"{'stages' if args.stages else 'summary'}", flush=True)

    gm, q, t, cam = scene.synthetic_scene(args.n, args.w, args.h, 1.0, device)
    color = torch.zeros((3, args.h, args.w), device=device)
    depth_gt = torch.full((args.h, args.w), 3.0, device=device)
    prof = Profiler(device, args.iters, args.reps)
    (run_stages if args.stages else run_summary)(prof, gm, q, t, cam, color, depth_gt)
    return prof.results


if __name__ == "__main__":
    main()
