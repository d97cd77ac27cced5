"""One mapping iteration with one part taken off at a time.

Counterpart of scripts/profile_map_ablate.py, on its measurement map: n
Gaussians (950,272 by default, about the bench's steady map) from --seed
(scripts/scene.py's construction, which is that script's), 1200x680,
identity pose, a zero colour target and a 3 m depth target; one pair
structure at that pose, reused by every probe. Each line is the wall (host
clock, ending in a synchronize) and CUDA-event ms per call, the median of
--reps runs of --iters calls, of:
  - mapping fwd+bwd (baseline): get_loss's fused mapping render and its
    loss, gradients to every parameter the render reads;
  - the same with the gradient to the means only;
  - the mapping forward only (no autograd graph);
  - the tracking formula's forward (no SSIM) through the generic render on
    the same structure;
  - the pair-structure build.
Differences between lines attribute the iteration's cost.

    python -m splatam_tpu_torch.scripts.profile_map_ablate [--n 950272]
    python -m splatam_tpu_torch.scripts.profile_map_ablate --device cpu --n 20000 --h 48 --w 64

Gone from the TPU script: its fori_loop carry, which fed every probe's
result back into the next call's input so that XLA could not remove the
work as dead code. Eager PyTorch runs every call it is given, and the
timing ends in a synchronize, so nothing is elided here. --pair_cap is gone
too: the port's pair buffers are exact. An isotropic map's rotations never
enter the render and take no gradient (mapping_phase steps them not).
"""
from __future__ import annotations

import torch

from splatam_tpu_torch import kernels
from splatam_tpu_torch.scripts import harness, scene
from splatam_tpu_torch.slam import steps

PCFG = steps.PhaseConfig(use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
                         ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0)


def run(gm, q, t, cam, device, iters: int, reps: int) -> dict:
    """name -> harness.Timing for each probe."""
    h, w = cam.height, cam.width
    color = torch.zeros((3, h, w), device=device)
    depth_gt = torch.full((h, w), 3.0, device=device)
    ps = steps.loss_pair_structure(gm, q, t, cam)
    print(f"device={harness.describe(device)} n={gm.means3d.shape[0]} {w}x{h} "
          f"n_pairs={ps.n_pairs}", flush=True)
    keys = [k for k in steps.MAP_PARAMS if not (gm.isotropic and k == "unnorm_rotations")]

    def grads(wrt):
        def fn():
            params = {k: getattr(gm, k).detach().requires_grad_(k in wrt) for k in keys}
            loss, _ = steps.get_loss(gm._replace(**params), q, t, color, depth_gt, cam, PCFG,
                                     False, True, ps)
            return torch.autograd.grad(loss, [params[k] for k in wrt])
        return fn

    @torch.no_grad()
    def fwd_only():
        return steps.get_loss(gm, q, t, color, depth_gt, cam, PCFG, False, True, ps)[0]

    @torch.no_grad()
    def fwd_tracking_formula():
        return steps.get_loss(gm, q, t, color, depth_gt, cam, PCFG, True, False, ps)[0]

    probes = (
        ("mapping fwd+bwd (baseline)", grads(keys)),
        ("mapping fwd+bwd grads: means only", grads(["means3d"])),
        ("mapping fwd only", fwd_only),
        ("tracking-formula fwd (no SSIM, generic render)", fwd_tracking_formula),
        ("pair-structure build", lambda: steps.loss_pair_structure(gm, q, t, cam)),
    )
    out = {}
    for name, fn in probes:
        before = kernels.launch_counts()
        fn()
        after = kernels.launch_counts()
        out[name] = tm = harness.time_calls(fn, device, iters, reps)
        route = harness.route(before, after)
        print(f"{name:<48s} wall {tm.wall:9.3f} ms  events {harness.fmt_ms(tm.event)}  "
              f"launches {route}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--n", type=int, default=950272)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "profile_map_ablate")
    gm, q, t, cam = scene.synthetic_scene(args.n, args.w, args.h, 1.0, device, seed=args.seed)
    return run(gm, q, t, cam, device, args.iters, args.reps)


if __name__ == "__main__":
    main()
