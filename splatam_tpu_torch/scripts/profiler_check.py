"""Does torch.profiler record every launch of the port's kernels?

The port launches its kernels through ctypes, outside PyTorch's dispatcher,
and `profile_iter` reads a stage's device-busy time from torch.profiler.
This script profiles windows that hold only K1, K2 or K3 (at 11 columns)
on profile_iter's --stages inputs, and varies what could make the profiler
drop launches: the window's length (10 or 100 calls), whether it is the
process's first profile, host sleeps inside the window before and after
the launches, profile_iter's own way (after timed calls, outputs kept),
and what was profiled before (30 projections, 50,000 small launches,
200 backward passes). Each line gives the launches the profiler recorded
against those the wrappers counted, and its device time per call against
the CUDA-event time of the same calls. No window is profiled twice: a
drop shows as it happened.

    python -m splatam_tpu_torch.scripts.profiler_check [--n 262144] [--h 340] [--w 600]

Run it as a process of its own: its first window must be the process's
first profile. It needs a GPU.
"""
from __future__ import annotations

import time

import torch

from splatam_tpu_torch.render import api, binning, composite
from splatam_tpu_torch.scripts import harness, scene


def _window(fn, iters: int, pad_s: float):
    def run():
        if pad_s:
            time.sleep(pad_s)
        for _ in range(iters):
            fn()
        if pad_s:
            torch.cuda.synchronize()
            time.sleep(pad_s)
    return run


def main(argv=None) -> list:
    ap = harness.parser(__doc__)
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--h", type=int, default=340)
    ap.add_argument("--w", type=int, default=600)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "profiler_check")
    if device.type != "cuda":
        raise SystemExit("profiler_check: the profiler's device trace needs --device cuda")
    print(f"device={harness.describe(device)} n={args.n} {args.w}x{args.h}", flush=True)

    gm, _, _, cam = scene.synthetic_scene(args.n, args.w, args.h, 1.0, device)
    w, h = cam.width, cam.height
    proj, aux = api.project_gaussians(cam, gm.means3d, gm.unnorm_rotations, gm.logit_opacities,
                                      gm.log_scales, gm.active)
    b = binning.build_bins(proj, aux, w, h, far=cam.far)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d],
                      1).contiguous()
    g = torch.ones((composite.CH + 1, h, w), device=device)

    def k1():
        return composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h)

    state = k1()

    def k2():
        return composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, state, g)

    dattrs = k2()

    def k3():
        return composite.segment_reduce(dattrs, b.dst, b.offsets, b.counts)

    k3()
    torch.cuda.synchronize()
    windows = [("K1 x10, the process's first profile", k1, 10, 0.0),
               ("K1 x10, again", k1, 10, 0.0),
               ("K1 x100", k1, 100, 0.0),
               ("K1 x10, 20 ms host sleeps inside", k1, 10, 0.02),
               ("K2 x10", k2, 10, 0.0),
               ("K3-11 x10", k3, 10, 0.0),
               ("K3-11 x100", k3, 100, 0.0),
               ("K3-11 x10, 20 ms host sleeps inside", k3, 10, 0.02)]
    rows = []

    def report(label, busy, iters, fn):
        event = harness.time_calls(fn, device, iters, reps=1, warmup=0).event
        print(f"{label:<48s} profiler saw {busy.seen:3d} of {busy.launched:3d} launches, "
              f"device time {busy.ms:.3f} ms per call, events {event:.3f} ms per call",
              flush=True)
        rows.append((label, busy.seen, busy.launched, busy.ms, event))

    for label, fn, iters, pad_s in windows:
        report(label, harness.profile_device(_window(fn, iters, pad_s), device, per=iters),
               iters, fn)
    # As profile_iter profiles a stage (after timed calls, the outputs
    # kept), with no second try.
    for label, fn in (("K1 x10, as profile_iter's stage", k1),
                      ("K2 x10, as profile_iter's stage", k2)):
        harness.time_calls(fn, device, 10, 3, warmup=1)
        report(label, harness.device_busy(fn, device, 10, tries=1), 10, fn)
    # After 30 profiled windows of PyTorch's own kernels (the projection).
    for _ in range(30):
        harness.profile_device(lambda: api.project_gaussians(
            cam, gm.means3d, gm.unnorm_rotations, gm.logit_opacities, gm.log_scales,
            gm.active), device)
    report("K1 x10, after 30 profiled projections", harness.device_busy(k1, device, 10), 10, k1)
    # After one profiled window as long as a SLAM frame's (tens of thousands
    # of launches), then after one of autograd backward passes (their
    # kernels launch from autograd's device thread).
    acc = torch.zeros(1024, device=device)
    harness.profile_device(lambda: [acc.add_(1.0) for _ in range(50000)], device)
    report("K1 x10, after a profiled window of 50,000 launches",
           harness.device_busy(k1, device, 10), 10, k1)
    report("K3-11 x10, after the same", harness.device_busy(k3, device, 10), 10, k3)
    leaf = attrs.detach().requires_grad_(True)
    harness.profile_device(lambda: [torch.autograd.grad((leaf * 2.0).square().sum(), leaf)
                                    for _ in range(200)], device)
    report("K1 x10, after a profiled window of 200 backward passes",
           harness.device_busy(k1, device, 10), 10, k1)
    return rows


if __name__ == "__main__":
    main()
