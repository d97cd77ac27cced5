"""Smoke run of the PyTorch/CUDA port (splatam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     no CUDA device -> exit 2;
  2. build the four CUDA kernels from csrc/ (nvcc, into build/);
  3. each kernel vs its plain PyTorch version on a small seeded scene
     (160x120, 5k Gaussians);
  4. the main path at full size: the online SLAM loop in bench.py's order
     on the synthetic sequence at 1200x680, 40 tracking / 60 mapping
     iterations, rebin_every=8, window 24, keyframe_every=5, for 4 frames,
     with every kernel's launch count read right after the run (each must
     be > 0), finite poses and a growing map;
  5. each kernel vs its plain version again at the main path's shapes
     (taken from the map and poses the run produced), with both times;
  6. one more frame under torch.profiler (device activity only): its wall
     time, the device-busy time inside that same frame, and the kernels
     that take the device time.
Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FRAMES = 4
HEIGHT, WIDTH = 680, 1200

# name -> (TPU kernel it replaces, CUDA source)
KERNELS = {
    "composite_forward": (
        "splatam_tpu/render/pallas/composite_pallas.py:288",
        "splatam_tpu_torch/csrc/composite_forward.cu"),
    "fused_forward": (
        "splatam_tpu/render/pallas/fused_iso.py:311",
        "splatam_tpu_torch/csrc/fused_forward.cu"),
    "fused_backward": (
        "splatam_tpu/render/pallas/fused_iso.py:632",
        "splatam_tpu_torch/csrc/fused_backward.cu"),
    "segment_reduce": (
        "splatam_tpu/render/pallas/composite_pallas.py:615",
        "splatam_tpu_torch/csrc/segment_reduce.cu"),
}
# Each output row (an image channel, a gradient column) is held to its
# plain version within TOL of that row's own largest value. Images:
# the forward kernels round like their plain versions (-fmad=false, NDC
# terms from the host), so 1e-5 leaves room only for expf/division of two
# libraries. Per-pair gradients: the 256 per-pixel terms are summed by
# warp shuffles instead of in pixel order, 1e-4. Per-Gaussian sums: the
# same few terms in another order, 1e-5. The same at both scenes.
TOL = {"composite_forward": 1e-5, "fused_forward": 1e-5,
       "fused_backward": 1e-4, "segment_reduce": 1e-5}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(got, ref) -> tuple[float, list[float]]:
    """(max abs error, each row's max abs error over that row's max|ref|).
    Rows are the image channels of [C, H, W] and the columns of [P, 8]."""
    rows = (lambda x: x.reshape(x.shape[0], -1)) if got.dim() == 3 else (lambda x: x.T)
    diff, scale = rows(got - ref).abs().amax(1), rows(ref).abs().amax(1)
    return float(diff.max()), (diff / scale.clamp_min(1e-30)).tolist()


def time_ms(fn, warmup: int, iters: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(gm, q, t, cam, seed: int):
    """The four kernels' inputs at one scene, as (name, kernel call, plain
    call) triples; every input comes from the port's own structure builds."""
    import torch

    from splatam_tpu_torch.render import api, binning, composite, fused_iso
    from splatam_tpu_torch.slam import steps

    ps = steps.loss_pair_structure(gm, q, t, cam, with_world8=True)
    rmat = fused_iso.build_rotation(fused_iso.normalize(q)[None])[0]
    width, height, intr = fused_iso._geom_for(cam)
    pose = fused_iso.make_pose_vec(rmat, t, width, height, *intr)
    w, h = cam.width, cam.height
    state = fused_iso.fused_forward(ps.world8, pose, ps.tile_start, w, h)
    gen = torch.Generator(q.device).manual_seed(seed)
    g = torch.randn((6, h, w), device=q.device, generator=gen)
    dpair = fused_iso.fused_backward(ps.world8, pose, ps.tile_start, w, h, state, g)

    means_cam, rots = steps.transform_to_frame(gm, q, t, False, False)
    proj, aux = api.project_gaussians(cam, means_cam, rots, gm.logit_opacities,
                                      gm.log_scales, gm.active)
    b = binning.build_bins(proj, aux, w, h)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d],
                      1).contiguous()
    return ps.n_pairs, [
        ("composite_forward",
         lambda: composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h),
         lambda: composite.composite_forward_plain(attrs, b.pair_gauss, b.tile_start, w, h)),
        ("fused_forward",
         lambda: fused_iso.fused_forward(ps.world8, pose, ps.tile_start, w, h),
         lambda: fused_iso.fused_forward_plain(ps.world8, pose, ps.tile_start, w, h)),
        ("fused_backward",
         lambda: fused_iso.fused_backward(ps.world8, pose, ps.tile_start, w, h, state, g),
         lambda: fused_iso.fused_backward_plain(ps.world8, pose, ps.tile_start, w, h, state, g)),
        ("segment_reduce",
         lambda: composite.segment_reduce(dpair, ps.dst, ps.offsets, ps.counts),
         lambda: composite.segment_reduce_plain(dpair, ps.dst, ps.offsets, ps.counts)),
    ]


def check_cases(cases, label: str) -> dict:
    """Hold each kernel to its plain version; returns max abs errors.

    The forward kernels' n_contrib row (an index) must match exactly: one
    flipped alpha < 1/255 or T < 1e-4 decision would also move the pixel's
    colour by a whole pair's contribution, far past the image tolerance."""
    import torch

    errs = {}
    for name, kernel, plain in cases:
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        ok = bool(torch.isfinite(got).all())
        extra = ""
        if name in ("composite_forward", "fused_forward"):
            moved = int((got[-1] != ref[-1]).sum())
            ok = ok and moved == 0
            extra = f" n_contrib_moved={moved}"
            got, ref = got[:-1], ref[:-1]
        err, rels = rel_err(got, ref)
        ok = ok and max(rels) <= TOL[name]
        print(f"[{label}] {name}: max_abs_err={err:.3e} per_row_rel="
              f"[{', '.join(f'{r:.1e}' for r in rels)}] tol={TOL[name]:.0e}{extra} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version ({label})")
        errs[name] = err
    return errs


def small_scene(device):
    import numpy as np
    import torch

    from splatam_tpu_torch.core.camera import Camera
    from splatam_tpu_torch.core.gaussians import GaussianMap

    rng = np.random.default_rng(0)
    n = 5000
    f = dict(
        means3d=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                          rng.uniform(1.0, 5, n)], -1).astype(np.float32),
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
        logit_opacities=rng.normal(1.0, 0.5, n).astype(np.float32),
        log_scales=np.log(rng.uniform(0.01, 0.08, (n, 1))).astype(np.float32),
        active=rng.uniform(size=n) > 0.1,
    )
    gm = GaussianMap(**{k: torch.tensor(v, device=device) for k, v in f.items()})
    q = torch.tensor([0.99, 0.02, -0.03, 0.01], device=device)
    t = torch.tensor([0.02, -0.01, 0.03], device=device)
    return gm, q, t, Camera(height=120, width=160, fx=150.0, fy=150.0, cx=80.0, cy=60.0)


def bench_config():
    """bench.py:48-78's settings for the port."""
    from splatam_tpu_torch.slam.config import load_experiment_config

    config = load_experiment_config(os.path.join(ROOT, "configs", "synthetic", "splatam.py"))
    config["data"].update(desired_image_height=HEIGHT, desired_image_width=WIDTH,
                          num_frames=12)
    config["tracking"]["num_iters"] = 40
    config["mapping"]["num_iters"] = 60
    config["mapping_window_size"] = 24
    config["keyframe_every"] = 5
    cap = 1 << 19
    while cap < 2 * HEIGHT * WIDTH:
        cap <<= 1
    config["tpu"] = dict(capacity=cap, rebin_every=8)
    return config


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from splatam_tpu_torch.render import _cuda, composite, fused_iso
    from splatam_tpu_torch.slam.config import seed_everything
    from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.time()
    lib, secs, report = _cuda.build()
    _cuda.lib()
    print(f"build: {lib.name} in {secs:.1f} s (nvcc; {time.time() - t0:.1f} s with loading)",
          flush=True)
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    gm, q, t, cam = small_scene(device)
    _, cases = kernel_cases(gm, q, t, cam, seed=1)
    check_cases(cases, "160x120, 5k Gaussians")

    counters = (composite.composite_forward, fused_iso.fused_forward,
                fused_iso.fused_backward, composite.segment_reduce)
    seed_everything(0)
    rt = SLAMRuntime(bench_config(), device)
    n_start = rt.gm.num_active()
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for i in range(FRAMES):
        torch.cuda.synchronize()
        t0 = time.time()
        run_frame(rt, i)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        print(f"frame {i}: {dt:.3f} s, n_gaussians={rt.gm.num_active()}, launches={launches}, "
              f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if i >= 1 and min(launches.values()) == 0:
            fail(f"a kernel of the main path was never launched: {launches}")
    launches = {fn.__name__: fn.launches for fn in counters}
    if not (np.isfinite(rt.cam_rots[:FRAMES]).all() and np.isfinite(rt.cam_trans[:FRAMES]).all()):
        fail("non-finite poses")
    if not rt.gm.num_active() > n_start:
        fail("densification added no Gaussians")

    # Kernel vs plain, and times, at the main path's shapes: the final map,
    # the last frame's pose, the full image.
    span = rt.gm.span()
    view = type(rt.gm)(*(a[:span] for a in rt.gm))
    q_l = torch.as_tensor(rt.cam_rots[FRAMES - 1], device=device)
    t_l = torch.as_tensor(rt.cam_trans[FRAMES - 1], device=device)
    n_pairs, cases = kernel_cases(view, q_l, t_l, rt.cam, seed=2)
    print(f"main-path shapes: {span} Gaussians, {n_pairs} pairs, {WIDTH}x{HEIGHT}", flush=True)
    errs = check_cases(cases, f"{WIDTH}x{HEIGHT}, {span} Gaussians")
    rows = []
    for name, kernel, plain in cases:
        # Turns: plain, kernel, kernel, plain (one card, one call).
        p1 = time_ms(plain, 1, 1)
        k1 = time_ms(kernel, 3, 20)
        k2 = time_ms(kernel, 3, 20)
        p2 = time_ms(plain, 0, 1)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        print(f"time {name}: kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms",
              flush=True)
        replaces, source = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms})

    # Where one more frame's time goes. Device activity only, so the
    # profiler adds little host work; busy time and wall time are both
    # read from this one frame.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        run_frame(rt, FRAMES)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy:
        print(f"profiled frame {FRAMES}: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"({100.0 * busy / wall:.1f}% of that frame's wall)", flush=True)
    else:
        print(f"profiled frame {FRAMES}: wall {wall:.3f} s, device time not measured",
              flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
