"""Smoke run of the PyTorch/CUDA port (splatam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     no CUDA device -> exit 2;
  2. build the five CUDA kernels from csrc/ (nvcc, into build/);
  3. each kernel vs its plain PyTorch version on a small seeded scene
     (160x120, 5k Gaussians), K3 at 8 and at 11 columns, and K1/K2 on
     per-pair rows vs their per-Gaussian mode (bit for bit);
  4. path 1: the online SLAM loop in bench.py's order on the synthetic
     sequence at 1200x680, 40 tracking / 60 mapping iterations,
     rebin_every=8, window 24, keyframe_every=5, isotropic map (the fused
     kernels), with every launch count read right after the run, finite
     poses and a growing map;
  5. each kernel vs its plain version again at the main path's shapes
     (taken from the map and poses path 1 produced), with both times;
  6. one more frame of path 1 under torch.profiler (device activity only):
     its wall time, the device-busy time inside that same frame, and the
     kernels that take the device time;
  7. path 2: the same loop at rebin_every=1 (every iteration projects,
     bins and composites anew through K1 -> K2 -> K3), checked like path
     1, then one more frame profiled like phase 6;
  8. path 3: the same loop on an anisotropic map at rebin_every=8
     (pair-space world-16 tracking, generic mapping with reused
     structures), checked like path 1.
Each path's launch counts are set to 0 just before it and read just after;
the kernels the path must launch have to be > 0 from frame 1 on, and the
fused kernels must stay at 0 on paths 2 and 3 (the routing).
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
FRAMES = 4  # path 1
FRAMES_GENERIC = 3  # paths 2 and 3
HEIGHT, WIDTH = 680, 1200

# name -> (TPU kernel it replaces, CUDA source); segment_reduce11 is K3
# instantiated at the generic path's 11 columns.
KERNELS = {
    "composite_forward": (
        "splatam_tpu/render/pallas/composite_pallas.py:288",
        "splatam_tpu_torch/csrc/composite_forward.cu"),
    "composite_backward": (
        "splatam_tpu/render/pallas/composite_pallas.py:518",
        "splatam_tpu_torch/csrc/composite_backward.cu"),
    "fused_forward": (
        "splatam_tpu/render/pallas/fused_iso.py:311",
        "splatam_tpu_torch/csrc/fused_forward.cu"),
    "fused_backward": (
        "splatam_tpu/render/pallas/fused_iso.py:632",
        "splatam_tpu_torch/csrc/fused_backward.cu"),
    "segment_reduce": (
        "splatam_tpu/render/pallas/composite_pallas.py:615",
        "splatam_tpu_torch/csrc/segment_reduce.cu"),
    "segment_reduce11": (
        "splatam_tpu/render/pallas/composite_pallas.py:615",
        "splatam_tpu_torch/csrc/segment_reduce.cu"),
}
# Each output row (an image channel, a gradient column) is held to its
# plain version within TOL of that row's own largest value. Images:
# the forward kernels round like their plain versions (-fmad=false, NDC
# terms from the host), so 1e-5 leaves room only for expf/division of two
# libraries. Per-pair gradients (K5, K2): the 256 per-pixel terms are
# summed by warp shuffles instead of in pixel order, 1e-4. Per-Gaussian
# sums (K3 at 8 and 11 columns): the same few terms in another order,
# 1e-5. The same at both scenes.
TOL = {"composite_forward": 1e-5, "composite_backward": 1e-4, "fused_forward": 1e-5,
       "fused_backward": 1e-4, "segment_reduce": 1e-5, "segment_reduce11": 1e-5}
# Per path: the kernels it must launch, and those it must not.
PATH_KERNELS = {
    "path 1": (("composite_forward", "fused_forward", "fused_backward", "segment_reduce"),
               ("composite_backward", "segment_reduce11")),
    "path 2": (("composite_forward", "composite_backward", "segment_reduce11"),
               ("fused_forward", "fused_backward", "segment_reduce")),
    "path 3": (("composite_forward", "composite_backward", "segment_reduce11"),
               ("fused_forward", "fused_backward", "segment_reduce")),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(got, ref) -> tuple[float, list[float]]:
    """(max abs error, each row's max abs error over that row's max|ref|).
    Rows are the image channels of [C, H, W] and the columns of [P, k]."""
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


def launch_counts() -> dict:
    from splatam_tpu_torch.render import composite, fused_iso

    by_width = composite.segment_reduce.launches
    return {"composite_forward": composite.composite_forward.launches,
            "composite_backward": composite.composite_backward.launches,
            "fused_forward": fused_iso.fused_forward.launches,
            "fused_backward": fused_iso.fused_backward.launches,
            "segment_reduce": by_width[8], "segment_reduce11": by_width[11]}


def reset_counts() -> None:
    from splatam_tpu_torch.render import composite, fused_iso

    for fn in (composite.composite_forward, composite.composite_backward,
               fused_iso.fused_forward, fused_iso.fused_backward):
        fn.launches = 0
    composite.segment_reduce.launches = dict.fromkeys(composite.SEGMENT_WIDTHS, 0)


def kernel_cases(gm, q, t, cam, seed: int):
    """The kernels' inputs at one scene, as (name, kernel call, plain call)
    triples, plus the generic render's inputs for the per-pair mode check;
    every input comes from the port's own structure builds and renders."""
    import torch

    from splatam_tpu_torch.render import api, binning, composite, fused_iso
    from splatam_tpu_torch.slam import steps

    ps = steps.loss_pair_structure(gm, q, t, cam, with_world16=True)
    rmat = fused_iso.build_rotation(fused_iso.normalize(q)[None])[0]
    width, height, intr = fused_iso._geom_for(cam)
    pose = fused_iso.make_pose_vec(rmat, t, width, height, *intr)
    w, h = cam.width, cam.height
    state = fused_iso.fused_forward(ps.world8, pose, ps.tile_start, w, h)
    gen = torch.Generator(q.device).manual_seed(seed)
    g = torch.randn((6, h, w), device=q.device, generator=gen)
    dpair = fused_iso.fused_backward(ps.world8, pose, ps.tile_start, w, h, state, g)

    # The generic render's inputs: K1's state, seeded cotangents (the
    # silhouette's included), K2's output feeding K3 at 11 columns.
    means_cam, rots = steps.transform_to_frame(gm, q, t, False, False)
    proj, aux = api.project_gaussians(cam, means_cam, rots, gm.logit_opacities,
                                      gm.log_scales, gm.active)
    b = binning.build_bins(proj, aux, w, h)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d],
                      1).contiguous()
    gstate = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h)
    g2 = torch.randn((6, h, w), device=q.device, generator=gen)
    dgen = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, gstate, g2)
    generic = (attrs, b, gstate, g2, dgen)
    return ps.n_pairs, b.n_pairs, generic, [
        ("composite_forward",
         lambda: composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h),
         lambda: composite.composite_forward_plain(attrs, b.pair_gauss, b.tile_start, w, h)),
        ("composite_backward",
         lambda: composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, gstate,
                                              g2),
         lambda: composite.composite_backward_plain(attrs, b.pair_gauss, b.tile_start, w, h,
                                                    gstate, g2)),
        ("fused_forward",
         lambda: fused_iso.fused_forward(ps.world8, pose, ps.tile_start, w, h),
         lambda: fused_iso.fused_forward_plain(ps.world8, pose, ps.tile_start, w, h)),
        ("fused_backward",
         lambda: fused_iso.fused_backward(ps.world8, pose, ps.tile_start, w, h, state, g),
         lambda: fused_iso.fused_backward_plain(ps.world8, pose, ps.tile_start, w, h, state, g)),
        ("segment_reduce",
         lambda: composite.segment_reduce(dpair, ps.dst, ps.offsets, ps.counts),
         lambda: composite.segment_reduce_plain(dpair, ps.dst, ps.offsets, ps.counts)),
        ("segment_reduce11",
         lambda: composite.segment_reduce(dgen, b.dst, b.offsets, b.counts),
         lambda: composite.segment_reduce_plain(dgen, b.dst, b.offsets, b.counts)),
    ]


def check_pair_mode(generic, cam, label: str) -> None:
    """K1 and K2 on per-pair rows (no index) must equal their per-Gaussian
    mode bit for bit: the same kernel reads the same floats."""
    import torch

    from splatam_tpu_torch.render import composite

    attrs, b, gstate, g2, dgen = generic
    rows = attrs[b.pair_gauss.long()].contiguous()
    w, h = cam.width, cam.height
    fwd = torch.equal(composite.composite_forward(rows, None, b.tile_start, w, h), gstate)
    bwd = torch.equal(composite.composite_backward(rows, None, b.tile_start, w, h, gstate, g2),
                      dgen)
    print(f"[{label}] per-pair rows vs per-Gaussian rows: K1 equal={fwd}, K2 equal={bwd}",
          flush=True)
    if not (fwd and bwd):
        fail(f"K1/K2 per-pair mode differs from the per-Gaussian mode ({label})")


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


def bench_config(**overrides):
    """bench.py:48-78's settings for the port; overrides update a section
    (dict) or set a key."""
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
    for key, value in overrides.items():
        if isinstance(value, dict):
            config[key].update(value)
        else:
            config[key] = value
    return config


def drive_path(name: str, config: dict, frames: int, device):
    """Run `frames` frames of the online loop; launch counts are zeroed
    just before and read after every frame. Fatal checks: the path's
    kernels launched from frame 1 on, the other kernels never, finite
    poses, a growing map. Returns (runtime, launch counts)."""
    import numpy as np
    import torch

    from splatam_tpu_torch.slam.config import seed_everything
    from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame

    must, never = PATH_KERNELS[name]
    seed_everything(0)
    rt = SLAMRuntime(config, device)
    n_start = rt.gm.num_active()
    print(f"{name}: rebin_every={rt.rebin_every}, "
          f"{'isotropic' if rt.isotropic else 'anisotropic'} map, {n_start} Gaussians at start",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(frames):
        torch.cuda.synchronize()
        t0 = time.time()
        run_frame(rt, i)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = launch_counts()
        print(f"{name} frame {i}: {dt:.3f} s, n_gaussians={rt.gm.num_active()}, "
              f"launches={launches}, "
              f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if i >= 1 and min(launches[k] for k in must) == 0:
            fail(f"{name}: a kernel of the path was never launched: {launches}")
        if any(launches[k] for k in never):
            fail(f"{name}: a kernel off the path was launched: {launches}")
    launches = launch_counts()
    if not (np.isfinite(rt.cam_rots[:frames]).all() and np.isfinite(rt.cam_trans[:frames]).all()):
        fail(f"{name}: non-finite poses")
    if not rt.gm.num_active() > n_start:
        fail(f"{name}: densification added no Gaussians")
    return rt, launches


def profile_frame(rt, idx: int, label: str) -> None:
    """One more frame under torch.profiler, device activity only, so the
    profiler adds little host work; busy and wall time both from it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from splatam_tpu_torch.slam.pipeline import run_frame

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        run_frame(rt, idx)
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    if busy:
        print(f"{label} profiled frame {idx}: wall {wall:.3f} s, device busy {busy:.3f} s "
              f"({100.0 * busy / wall:.1f}% of that frame's wall)", flush=True)
    else:
        print(f"{label} profiled frame {idx}: wall {wall:.3f} s, device time not measured",
              flush=True)
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from splatam_tpu_torch.render import _cuda

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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    gm, q, t, cam = small_scene(device)
    _, _, generic, cases = kernel_cases(gm, q, t, cam, seed=1)
    label = "160x120, 5k Gaussians"
    check_cases(cases, label)
    check_pair_mode(generic, cam, label)

    launches = {}
    rt, launches["path 1"] = drive_path("path 1", bench_config(), FRAMES, device)

    # Kernel vs plain, and times, at the main path's shapes: path 1's final
    # map, its last frame's pose, the full image.
    span = rt.gm.span()
    view = type(rt.gm)(*(a[:span] for a in rt.gm))
    q_l = torch.as_tensor(rt.cam_rots[FRAMES - 1], device=device)
    t_l = torch.as_tensor(rt.cam_trans[FRAMES - 1], device=device)
    n_pairs, n_pairs_gen, generic, cases = kernel_cases(view, q_l, t_l, rt.cam, seed=2)
    print(f"main-path shapes: {span} Gaussians, {n_pairs} pairs (fused), {n_pairs_gen} pairs "
          f"(generic), {WIDTH}x{HEIGHT}", flush=True)
    label = f"{WIDTH}x{HEIGHT}, {span} Gaussians"
    errs = check_cases(cases, label)
    check_pair_mode(generic, rt.cam, label)
    times = {}
    for name, kernel, plain in cases:
        # Turns: plain, kernel, kernel, plain (one card, one call).
        p1 = time_ms(plain, 1, 1)
        k1 = time_ms(kernel, 3, 20)
        k2 = time_ms(kernel, 3, 20)
        p2 = time_ms(plain, 0, 1)
        times[name] = (min(k1, k2), min(p1, p2))
        print(f"time {name}: kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms",
              flush=True)
    del view, generic, cases
    profile_frame(rt, FRAMES, "path 1")
    del rt
    torch.cuda.empty_cache()

    rt, launches["path 2"] = drive_path("path 2", bench_config(tpu={"rebin_every": 1}),
                                        FRAMES_GENERIC, device)
    profile_frame(rt, FRAMES_GENERIC, "path 2")
    del rt
    torch.cuda.empty_cache()

    rt, launches["path 3"] = drive_path(
        "path 3", bench_config(gaussian_distribution="anisotropic"), FRAMES_GENERIC, device)
    del rt

    rows = []
    for name, (replaces, source) in KERNELS.items():
        ms, plain_ms = times[name]
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(path[name] for path in launches.values()),
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
