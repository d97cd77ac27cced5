"""Smoke run of the PyTorch/CUDA port (splatam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     no CUDA device -> exit 2;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel,
     into build/);
  3. each kernel vs its plain PyTorch version on a small seeded scene
     (160x120, 5k Gaussians), K3 at 8 and at 11 columns, K1/K2 on
     per-pair rows vs their per-Gaussian mode (bit for bit), and the five
     probe kernels of the fused forward (fwd2 equal to K4 bit for bit);
  4. path 1: the online SLAM loop in bench.py's order on the synthetic
     sequence at 1200x680, 40 tracking / 60 mapping iterations,
     rebin_every=8, window 24, keyframe_every=5, isotropic map (the fused
     kernels), with every launch count read right after the run, finite
     poses and a growing map;
  5. each kernel vs its plain version again at the main path's shapes
     (taken from the map and poses path 1 produced), with both times, K3
     beside the one PyTorch call that computes its function
     (index_add_), and every kernel's bound: the larger of its bytes over
     3.35 TB/s and its float32 operations over 67 TFLOP/s
     (splatam_tpu_torch/render/bounds.py), with its share of that bound;
  6. one more frame of path 1 under torch.profiler (device activity only):
     its wall time, the device-busy time inside that same frame, and the
     kernels that take the device time;
  7. path 2: the same loop at rebin_every=1 (every iteration projects,
     bins and composites anew through K1 -> K2 -> K3), checked like path
     1, then one more frame profiled like phase 6;
  8. path 3: the same loop on an anisotropic map at rebin_every=8
     (pair-space world-16 tracking, generic mapping with reused
     structures), checked like path 1;
  9. the probes, at opacity logits -2.0 and 1.0: one structure of the JAX
     probes' map (1,272,155 Gaussians at 1200x680) goes through the runs
     of `probe_unroll` and `probe_dma` (splatam_tpu_torch/scripts, what
     their mains do at their defaults); then on the same inputs fwd2 equal
     to K4, math_only, dma_only, dma_b2 and dma_b4 vs their plain
     versions, their times in turns beside K4's, bounds and shares;
 10. `profile_iter` in summary and --stages mode at 1200x680 with 950,272
     Gaussians (about path 1's steady map): wall, event and device-busy
     time of each stage.
A device-busy time (phases 6, 7, 10) counts only where torch.profiler
recorded every launch of the port's kernels that the wrappers counted in
its window; elsewhere it prints as unverified.
Each path's launch counts (and those of phase 9's probe run) are set to 0
just before it and read just after; the kernels the path must launch have
to be > 0 from frame 1 on, the fused kernels must stay at 0 on paths 2 and
3 (the routing), and the probe kernels at 0 on paths 1-3.
Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

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
    "fwd2": ("scripts/probe_unroll.py:237", "splatam_tpu_torch/csrc/fused_probes.cu"),
    "dma_only": ("scripts/probe_dma.py:147", "splatam_tpu_torch/csrc/fused_probes.cu"),
    "dma_b2": ("scripts/probe_dma.py:173", "splatam_tpu_torch/csrc/fused_probes.cu"),
    "dma_b4": ("scripts/probe_dma.py:173", "splatam_tpu_torch/csrc/fused_probes.cu"),
    "math_only": ("scripts/probe_dma.py:290", "splatam_tpu_torch/csrc/fused_probes.cu"),
}
PROBES = ("fwd2", "dma_only", "dma_b2", "dma_b4", "math_only")
PROBE_N = 1272155  # the probe scripts' default map
PROBE_LOGITS = (-2.0, 1.0)  # probe_unroll's default (walks to the tile's end), saturating
PROFILE_N = 950272  # scripts/profile_map_ablate.py:22, about path 1's steady map
# Each output row (an image channel, a gradient column) is held to its
# plain version within TOL of that row's own largest value. Images:
# the forward kernels round like their plain versions (-fmad=false, NDC
# terms from the host), so 1e-5 leaves room only for expf/division of two
# libraries. Per-pair gradients (K5, K2): the 256 per-pixel terms are
# summed by warp shuffles instead of in pixel order, 1e-4. Per-Gaussian
# sums (K3 at 8 and 11 columns, and index_add_ beside K3): the same few
# terms in another order, 1e-5. The probes: fwd2 must equal K4 bit for bit
# (the same arithmetic on the same pairs in the same order), and its plain
# version, math_only's and the lane sums of the dma walks (per lane, the
# same float32 sums in another order) within 1e-5. The same at every scene.
TOL = {"composite_forward": 1e-5, "composite_backward": 1e-4, "fused_forward": 1e-5,
       "fused_backward": 1e-4, "segment_reduce": 1e-5, "segment_reduce11": 1e-5,
       "fwd2": 1e-5, "dma_only": 1e-5, "dma_b2": 1e-5, "dma_b4": 1e-5, "math_only": 1e-5}
IMAGES = ("composite_forward", "fused_forward", "fwd2", "math_only")  # n_contrib exact
# Per path: the kernels it must launch, and those it must not.
PATH_KERNELS = {
    "path 1": (("composite_forward", "fused_forward", "fused_backward", "segment_reduce"),
               ("composite_backward", "segment_reduce11", *PROBES)),
    "path 2": (("composite_forward", "composite_backward", "segment_reduce11"),
               ("fused_forward", "fused_backward", "segment_reduce", *PROBES)),
    "path 3": (("composite_forward", "composite_backward", "segment_reduce11"),
               ("fused_forward", "fused_backward", "segment_reduce", *PROBES)),
    "probes": (("fused_forward", *PROBES),
               ("composite_forward", "composite_backward", "fused_backward", "segment_reduce",
                "segment_reduce11")),
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


def event_ms(fn, iters: int, warmup: int) -> float:
    """CUDA-event ms per call of fn over `iters` calls after `warmup`."""
    import torch

    from splatam_tpu_torch.scripts.harness import time_calls

    return time_calls(fn, torch.device("cuda"), iters, reps=1, warmup=warmup).event


def kernel_inputs(gm, q, t, cam, seed: int) -> SimpleNamespace:
    """Every SLAM-loop kernel's inputs at one scene, from the port's own
    structure builds and renders: the fused path's (world-8 structure, pose,
    K4's state, seeded cotangents, K5's per-pair gradients) and the generic
    render's (K1's attrs and bins, K1's state, seeded cotangents with the
    silhouette's, K2's output feeding K3 at 11 columns)."""
    import torch

    from splatam_tpu_torch.render import api, binning, composite, fused_iso
    from splatam_tpu_torch.scripts import scene
    from splatam_tpu_torch.slam import steps

    w, h = cam.width, cam.height
    ps, pose = scene.fused_inputs(gm, q, t, cam)
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
    gstate = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h)
    g2 = torch.randn((6, h, w), device=q.device, generator=gen)
    dgen = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, gstate, g2)
    return SimpleNamespace(w=w, h=h, ps=ps, pose=pose, state=state, g=g, dpair=dpair,
                           attrs=attrs, b=b, gstate=gstate, g2=g2, dgen=dgen)


def kernel_cases(x):
    """(name, kernel call, plain call) for the six SLAM-loop kernels."""
    from splatam_tpu_torch.render import composite, fused_iso

    ps, b, w, h = x.ps, x.b, x.w, x.h
    return [
        ("composite_forward",
         lambda: composite.composite_forward(x.attrs, b.pair_gauss, b.tile_start, w, h),
         lambda: composite.composite_forward_plain(x.attrs, b.pair_gauss, b.tile_start, w, h)),
        ("composite_backward",
         lambda: composite.composite_backward(x.attrs, b.pair_gauss, b.tile_start, w, h,
                                              x.gstate, x.g2),
         lambda: composite.composite_backward_plain(x.attrs, b.pair_gauss, b.tile_start, w, h,
                                                    x.gstate, x.g2)),
        ("fused_forward",
         lambda: fused_iso.fused_forward(ps.world8, x.pose, ps.tile_start, w, h),
         lambda: fused_iso.fused_forward_plain(ps.world8, x.pose, ps.tile_start, w, h)),
        ("fused_backward",
         lambda: fused_iso.fused_backward(ps.world8, x.pose, ps.tile_start, w, h, x.state, x.g),
         lambda: fused_iso.fused_backward_plain(ps.world8, x.pose, ps.tile_start, w, h,
                                                x.state, x.g)),
        ("segment_reduce",
         lambda: composite.segment_reduce(x.dpair, ps.dst, ps.offsets, ps.counts),
         lambda: composite.segment_reduce_plain(x.dpair, ps.dst, ps.offsets, ps.counts)),
        ("segment_reduce11",
         lambda: composite.segment_reduce(x.dgen, b.dst, b.offsets, b.counts),
         lambda: composite.segment_reduce_plain(x.dgen, b.dst, b.offsets, b.counts)),
    ]


def probe_cases(ps, pose, w: int, h: int):
    """(name, kernel call, plain call) for the five probe kernels."""
    from splatam_tpu_torch.render import probes

    w8, ts = ps.world8, ps.tile_start
    cases = [("fwd2", lambda: probes.fwd2(w8, pose, ts, w, h),
              lambda: probes.fwd2_plain(w8, pose, ts, w, h))]
    for name, blocks in (("dma_only", 1), ("dma_b2", 2), ("dma_b4", 4)):
        cases.append((name, lambda b=blocks: probes.dma_walk(w8, ts, b),
                      lambda b=blocks: probes.dma_walk_plain(w8, ts, b)))
    cases.append(("math_only", lambda: probes.math_only(w8, pose, ts, w, h),
                  lambda: probes.math_only_plain(w8, pose, ts, w, h)))
    return cases


def check_pair_mode(x, label: str) -> None:
    """K1 and K2 on per-pair rows (no index) must equal their per-Gaussian
    mode bit for bit: the same kernel reads the same floats."""
    import torch

    from splatam_tpu_torch.render import composite

    rows = x.attrs[x.b.pair_gauss.long()].contiguous()
    ts, w, h = x.b.tile_start, x.w, x.h
    fwd = torch.equal(composite.composite_forward(rows, None, ts, w, h), x.gstate)
    bwd = torch.equal(composite.composite_backward(rows, None, ts, w, h, x.gstate, x.g2),
                      x.dgen)
    print(f"[{label}] per-pair rows vs per-Gaussian rows: K1 equal={fwd}, K2 equal={bwd}",
          flush=True)
    if not (fwd and bwd):
        fail(f"K1/K2 per-pair mode differs from the per-Gaussian mode ({label})")


def check_cases(cases, label: str, equal_to: dict | None = None) -> dict:
    """Hold each kernel to its plain version; returns max abs errors.

    The images' n_contrib row (an index) must match exactly: one flipped
    alpha < 1/255 or T < 1e-4 decision would also move the pixel's colour
    by a whole pair's contribution, far past the image tolerance. A kernel
    named in `equal_to` must also equal that call's output bit for bit."""
    import torch

    errs = {}
    for name, kernel, plain in cases:
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        ok = bool(torch.isfinite(got).all())
        extra = ""
        if equal_to and name in equal_to:
            same = torch.equal(got, equal_to[name]())
            ok = ok and same
            extra += f" equal_to_K4={same}"
        if name in IMAGES:
            moved = int((got[-1] != ref[-1]).sum())
            ok = ok and moved == 0
            extra += f" n_contrib_moved={moved}"
            got, ref = got[:-1], ref[:-1]
        err, rels = rel_err(got, ref)
        ok = ok and max(rels) <= TOL[name]
        print(f"[{label}] {name}: max_abs_err={err:.3e} worst_row_rel={max(rels):.1e} "
              f"tol={TOL[name]:.0e}{extra} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version ({label})")
        errs[name] = err
    return errs


def time_turns(cases) -> dict:
    """Kernel and plain ms of each case, in turns plain, kernel, kernel,
    plain (one card, one call); the smaller of each pair. The plain calls
    are warm from the checks and timed once each; a case whose plain call
    is None times only its kernel."""
    times = {}
    for name, kernel, plain in cases:
        p1 = event_ms(plain, 1, 0) if plain else None
        k1, k2 = event_ms(kernel, 20, 3), event_ms(kernel, 20, 3)
        p2 = event_ms(plain, 1, 0) if plain else None
        times[name] = (min(k1, k2), min(p1, p2) if plain else None)
        plain_s = f", plain {p1:.3f} / {p2:.3f} ms" if plain else ""
        print(f"time {name}: kernel {k1:.3f} / {k2:.3f} ms{plain_s}", flush=True)
    return times


def library_k3(x) -> dict:
    """K3 beside the one PyTorch call that computes its function,
    torch.zeros(n, k).index_add_(0, pair_to_gauss, dpair): its sums within
    K3's 1e-5 per column, and its time (ms) at both widths."""
    import torch

    from splatam_tpu_torch.render import composite

    out = {}
    for name, dpair, s in (("segment_reduce", x.dpair, x.ps), ("segment_reduce11", x.dgen, x.b)):
        idx, n = s.pair_gauss.long(), s.counts.shape[0]

        def call(dpair=dpair, idx=idx, n=n):
            return torch.zeros((n, dpair.shape[1]), device=dpair.device).index_add_(0, idx, dpair)

        err, rels = rel_err(call(), composite.segment_reduce(dpair, s.dst, s.offsets, s.counts))
        ms = min(event_ms(call, 20, 3), event_ms(call, 20, 3))
        ok = max(rels) <= TOL[name]
        print(f"library {name}: index_add_ {ms:.3f} ms, vs K3 max_abs_err={err:.3e} "
              f"worst_col_rel={max(rels):.1e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"index_add_ disagrees with {name}")
        out[name] = ms
    return out


def kernel_work(x) -> dict:
    """(bytes, float32 ops) of each SLAM-loop kernel on these inputs: each
    input read once, each output written once (the backward kernels read
    two rows of the forward's state); the walks' evaluations counted by the
    plain walk (render/bounds.py). K5 needs each staged pair's projection
    and its chain to world once (the kernel projects twice: counted once)."""
    from splatam_tpu_torch.render import bounds as B
    from splatam_tpu_torch.render import fused_iso

    ps, b = x.ps, x.b
    a = x.attrs[b.pair_gauss.long()]
    gen = B.walk_counts(a[:, 0:2], a[:, 2:5], a[:, 5], b.tile_start, x.w, x.h)
    xy, conic, op, _ = fused_iso.project_pairs_plain(ps.world8, x.pose, x.w, x.h)
    fus = B.walk_counts(xy, conic, op, ps.tile_start, x.w, x.h)
    print(f"walk counts: generic {gen}\nwalk counts: fused {fus}", flush=True)

    def k3(dpair, s):
        return (B.nbytes(dpair, s.dst, s.offsets, s.counts) + s.counts.numel() * dpair.shape[1] * 4,
                dpair.numel())

    return {
        "composite_forward": (B.nbytes(x.attrs, b.pair_gauss, b.tile_start, x.gstate),
                              B.forward_walk_ops(gen)),
        "composite_backward": (B.nbytes(x.attrs, b.pair_gauss, b.tile_start, x.g2, x.dgen)
                               + B.image_rows_bytes(x.gstate, 2),
                               B.backward_walk_ops(gen)),
        "fused_forward": (B.nbytes(ps.world8, x.pose, ps.tile_start, x.state),
                          B.forward_walk_ops(fus) + B.PROJ_OPS * fus.reach),
        "fused_backward": (B.nbytes(ps.world8, x.pose, ps.tile_start, x.g, x.dpair)
                           + B.image_rows_bytes(x.state, 2),
                           B.backward_walk_ops(fus)
                           + (B.PROJ_OPS + B.CHAIN_OPS) * fus.bwd_reach),
        "segment_reduce": k3(x.dpair, ps),
        "segment_reduce11": k3(x.dgen, b),
    }


def probe_work(ps, pose, w: int, h: int) -> dict:
    """(bytes, float32 ops) of K4 and the five probes on one structure. The
    dma walks are defined by the rows they stage: every pair's 32-byte row;
    they add column 0 of every row (dma_only) or of the first 128 rows of
    each 256 or 512 (dma_b2, dma_b4). math_only reads each tile's first
    min(num, 128) rows and walks them as K4 walks the remapped rows."""
    from splatam_tpu_torch.render import bounds as B
    from splatam_tpu_torch.render import fused_iso, probes

    ts = ps.tile_start
    xy, conic, op, _ = fused_iso.project_pairs_plain(ps.world8, pose, w, h)
    full = B.walk_counts(xy, conic, op, ts, w, h)
    rows = probes.first_chunk_rows(ts, ps.n_pairs)
    first = B.walk_counts(xy[rows], conic[rows], op[rows], ts, w, h)
    print(f"walk counts: probe map {full}\nwalk counts: math_only {first}", flush=True)
    image = (fused_iso.CH + 2) * h * w * 4
    lens = ts[1:] - ts[:-1]
    staged = int(lens.clamp(max=probes.C).sum())
    _, pos = probes.pair_positions(ts, ps.n_pairs)
    walk_bytes = B.nbytes(ps.world8, ts) + lens.numel() * probes.C * 4
    k4 = (B.nbytes(ps.world8, pose, ts) + image, B.forward_walk_ops(full) + B.PROJ_OPS * full.reach)
    work = {"fused_forward": k4, "fwd2": k4,
            "math_only": (staged * 32 + B.nbytes(pose, ts) + image,
                          B.forward_walk_ops(first) + B.PROJ_OPS * staged)}
    for name, blocks in (("dma_only", 1), ("dma_b2", 2), ("dma_b4", 4)):
        work[name] = (walk_bytes, int((pos % (blocks * probes.C) < probes.C).sum()))
    return work


def report_bounds(work: dict, times: dict, label: str) -> dict:
    """Each kernel's bound (ms), what sets it, and its share of the bound."""
    from splatam_tpu_torch.render import bounds as B

    out = {}
    for name, (n_bytes, ops) in work.items():
        bound, by = B.roofline(n_bytes, ops)
        ms = times[name][0]
        out[name] = (bound, by, bound / ms)
        print(f"[{label}] bound {name}: {n_bytes / 1e6:.2f} MB, {ops / 1e9:.3f} G ops -> "
              f"{bound:.4f} ms ({by}); kernel {ms:.3f} ms, share {100 * bound / ms:.1f}%",
              flush=True)
    return out


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

    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts

    must, never = PATH_KERNELS[name]
    seed_everything(0)
    rt = SLAMRuntime(config, device)
    n_start = rt.gm.num_active()
    print(f"{name}: rebin_every={rt.rebin_every}, "
          f"{'isotropic' if rt.isotropic else 'anisotropic'} map, {n_start} Gaussians at start",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
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


def profile_frame(rt, idx: int, label: str, device) -> None:
    """One more frame under torch.profiler, device activity only, so the
    profiler adds little host work; busy and wall time both from it. The
    busy time counts only if the profiler recorded every launch of the
    port's kernels in the frame (harness.profile_device)."""
    import torch

    from splatam_tpu_torch.scripts.harness import fmt_busy, profile_device
    from splatam_tpu_torch.slam.pipeline import run_frame

    wall = []

    def frame():
        t0 = time.time()
        run_frame(rt, idx)
        torch.cuda.synchronize(device)
        wall.append(time.time() - t0)

    busy = profile_device(frame, device)
    share = f", {100.0 * busy.ms / 1e3 / wall[0]:.1f}% of its wall" if busy.verified else ""
    print(f"{label} profiled frame {idx}: wall {wall[0]:.3f} s, device busy "
          f"{fmt_busy(busy)}{share}", flush=True)
    for e in busy.events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def run_probes(device):
    """Phase 9, at each opacity logit on one probe-map structure: the probe
    path (probe_unroll's and probe_dma's runs, as their mains at their
    defaults run them), launch counts zeroed just before and read just
    after; then each probe against its plain version (fwd2 also equal to
    K4), the times in turns beside K4's, and the bounds. Returns (launches
    summed over both logits, errors, times, bounds), the latter three of
    logit -2.0 (probe_unroll's default)."""
    import torch

    from splatam_tpu_torch.render import fused_iso
    from splatam_tpu_torch.scripts import probe_dma, probe_unroll, scene
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts

    must, never = PATH_KERNELS["probes"]
    launches, kept = {}, None
    for logit in PROBE_LOGITS:
        gm, q, t, cam = scene.synthetic_scene(PROBE_N, WIDTH, HEIGHT, logit, device)
        ps, pose = scene.fused_inputs(gm, q, t, cam)
        del gm
        note = f"opacity_logit={logit}"
        reset_launch_counts()
        probe_unroll.run(ps, pose, WIDTH, HEIGHT, device, note=note)
        probe_dma.run(ps, pose, WIDTH, HEIGHT, device, note=note)
        for name, n in launch_counts().items():
            launches[name] = launches.get(name, 0) + n

        label = f"probe map, {PROBE_N} Gaussians, {ps.n_pairs} pairs, logit {logit}"

        def k4(ps=ps, pose=pose):
            return fused_iso.fused_forward(ps.world8, pose, ps.tile_start, WIDTH, HEIGHT)

        cases = probe_cases(ps, pose, WIDTH, HEIGHT)
        errs = check_cases(cases, label, equal_to={"fwd2": k4})
        times = time_turns([("fused_forward", k4, None), *cases])
        bounds = report_bounds(probe_work(ps, pose, WIDTH, HEIGHT), times, label)
        for name in PROBES:
            print(f"[{label}] {name} / K4 time: {times[name][0] / times['fused_forward'][0]:.3f}",
                  flush=True)
        if kept is None:
            kept = errs, times, bounds
        del ps, pose, cases
        torch.cuda.empty_cache()
    print(f"probes: launches={launches}", flush=True)
    if min(launches[k] for k in must) == 0:
        fail(f"probes: a probe kernel was never launched: {launches}")
    if any(launches[k] for k in never):
        fail(f"probes: a kernel off the probe path was launched: {launches}")
    return launches, *kept


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        sys.exit(2)
    t_start = time.time()
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

    from splatam_tpu_torch.render import fused_iso

    gm, q, t, cam = small_scene(device)
    x = kernel_inputs(gm, q, t, cam, seed=1)
    label = "160x120, 5k Gaussians"
    check_cases(kernel_cases(x), label)
    check_pair_mode(x, label)
    check_cases(probe_cases(x.ps, x.pose, x.w, x.h), label, equal_to={
        "fwd2": lambda: fused_iso.fused_forward(x.ps.world8, x.pose, x.ps.tile_start, x.w, x.h)})

    launches = {}
    rt, launches["path 1"] = drive_path("path 1", bench_config(), FRAMES, device)

    # Kernel vs plain, times and bounds at the main path's shapes: path 1's
    # final map, its last frame's pose, the full image.
    span = rt.gm.span()
    view = type(rt.gm)(*(a[:span] for a in rt.gm))
    q_l = torch.as_tensor(rt.cam_rots[FRAMES - 1], device=device)
    t_l = torch.as_tensor(rt.cam_trans[FRAMES - 1], device=device)
    x = kernel_inputs(view, q_l, t_l, rt.cam, seed=2)
    print(f"main-path shapes: {span} Gaussians, {x.ps.n_pairs} pairs (fused), {x.b.n_pairs} "
          f"pairs (generic), {WIDTH}x{HEIGHT}", flush=True)
    label = f"{WIDTH}x{HEIGHT}, {span} Gaussians"
    cases = kernel_cases(x)
    errs = check_cases(cases, label)
    check_pair_mode(x, label)
    times = time_turns(cases)
    library = library_k3(x)
    bounds = report_bounds(kernel_work(x), times, label)
    del view, x, cases
    profile_frame(rt, FRAMES, "path 1", device)
    del rt
    torch.cuda.empty_cache()

    rt, launches["path 2"] = drive_path("path 2", bench_config(tpu={"rebin_every": 1}),
                                        FRAMES_GENERIC, device)
    profile_frame(rt, FRAMES_GENERIC, "path 2", device)
    del rt
    torch.cuda.empty_cache()

    rt, launches["path 3"] = drive_path(
        "path 3", bench_config(gaussian_distribution="anisotropic"), FRAMES_GENERIC, device)
    del rt
    torch.cuda.empty_cache()

    # The probes' rows come from the probe map; K4 keeps its main-path row.
    probe_launches, *probe_rows = run_probes(device)
    for table, probe_table in zip((errs, times, bounds), probe_rows):
        table.update({name: probe_table[name] for name in PROBES})
    torch.cuda.empty_cache()

    from splatam_tpu_torch.scripts import profile_iter

    for mode in ([], ["--stages"]):
        profile_iter.main(["--n", str(PROFILE_N), "--h", str(HEIGHT), "--w", str(WIDTH), *mode])

    rows = []
    for name, (replaces, source) in KERNELS.items():
        ms, plain_ms = times[name]
        bound, by, share = bounds[name]
        n = probe_launches[name] if name in PROBES else sum(p[name] for p in launches.values())
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": n, "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "share": share,
                     "library_ms": library.get(name)})
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
