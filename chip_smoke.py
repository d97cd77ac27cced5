"""Smoke run of the PyTorch/CUDA port (splatam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     no CUDA device -> exit 2;
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel,
     into build/);
  3. each kernel vs its plain PyTorch version on a small seeded scene
     (160x120, 5k Gaussians), K3 at 8 and at 11 columns, K1/K2 on
     per-pair rows vs their per-Gaussian mode and K4/K5 on per-Gaussian
     rows read through pair_gauss vs their per-pair mode (bit for bit), K1
     and K4 equal to their plain versions bit for bit, K2, K3 and K5 equal
     bit for bit across two launches, the (pair, warp) steps K4's walk
     needs, its cull keeps and a walk with no cull visits, and the five
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
     K1 and K4 equal to their plain versions bit for bit, K2, K3 and K5
     equal bit for bit across two launches, both input modes of K1/K2 and
     of K4/K5 equal bit for bit, K4's and K5's times in their per-Gaussian
     mode beside the per-pair one, the registers, local (spill) bytes and
     blocks per SM of K1, K2, K3, K4 and K5, the histogram of pairs per
     Gaussian K3 reduces, the (pair, warp) steps K5 reduces with the
     shuffles they take, and for K1, K2 and K4 the (pair, warp) steps their
     walks need, those their cull keeps and those a walk with no cull
     visits; then get_loss's loss kernel (csrc/loss.cu) on a render of
     path 1's final map against its last frame, as a tracking and as a
     mapping call: against its plain version (the loss within 1e-5, each
     gradient plane within 1e-5 of its largest value), twice bit for bit,
     timed beside its plain version and the PyTorch composition it
     replaces (forward and backward), with the memory each holds between
     them, its registers and its bound;
  6. one more frame of path 1 under torch.profiler (device activity only):
     its wall time, the device-busy time inside that same frame, and the
     kernels that take the device time;
  7. path 2: the same loop at rebin_every=1 (every iteration projects,
     bins and composites anew through K1 -> K2 -> K3), checked like path
     1, then one more frame profiled like phase 6;
  8. path 3: the same loop on an anisotropic map at rebin_every=8
     (pair-space world-16 tracking, generic mapping with reused
     structures), checked like path 1; then K1 and K2 on that map's
     per-pair rows at the last pose (the inputs this path gives them)
     against their plain versions, K2 twice, with their times, bounds and
     the cull's step counts, and once more with ill-conditioned,
     indefinite and transparent rows mixed in (the cull's other branches);
  9. the probes, at opacity logits -2.0 and 1.0: one structure of the JAX
     probes' map (1,272,155 Gaussians at 1200x680) goes through the runs
     of `probe_unroll` and `probe_dma` (splatam_tpu_torch/scripts, what
     their mains do at their defaults); then on the same inputs fwd2 equal
     to K4, math_only, dma_only, dma_b2 and dma_b4 vs their plain
     versions, their times in turns beside K4's, bounds and shares;
 10. `profile_iter` in summary and --stages mode at 1200x680 with 950,272
     Gaussians (about path 1's steady map): wall, event and device-busy
     time of each stage;
 11. path 4: the full online entry point, `rgbd_slam`, on path 1's
     configuration for 7 frames with a checkpoint every 3 frames and
     tracking.visualize_tracking_loss on, in a temporary directory: (a) the
     run (K1, K4, K5 and K3 at 8 columns launched, K2, K3 at 11 and the
     probes not; K1 exactly PATH4_K1 times, one of them the panel of each
     tracked frame; one panel PNG per tracked frame, read back by read_png
     at its size; finite poses; params.npz,
     params3.npz, params6.npz and keyframe_time_indices3.npy with the JAX
     package's keys; keyframes 0, 4 and 5, the last the num_frames - 2 one;
     finite PSNR, MS-SSIM, LPIPS, depth and ATE); (b) `eval_sequence` again
     on the saved params.npz (K1 alone launched), whose metrics must equal
     (a)'s bit for bit, then one frame's eval split into render, MS-SSIM and
     LPIPS times; (c) a resume from checkpoint 3 to the end (finite poses);
     (d) `export_ply` and `load_ply` give back the saved arrays;
 12. paths 5-7, the repo's real-dataset configs as written, each in a
     temporary working directory holding a `configs` link to the repo's
     and a `data/` tree of the synthetic scene rendered through the dataset
     YAML's camera and written with `write_png` (data/export.py):
     path 5, `configs/replica_v2/splatam.py` at 1200x680 on a Replica-V2
     tree (6 train frames, 3 held out), run as `python -m
     splatam_tpu_torch.scripts.splatam` in a subprocess (its main() with the
     kernels' launch counts read at the end of that process), then
     `...scripts.eval_novel_view configs/replica_v2/eval_novel_view.py` on
     its params.npz (the NVS split, K1 alone); the loader's host time per
     frame and the image reader it uses; path 6, `configs/tum/splatam.py`
     at 640x480 on a TUM freiburg1_desk tree (3 frames, timestamp files,
     depth and ground truth on stamps of their own) the same way, and
     read_png's time on a Paeth-filtered 640x480 16-bit depth image; path
     7a, `configs/replica/splatam_s.py` pointed at path 5's tree (tracking
     at 1200x680, densification at 600x340), 6 frames of `run_frame`; 7b,
     `configs/replica_v2/splatam.py` with coarse-to-fine tracking (levels
     [[4, 10], [2, 10]], pooled), 4 frames: finite poses, K1, K2 and K3 at
     11 columns launched and no other kernel, the K2 launches per frame the
     config's iterations imply, finite quality metrics;
 13. paths 8-10, the 3DGS training programs: path 8,
     `configs/replica/gaussian_splatting.py` as written (init 300x170,
     mapping 600x340, anisotropic, its densify_dict) on path 5's tree
     through `python -m splatam_tpu_torch.scripts.gaussian_splatting`, cut
     to 1,200 iterations with its intermediate eval at 1,000; path 9,
     `configs/replica/post_splatam_opt.py` as written on path 5's tree and
     params.npz, cut to 700 iterations: K1, K2 and K3-11 launched and no
     other kernel, K2 once per training iteration, a densify pass that
     cloned or split, eval_1k/ (path 8) and eval/ written, finite quality,
     params.npz with [N, 3] log-scales (path 8; path 9 keeps the
     checkpoint's, isotropic), path 9's poses equal to the checkpoint's bit
     for bit; path 10, path 1's configuration with
     in-loop 3DGS (`mapping.use_gaussian_splatting_densification`), 4
     frames: K4 and K5 (tracking) and K1, K2 and K3-11 (mapping on the
     generic render, K2 once per mapping iteration), K3-8 never. Each prints
     its wall time, ms per training iteration and peak memory. After path
     9, path 5's own params.npz evaluated at path 9's settings (frame 0 at
     600x340) beside path 9's metrics. Then, in
     this process, K1, K2 and K3-11 on the inputs each trained map gives
     them (paths 8 and 9: params.npz at its 600x340 mapping camera and last
     pose; path 10: the final map at its last pose, with K4, K5 and K3-8
     too) against their plain versions as in phase 5 (K1 bit for bit) and
     twice each where the sums have a fixed order;
 14. path 11, the generic render of any channels (render_gaussians,
     backend "auto") on path 1's final map at its last pose, 1200x680,
     forward and backward with a seeded cotangent on every output row:
     colours [N, 3] (kernel ch 3, the reference's RGB pass), [z, 1, z^2]
     as colours (ch 3, its depth/silhouette pass), [N, 1] (ch 1), [N, 8]
     with depth appended (ch 10), [N, 3] with depth (ch 5, equal to
     render_rgbd_sil bit for bit) and [N, c] for c = 2, 4, 6, 7, 8, 9;
     each case launches K1 and K2 at its channel count and K3 at 6 + that
     count once each and nothing else. Then on each case's inputs K1 (bit
     for bit), K2 and K3 against their plain versions, K2 and K3 twice,
     and each width instance's time, plain time, bound and (K3)
     index_add_'s time; then at 160x120 on an anisotropic map of 2,000
     Gaussians the kernels against the naive and tiles backends on the
     card (ch 3 and 10: images within 1e-4, gradients within 5e-5 of their
     largest), the naive backend once in its exact-depth order and once in
     the kernels' quantized-depth order;
 15. path 12, the viewers: `python -m splatam_tpu_torch.scripts.final_recon`
     and `...online_recon` in processes of their own on path 4's run
     directory (configs/synthetic/splatam.py's viz section, 600x340): 24
     orbit views through 24 K1 launches, one replay frame per frame, and
     view 0 decoded with read_png equal to render_view's uint8 here;
 16. path 13, the micro-gauntlets as gates (scripts/gauntlet.py MICRO,
     through its run_variant: clean, 30 frames at 160x120, ATE < 3.3 cm and
     PSNR >= 35 dB; scan, 39 frames at motion_scale 1.0, < 1.8 cm and >= 37
     dB; rebin 8, 60/60 iterations): path 1's routing, a breached floor
     fails; then K1, K4, K5 and K3-8 on the clean run's final map at
     160x120 against their plain versions;
 17. path 14, the live iPhone path: configs/iphone/online_demo.py as written
     (1920x1440 samples, downscale 2 -> 960x720, 10 frames, 60/60
     iterations, window 32, rebin 1) through `live_slam` on a replayed
     NeRFCapture stream of the synthetic scene (uint8 RGB, float32 depth
     bytes at 256x192, an OpenGL transform_matrix; an empty read and a
     sample without depth among them; ray-cast before the run): K1, K2 and
     K3-11 only, K2 once per tracking and mapping iteration; s/frame, ATE
     against the served poses, Gaussians; K1, K2 and K3-11 on its final map
     at 960x720 against their plain versions; then `dataset_capture_loop`
     on the same samples, read back by configs/iphone/splatam.py's loader
     equal to the served frames within the uint16 depth step;
 18. path 15, row bands (tpu.spatial_shards, splatam_tpu_torch/parallel):
     (a) on path 1's final map at its last pose and frame, with 2 and 4
     bands against none: get_loss for tracking on the rebin structure
     (K4/K5), for mapping on the fused render (K4/K5/K3-8) and on the
     generic render with the 3DGS harvest (K1/K2/K3-11), and densify_step;
     loss within 1e-5, radii > 0 equal, and every gradient column of the
     route's render under an L1 cotangent within 5e-5 of its largest
     value (also over the Gaussians with pairs in two bands); on
     tests/test_multichip.py's 80-row scene (the fourth band starts past
     the image and renders nothing) and on the same with its map in the
     top rows (band 1 of 2 has rows and no pair) also the silhouette within
     1e-5 at every pixel and get_loss's gradient columns within 5e-5; on
     path 1's map pairs at the alpha cutoff flip between the band's and
     the full image's rounding, so there the cotangent is zero at the
     pixels that moved, each gradient column holds 5e-5 by relative L2
     and row by row 5e-5 or twice what a one-ulp shift of the full
     image's rows moves it, no pixel's silhouette moves more than one
     flip can (SIL_FLIP) and no more pixels move than under that shift
     (parity_ok); densify_step's candidates equal but where the two
     renders differ;
     (b) K1, K2, K3, K4 and K5 on band 1 of 4's structure of path 1's map
     (cy shifted, the full frame's limits) against their plain versions,
     K1 and K4 bit for bit; (c) 3 frames of path 1's configuration with
     tpu.spatial_shards = 4 beside the same 3 frames without bands: ATE,
     PSNR and Gaussians of both, and each kernel launched 4 times as often
     as without bands (the loss kernel as often: it runs on the gathered
     image); (d) dryrun_multichip over 4 bands; (e)
     profile_sharded at --shards 1 2 4 (320x240); (f) profile_map_ablate
     (950,272 Gaussians, 1200x680), probe_saturation --frames 3 and
     exp_gather's table gathers and its tracking-gather comparison on path
     1's final map, each at reduced depth;
 19. path 16, bench.py and entry() in the port: (a) `python -m
     splatam_tpu_torch.scripts.bench` in a process of its own at its
     defaults (1200x680, 12 frames, 40/60, rebin 8, isotropic): exit 0,
     bench.py's JSON keys with `device`, finite numbers, path 1's routing
     (K4, K5, K3-8 and K1 launched, K2 not); (b) the same with
     BENCH_TILE_CULL=1: its s/frame beside (a)'s, the share of pairs culled
     per frame, n_gaussians_final within 1% of (a)'s; (c) on path 1's final
     map at its last pose, four binnings (classic, tile_cull, direct_j = 2,
     both): each structure's pairs in the binning's order (keys recomputed
     from the projection), its pairs, culled share and build time; the
     tracking render in pair space (K4/K5), mapping's fused render
     (K4/K5/K3-8) and the generic render with the 3DGS harvest
     (K1/K2/K3-11) forward and backward under one seeded cotangent, each
     variant's images and gradients against the classic's within TOL
     outside the tiles whose tied pairs the J-slot order reorders; then
     every kernel on the tile_cull and on the combined structures against
     its plain version; (d) entry() on the card: shapes, finite values, K1
     alone launched.
A device-busy time (phases 6, 7, 10) counts only where torch.profiler
recorded every launch of the port's kernels that the wrappers counted in
its window; elsewhere it prints as unverified.
Each path's launch counts (and those of phase 9's probe run, of path
4's eval and resume, and of path 5's NVS eval) are set to 0 just before it
(or start at 0 in a process of its own: paths 5 and 12, path 16's
benches) and read just after; the kernels the path must launch have
to be > 0 from frame 1 on, the fused kernels must stay at 0 on paths 2 and
3 (the routing), the probe kernels at 0 on paths 1-3, and K1, K2 and K3
at any width but the SLAM loop's at 0 on every path but path 11.
Prints the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import atexit
import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
FRAMES = 4  # path 1
FRAMES_GENERIC = 3  # paths 2 and 3
FRAMES_SLAM, CKPT_EVERY = 7, 3  # path 4: checkpoints at frames 0, 3 and 6
SLAM_KEYFRAMES = [0, 4, 5]  # keyframe_every=5, and num_frames - 2
RESUME_AT = 3
FRAMES_REPLICA, NVS_FRAMES = 6, 3  # paths 5 and 7a: the Replica-V2 tree's train and held-out frames
FRAMES_TUM = 3  # path 6
FRAMES_C2F = 4  # path 7b
FRAMES_GS_LOOP = 4  # path 10
FRAMES_BANDS, N_BANDS = 3, 4  # path 15 (c)
# Path 14: the iPhone's depth image is coarser than its colour (256x192 under
# 1920x1440 on the LiDAR phones).
PHONE_DEPTH_HW = (192, 256)
# Paths 8 and 9: the configs' only cuts, of depth (their iterations; the
# frame counts to what path 5's tree holds).
GS_ITERS, GS_EVAL_AT, POST_ITERS = 1200, [1000], 700
# Path 10: configs/synthetic/splatam.py's densify_dict, with a schedule that
# fires within the loop's 60 mapping iterations a frame (its own
# start_after=500 never would).
GS_LOOP_SCHEDULE = dict(start_after=20, densify_every=20, stop_after=60)
C2F = {"enabled": True, "levels": [[4, 10], [2, 10]], "downsample": "pool"}
# params.npz's keys (tests/test_slam_pipeline.py:58-64)
PARAM_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales",
              "cam_unnorm_rots", "cam_trans", "timestep", "intrinsics", "w2c",
              "gt_w2c_all_frames", "keyframe_time_indices")
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
    # get_loss's loss and gradient, which the JAX package leaves to XLA
    "loss_map": ("none (XLA fuses splatam_tpu/slam/steps.py get_loss)",
                 "splatam_tpu_torch/csrc/loss.cu"),
    "loss_track": ("none (XLA fuses splatam_tpu/slam/steps.py get_loss)",
                   "splatam_tpu_torch/csrc/loss.cu"),
}
# K1 and K2 at every other channel count (1-10, as the TPU kernels take: the
# SLAM loop's five are the rows above), K3 at every other width of the
# generic render's rows (6 + ch): splatam_tpu_torch/scripts/harness.py WIDE.
CHANNELS = range(1, 11)
K1_WIDE = tuple(f"composite_forward_ch{c}" for c in CHANNELS if c != 5)
K2_WIDE = tuple(f"composite_backward_ch{c}" for c in CHANNELS if c != 5)
K3_WIDE = tuple(f"segment_reduce{k}" for k in range(7, 17) if k not in (8, 11))
WIDE = K1_WIDE + K2_WIDE + K3_WIDE
for _name in WIDE:
    KERNELS[_name] = KERNELS[_name.partition("_ch")[0] if "_ch" in _name else "segment_reduce"]


def instance_name(kind: str, n: int) -> str:
    """The kernel name of K1 or K2 ("composite_forward", "composite_backward")
    at n channels, or of K3 ("segment_reduce") at n columns."""
    if kind == "segment_reduce":
        return {8: "segment_reduce", 11: "segment_reduce11"}.get(n, f"segment_reduce{n}")
    return kind if n == 5 else f"{kind}_ch{n}"


PROBES = ("fwd2", "dma_only", "dma_b2", "dma_b4", "math_only")
PROBE_N = 1272155  # the probe scripts' default map
PROBE_LOGITS = (-2.0, 1.0)  # probe_unroll's default (walks to the tile's end), saturating
PROFILE_N = 950272  # scripts/profile_map_ablate.py:22, about path 1's steady map
# Each output row (an image channel, a gradient column) is held to its
# plain version within TOL of that row's own largest value. Images:
# the forward kernels round like their plain versions (-fmad=false, NDC
# terms from the host), so 1e-5 leaves room only for expf/division of two
# libraries; K1 and K4 must equal their plain versions bit for bit besides
# (measured so on an H100 at every scene; whether the probes' images do is
# printed).
# Per-pair gradients (K5, K2): the 256 per-pixel terms are summed by warp
# shuffles (in both the reduce-scatter tree of reduce_scatter16: lanes
# halved by xor 16, 8, 4, 2, 1) and then over the warps that touched the
# pair, in warp order, instead of in pixel order, 1e-4.
# Per-Gaussian sums (K3 at 8 and 11 columns, and index_add_ beside K3): K3
# adds a Gaussian's few rows in slot order, the plain version and
# index_add_ in another order, 1e-5. The probes: fwd2 must equal K4 bit for bit
# (the same arithmetic on the same pairs in the same order), and its plain
# version, math_only's and the lane sums of the dma walks (per lane, the
# same float32 sums in another order) within 1e-5. The same at every scene.
TOL = {"composite_forward": 1e-5, "composite_backward": 1e-4, "fused_forward": 1e-5,
       "fused_backward": 1e-4, "segment_reduce": 1e-5, "segment_reduce11": 1e-5,
       "fwd2": 1e-5, "dma_only": 1e-5, "dma_b2": 1e-5, "dma_b4": 1e-5, "math_only": 1e-5}
TOL.update({n: TOL["composite_forward"] for n in K1_WIDE})
TOL.update({n: TOL["composite_backward"] for n in K2_WIDE})
TOL.update({n: TOL["segment_reduce"] for n in K3_WIDE})
IMAGES = ("composite_forward", "fused_forward", "fwd2", "math_only", *K1_WIDE)  # n_contrib exact
BIT_EQUAL_TO_PLAIN = ("composite_forward", "fused_forward", *K1_WIDE)  # every row
# Kernels whose sums have a fixed order: two launches must be equal bit for bit.
DETERMINISTIC = ("composite_backward", "fused_backward", "segment_reduce", "segment_reduce11",
                 *K2_WIDE, *K3_WIDE)
# The library entries that report what the compiler gave K1, K2, K3, K4 and K5,
# and K1, K2 and K3 at every width.
KERNEL_INFO = {"composite_forward": ("composite_forward_info", 5),
               "composite_backward": ("composite_backward_info", 5),
               "fused_forward": ("fused_forward_info",),
               "fused_backward": ("fused_backward_info",),
               "segment_reduce": ("segment_reduce_info", 8),
               "segment_reduce11": ("segment_reduce_info", 11),
               "loss_map": ("loss_info", 1), "loss_track": ("loss_info", 0),
               **{instance_name(kind, n): (f"{kind}_info", n)
                  for kind in ("composite_forward", "composite_backward") for n in CHANNELS
                  if n != 5},
               **{instance_name("segment_reduce", k): ("segment_reduce_info", k)
                  for k in range(7, 17) if k not in (8, 11)}}
# The SLAM loop's six kernels (check_trained_map's names for path 10's map).
LOOP_KERNELS = ("composite_forward", "composite_backward", "fused_forward", "fused_backward",
                "segment_reduce", "segment_reduce11")
# Per path: the kernels it must launch, and those it must not.
GENERIC = (("composite_forward", "composite_backward", "segment_reduce11"),
           ("fused_forward", "fused_backward", "segment_reduce", *PROBES))
EVAL = (("composite_forward",),
        ("composite_backward", "fused_forward", "fused_backward", "segment_reduce",
         "segment_reduce11", *PROBES))
PATH_KERNELS = {
    "path 1": (("composite_forward", "fused_forward", "fused_backward", "segment_reduce",
                "loss_track", "loss_map"), ("composite_backward", "segment_reduce11", *PROBES)),
    "path 2": GENERIC,
    "path 3": GENERIC,
    "path 4": (("composite_forward", "fused_forward", "fused_backward", "segment_reduce"),
               ("composite_backward", "segment_reduce11", *PROBES)),
    "path 4 eval": EVAL,
    # the micro-gauntlets run path 1's routing (rebin 8, isotropic) at 160x120
    "path 13 clean": (("composite_forward", "fused_forward", "fused_backward", "segment_reduce"),
                      ("composite_backward", "segment_reduce11", *PROBES)),
    "path 13 scan": (("composite_forward", "fused_forward", "fused_backward", "segment_reduce"),
                     ("composite_backward", "segment_reduce11", *PROBES)),
    # the iPhone config's generic render (rebin_every=1) every iteration
    "path 14": GENERIC,
    "path 5": GENERIC,
    "path 5 nvs": EVAL,
    "path 6": GENERIC,
    "path 7a": GENERIC,
    "path 7b": GENERIC,
    "path 8": GENERIC,
    "path 9": GENERIC,
    "path 10": (("composite_forward", "composite_backward", "segment_reduce11", "fused_forward",
                 "fused_backward"), ("segment_reduce", *PROBES)),
    "probes": (("fused_forward", *PROBES),
               ("composite_forward", "composite_backward", "fused_backward", "segment_reduce",
                "segment_reduce11")),
    # the viewers render through K1 alone (five channels: r, g, b, z, z^2)
    "path 12 final_recon": EVAL,
    "path 12 online_recon": EVAL,
    # path 15: path 1's routing with and without bands; the dryrun (generic
    # tracking at rebin 1, fused at 2; mapping with the 3DGS harvest);
    # profile_sharded (fused tracking and mapping, no densify); the
    # ablation (fused mapping, generic forward); the saturation probe (path
    # 1's loop, then one K1); the gather comparison (K4 and K5 in both modes)
    "path 15 unbanded": (("composite_forward", "fused_forward", "fused_backward",
                          "segment_reduce"), ("composite_backward", "segment_reduce11", *PROBES)),
    "path 15 bands": (("composite_forward", "fused_forward", "fused_backward", "segment_reduce"),
                      ("composite_backward", "segment_reduce11", *PROBES)),
    "path 15 dryrun": (("composite_forward", "composite_backward", "segment_reduce11",
                        "fused_forward", "fused_backward"), ("segment_reduce", *PROBES)),
    "path 15 profile_sharded": (("fused_forward", "fused_backward", "segment_reduce"),
                                ("composite_forward", "composite_backward", "segment_reduce11",
                                 *PROBES)),
    "path 15 profile_map_ablate": (("composite_forward", "fused_forward", "fused_backward",
                                    "segment_reduce"),
                                   ("composite_backward", "segment_reduce11", *PROBES)),
    "path 15 probe_saturation": (("composite_forward", "fused_forward", "fused_backward",
                                  "segment_reduce"),
                                 ("composite_backward", "segment_reduce11", *PROBES)),
    "path 15 exp_gather": (("fused_forward", "fused_backward"),
                           ("composite_forward", "composite_backward", "segment_reduce",
                            "segment_reduce11", *PROBES)),
    # path 16: the bench at its defaults is path 1's routing, with and
    # without the cull; the variants' renders run all three routes; the
    # entry check renders through K1 alone
    "path 16 bench": (("composite_forward", "fused_forward", "fused_backward", "segment_reduce"),
                      ("composite_backward", "segment_reduce11", *PROBES)),
    "path 16 bench cull": (("composite_forward", "fused_forward", "fused_backward",
                            "segment_reduce"), ("composite_backward", "segment_reduce11", *PROBES)),
    "path 16 variants": (("composite_forward", "composite_backward", "segment_reduce11",
                          "fused_forward", "fused_backward", "segment_reduce"), PROBES),
    "path 16 entry": EVAL,
}
# No path but path 11 launches K1, K2 or K3 at another width.
PATH_KERNELS = {k: (must, (*never, *WIDE)) for k, (must, never) in PATH_KERNELS.items()}
# Path 4's K1 launches, exactly: the progress report at frame 0, at each
# tracked frame densification and the tracking-loss panel (one render at the
# tracked pose), and the final eval of every frame (eval_every 1).
PATH4_K1 = 1 + 2 * (FRAMES_SLAM - 1) + FRAMES_SLAM


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


def kernel_inputs(gm, q, t, cam, seed: int, bin_opts=None) -> SimpleNamespace:
    """Every SLAM-loop kernel's inputs at one scene, from the port's own
    structure builds and renders: the fused path's (world-8 structure, the
    per-Gaussian world rows it was gathered from, pose, K4's state, seeded
    cotangents, K5's per-pair gradients) and generic_inputs'; every
    structure binned with `bin_opts` (render.binning.BinOptions; None: the
    classic binning)."""
    import torch

    from splatam_tpu_torch.render import api, fused_iso
    from splatam_tpu_torch.scripts import scene

    w, h = cam.width, cam.height
    bin_opts = bin_opts or api.CLASSIC
    ps, pose = scene.fused_inputs(gm, q, t, cam, bin_opts)
    state = fused_iso.fused_forward(ps.world8, pose, ps.tile_start, w, h)
    gen = torch.Generator(q.device).manual_seed(seed)
    g = torch.randn((6, h, w), device=q.device, generator=gen)
    dpair = fused_iso.fused_backward(ps.world8, pose, ps.tile_start, w, h, state, g)
    with torch.no_grad():
        rows8 = fused_iso.pack_world8(gm.means3d, gm.logit_opacities, gm.log_scales,
                                      gm.rgb_colors, gm.active)
    x = generic_inputs(gm, q, t, cam, gen, bin_opts)
    x.__dict__.update(ps=ps, pose=pose, state=state, g=g, dpair=dpair, rows8=rows8)
    return x


def generic_inputs(gm, q, t, cam, gen, bin_opts=None) -> SimpleNamespace:
    """The generic render's kernel inputs at one scene, isotropic or not:
    K1's attrs and bins (binned with `bin_opts`, None: classic), K1's state,
    cotangents with the silhouette's drawn from gen, K2's output feeding K3
    at 11 columns."""
    import torch

    from splatam_tpu_torch.render import api, binning, composite
    from splatam_tpu_torch.slam import steps

    w, h = cam.width, cam.height
    means_cam, rots = steps.transform_to_frame(gm, q, t, False, False)
    proj, aux = api.project_gaussians(cam, means_cam, rots, gm.logit_opacities,
                                      gm.log_scales, gm.active)
    opts = bin_opts or binning.BinOptions()
    b = binning.build_bins(proj, aux, w, h, tile_cull=opts.tile_cull, direct_j=opts.direct_j)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d],
                      1).contiguous()
    gstate = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h)
    g2 = torch.randn((6, h, w), device=q.device, generator=gen)
    dgen = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, gstate, g2)
    return SimpleNamespace(w=w, h=h, attrs=attrs, b=b, gstate=gstate, g2=g2, dgen=dgen)


def kernel_cases(x, names=None):
    """(name, kernel call, plain call) for the six SLAM-loop kernels, or
    for those in names (GENERIC[0] needs only generic_inputs)."""
    from splatam_tpu_torch.render import composite, fused_iso

    b, w, h = x.b, x.w, x.h
    ps = getattr(x, "ps", None)
    cases = [
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
    return [c for c in cases if names is None or c[0] in names]


def check_trained_map(gm, q, t, cam, label: str, names=GENERIC[0]) -> None:
    """The kernels in names on the inputs a trained map gives them at one
    pose: each against its plain version (K1 bit for bit, n_contrib exact)
    and the deterministic ones launched twice. These launches come after the
    path's counts were read."""
    import torch

    span = gm.span()
    view = type(gm)(*(a[:span] for a in gm))
    if "fused_forward" in names:
        x = kernel_inputs(view, q, t, cam, seed=4)
    else:
        x = generic_inputs(view, q, t, cam, torch.Generator(q.device).manual_seed(4))
    label = (f"{label} map, {cam.width}x{cam.height}, {span} Gaussians, {x.b.n_pairs} pairs "
             f"(generic)")
    cases = kernel_cases(x, names)
    check_cases(cases, label)
    check_repeat(cases, label)
    del x, cases, view
    torch.cuda.empty_cache()


def check_trained_params(params: dict, label: str, device, names=GENERIC[0]) -> None:
    """check_trained_map on a params.npz: its map at its mapping camera
    (org_width x org_height, its intrinsics) and its last frame's pose."""
    import numpy as np
    import torch

    from splatam_tpu_torch.core import gaussians as G
    from splatam_tpu_torch.core.camera import setup_camera

    gm = G.from_params_dict(params, device)
    cam = setup_camera(int(params["org_width"]), int(params["org_height"]),
                       np.asarray(params["intrinsics"], np.float32)[:3, :3], None)
    q = torch.as_tensor(np.asarray(params["cam_unnorm_rots"], np.float32)[0, :, -1],
                        device=device)
    t = torch.as_tensor(np.asarray(params["cam_trans"], np.float32)[0, :, -1], device=device)
    check_trained_map(gm, q, t, cam, f"{label} trained", names)


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


def indexed_cases(x):
    """(name, kernel call, None) for K4 and K5 in their per-Gaussian mode:
    mapping's inputs, the world rows read through pair_gauss."""
    from splatam_tpu_torch.render import fused_iso

    ps, w, h = x.ps, x.w, x.h
    return [
        ("fused_forward, per-Gaussian rows",
         lambda: fused_iso.fused_forward(x.rows8, x.pose, ps.tile_start, w, h, ps.pair_gauss),
         None),
        ("fused_backward, per-Gaussian rows",
         lambda: fused_iso.fused_backward(x.rows8, x.pose, ps.tile_start, w, h, x.state, x.g,
                                          ps.pair_gauss), None),
    ]


def check_fused_modes(x, label: str) -> None:
    """K4 and K5 on per-Gaussian rows read through pair_gauss must equal
    their per-pair mode bit for bit (the same kernel stages the same floats),
    and so must K4's plain version in its two modes."""
    import torch

    from splatam_tpu_torch.render import fused_iso

    ps, w, h = x.ps, x.w, x.h
    (_, k4, _), (_, k5, _) = indexed_cases(x)
    rows = torch.equal(x.rows8[ps.pair_gauss.long()], ps.world8)
    fwd, bwd = torch.equal(k4(), x.state), torch.equal(k5(), x.dpair)
    plain = torch.equal(
        fused_iso.fused_forward_plain(x.rows8, x.pose, ps.tile_start, w, h, ps.pair_gauss),
        fused_iso.fused_forward_plain(ps.world8, x.pose, ps.tile_start, w, h))
    print(f"[{label}] per-Gaussian rows vs per-pair rows: same rows={rows}, K4 equal={fwd}, "
          f"K5 equal={bwd}, K4's plain version equal={plain}", flush=True)
    if not (rows and fwd and bwd and plain):
        fail(f"K4/K5 per-Gaussian mode differs from the per-pair mode ({label})")


def check_cases(cases, label: str, equal_to: dict | None = None,
                plain_ms: dict | None = None) -> dict:
    """Hold each kernel to its plain version; returns max abs errors.

    The images' n_contrib row (an index) must match exactly: one flipped
    alpha < 1/255 or T < 1e-4 decision would also move the pixel's colour
    by a whole pair's contribution, far past the image tolerance. A kernel
    named in `equal_to` must also equal that call's output bit for bit.
    With `plain_ms`, each plain call is timed (CUDA events, ms) into it."""
    import torch

    errs = {}
    for name, kernel, plain in cases:
        got = kernel()
        torch.cuda.synchronize()
        if plain_ms is None:
            ref = plain()
        else:
            ref = None

            def timed(plain=plain):
                nonlocal ref
                ref = plain()

            plain_ms[name] = event_ms(timed, 1, 0)
        ok = bool(torch.isfinite(got).all())
        extra = ""
        if equal_to and name in equal_to:
            same = torch.equal(got, equal_to[name]())
            ok = ok and same
            extra += f" equal_to_K4={same}"
        if name in IMAGES:
            same = torch.equal(got, ref)
            ok = ok and (same or name not in BIT_EQUAL_TO_PLAIN)
            extra += f" equal_to_plain={same}"
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


def check_repeat(cases, label: str) -> None:
    """The DETERMINISTIC kernels launched twice on the same inputs must
    give results equal bit for bit."""
    import torch

    for name, kernel, _ in cases:
        if name in DETERMINISTIC:
            same = torch.equal(kernel(), kernel())
            print(f"[{label}] {name}: two launches equal={same}", flush=True)
            if not same:
                fail(f"{name} gave two different results on the same inputs ({label})")


def report_kernel_info() -> None:
    """Registers, local (spill) bytes per thread and resident blocks per SM
    of K1, K2, K3, K4 and K5, from the CUDA runtime (render/_cuda.kernel_info)."""
    from splatam_tpu_torch.render import _cuda

    for name, (entry, *args) in KERNEL_INFO.items():
        info = _cuda.kernel_info(entry, *args)
        print(f"kernel {name}: {info.registers} registers, {info.local_bytes} local bytes per "
              f"thread, {info.blocks_per_sm} blocks of its launch per SM", flush=True)


def count_histogram(counts, label: str) -> None:
    """The share of Gaussians with 0, 1, 2, 3-4, 5-32 and > 32 pairs (the
    work of K3's lane groups), and the largest count."""
    c = counts.long()
    n = max(c.numel(), 1)
    bins = (("0", c == 0), ("1", c == 1), ("2", c == 2), ("3-4", (c >= 3) & (c <= 4)),
            ("5-32", (c >= 5) & (c <= 32)), (">32", c > 32))
    shares = ", ".join(f"{k}: {100.0 * int(m.sum()) / n:.2f}%" for k, m in bins)
    print(f"pairs per Gaussian ({label}, {c.numel()} Gaussians, {int(c.sum())} pairs): "
          f"{shares}; max {int(c.max()) if c.numel() else 0}", flush=True)


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
    """K3 beside the one PyTorch call that computes its function at both
    widths of the SLAM loop (library_index_add)."""
    return {name: library_index_add(name, dpair, s)
            for name, dpair, s in (("segment_reduce", x.dpair, x.ps),
                                   ("segment_reduce11", x.dgen, x.b))}


def library_index_add(name: str, dpair, s) -> float:
    """torch.zeros(n, k).index_add_(0, pair_to_gauss, dpair), the one
    PyTorch call that computes K3's function: its sums within K3's 1e-5 per
    column, and its time (ms)."""
    import torch

    from splatam_tpu_torch.render import composite

    idx, n = s.pair_gauss.long(), s.counts.shape[0]

    def call():
        return torch.zeros((n, dpair.shape[1]), device=dpair.device).index_add_(0, idx, dpair)

    err, rels = rel_err(call(), composite.segment_reduce(dpair, s.dst, s.offsets, s.counts))
    ms = min(event_ms(call, 20, 3), event_ms(call, 20, 3))
    ok = max(rels) <= TOL[name]
    print(f"library {name}: index_add_ {ms:.3f} ms, vs K3 max_abs_err={err:.3e} "
          f"worst_col_rel={max(rels):.1e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"index_add_ disagrees with {name}")
    return ms


def report_cull(wc, label: str, forward: str = "K1", backward: str | None = "K2") -> None:
    """How tight the warp cull of a forward walk (K1, K4) and a backward walk
    (K2) is on walk counts taken at composite.WARP_W: the (pair, warp)
    steps the walk needs, those the cull keeps and those a walk with no cull
    visits. The kept counts are those of the plain rule
    (composite.cull_rows_plain at composite.WARP_W), which
    tests/test_torch_bounds.py ties to pair_reach, reach_warp_mask and
    WARP_W of csrc/common.cuh."""
    from splatam_tpu_torch.render import composite

    shape = f"{composite.WARP_W}x{32 // composite.WARP_W}"
    rows = [(forward, "hitting", wc.fwd_warp_steps, wc.fwd_kept_steps, wc.fwd_visited_steps)]
    if backward:
        rows.append((backward, "contributing", wc.bwd_warp_steps, wc.bwd_kept_steps,
                     wc.bwd_visited_steps))
    for kernel, lane, need, kept, visited in rows:
        print(f"{kernel} cull ({label}, warps of {shape} pixels): {need} (pair, warp) steps with "
              f"a {lane} lane, {kept} kept by the "
              f"cull ({kept / max(need, 1):.3f} x), {visited} with no cull "
              f"({100.0 * kept / max(visited, 1):.1f}% kept)", flush=True)


def pair_row_cases(rows, ts, w: int, h: int, label: str):
    """K1 and K2 on per-pair rows (no index): prints how the cull treats the
    rows (bounded box, whole plane, nowhere) and returns (cases as
    kernel_cases gives them, K1's state, the seeded cotangents, K2's
    output)."""
    import torch

    from splatam_tpu_torch.render import composite

    state = composite.composite_forward(rows, None, ts, w, h)
    gen = torch.Generator(rows.device).manual_seed(3)
    g = torch.randn((6, h, w), device=rows.device, generator=gen)
    dpair = composite.composite_backward(rows, None, ts, w, h, state, g)
    box = composite.cull_rows_plain(rows[:, 0:2], rows[:, 2:5], rows[:, 5], ts, w)
    plane, nowhere = torch.isinf(box[:, 1]) & (box[:, 1] > 0), box[:, 0] > box[:, 1]
    print(f"[{label}] the cull's rule: {int((~plane & ~nowhere).sum())} pairs in a bounded box, "
          f"{int(plane.sum())} the whole plane, {int(nowhere.sum())} nowhere; b != 0 in "
          f"{int((rows[:, 3] != 0).sum())}", flush=True)
    cases = [
        ("composite_forward", lambda: composite.composite_forward(rows, None, ts, w, h),
         lambda: composite.composite_forward_plain(rows, None, ts, w, h)),
        ("composite_backward",
         lambda: composite.composite_backward(rows, None, ts, w, h, state, g),
         lambda: composite.composite_backward_plain(rows, None, ts, w, h, state, g)),
    ]
    return cases, state, g, dpair


def check_aniso_pair_rows(rt, frame: int, device) -> None:
    """K1 and K2 on the inputs path 3 gives them: the anisotropic map's
    world-16 rows projected per sorted pair at the last tracked pose, full
    image, no index (conics with b != 0). Both against their plain versions
    (K1 bit for bit), K2 twice, their times, bounds and the cull's counts.
    Then the same rows with every 7th conic made ill conditioned, every 11th
    indefinite (det < 0) and every 13th opacity below 1/255, so that the
    cull's whole-plane and nowhere branches are held to the plain versions
    at full size too."""
    import torch

    from splatam_tpu_torch.render import bounds as B
    from splatam_tpu_torch.render import composite, pairspace
    from splatam_tpu_torch.slam import steps

    cam = rt.cam
    w, h = cam.width, cam.height
    span = rt.gm.span()
    view = type(rt.gm)(*(a[:span] for a in rt.gm))
    q = torch.as_tensor(rt.cam_rots[frame], device=device)
    t = torch.as_tensor(rt.cam_trans[frame], device=device)
    ps = steps.loss_pair_structure(view, q, t, cam, with_world16=True)
    with torch.no_grad():
        rows = pairspace.project_pairs(ps.world16, q, t, cam.fx, cam.fy, cam.cx, cam.cy,
                                       w, h).contiguous()
    ts = ps.tile_start
    label = f"path 3 per-pair rows, {w}x{h}, {span} Gaussians, {ps.n_pairs} pairs"
    cases, state, g, dpair = pair_row_cases(rows, ts, w, h, label)
    check_cases(cases, label)
    check_repeat(cases, label)
    times = time_turns([(name, kernel, None) for name, kernel, _ in cases])
    wc = B.walk_counts(rows[:, 0:2], rows[:, 2:5], rows[:, 5], ts, w, h,
                       warp_w=composite.WARP_W)
    print(f"walk counts: path 3 per-pair rows {wc}", flush=True)
    report_cull(wc, "path 3 per-pair rows")
    report_bounds({
        "composite_forward": (B.nbytes(rows, ts, state), B.forward_walk_ops(wc)),
        "composite_backward": (B.nbytes(rows, ts, g, dpair) + B.image_rows_bytes(state, 2),
                               B.backward_walk_ops(wc)),
    }, times, label)

    hard = rows.clone()
    i = torch.arange(hard.shape[0], device=device)
    hard[i % 7 == 0, 2] *= 3e4  # (a + c)^2 > 1e4 det
    sel = i % 11 == 0
    hard[sel, 3] = 1.5 * torch.sqrt(hard[sel, 2] * hard[sel, 4])  # b^2 > a c
    hard[i % 13 == 0, 5] = 0.5 / 255.0
    label = f"path 3 per-pair rows, hard conics, {w}x{h}, {ps.n_pairs} pairs"
    cases, *_ = pair_row_cases(hard, ts, w, h, label)
    check_cases(cases, label)
    check_repeat(cases, label)


def report_fused_cull(x, label: str) -> None:
    """K4's cull on the pairs it projects from x's world rows (K5 has none)."""
    from splatam_tpu_torch.render import bounds as B
    from splatam_tpu_torch.render import composite, fused_iso

    xy, conic, op, _ = fused_iso.project_pairs_plain(x.ps.world8, x.pose, x.w, x.h)
    wc = B.walk_counts(xy, conic, op, x.ps.tile_start, x.w, x.h, warp_w=composite.WARP_W)
    report_cull(wc, label, forward="K4", backward=None)


def kernel_work(x) -> dict:
    """(bytes, float32 ops) of each SLAM-loop kernel on these inputs: each
    input read once, each output written once (the backward kernels read
    two rows of the forward's state); the walks' evaluations counted by the
    plain walk (render/bounds.py); the fused walk's counts are taken at
    K5's warps (two rows of 16 pixels). K5 needs each staged pair's
    projection and its chain to world once."""
    from splatam_tpu_torch.render import bounds as B
    from splatam_tpu_torch.render import composite, fused_iso

    ps, b = x.ps, x.b
    a = x.attrs[b.pair_gauss.long()]
    gen = B.walk_counts(a[:, 0:2], a[:, 2:5], a[:, 5], b.tile_start, x.w, x.h,
                        warp_w=composite.WARP_W)
    xy, conic, op, _ = fused_iso.project_pairs_plain(ps.world8, x.pose, x.w, x.h)
    fus = B.walk_counts(xy, conic, op, ps.tile_start, x.w, x.h)
    print(f"walk counts: generic {gen}\nwalk counts: fused {fus}", flush=True)
    print(f"K5 reduction: {fus.bwd_warp_steps} (pair, warp) steps with a contributing lane; "
          f"{55 * fus.bwd_warp_steps / 1e6:.1f}M warp shuffles at 55 a step (a butterfly per "
          f"column), {16 * fus.bwd_warp_steps / 1e6:.1f}M at 16 (the reduce-scatter)",
          flush=True)
    report_cull(gen, "generic render")

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


def small_scene(device, n: int = 5000, aniso: bool = False):
    import numpy as np
    import torch

    from splatam_tpu_torch.core.camera import Camera
    from splatam_tpu_torch.core.gaussians import GaussianMap

    rng = np.random.default_rng(0)
    f = dict(
        means3d=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                          rng.uniform(1.0, 5, n)], -1).astype(np.float32),
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
        logit_opacities=rng.normal(1.0, 0.5, n).astype(np.float32),
        log_scales=np.log(rng.uniform(0.01, 0.08, (n, 1))).astype(np.float32),
        active=rng.uniform(size=n) > 0.1,
    )
    if aniso:
        f["log_scales"] = np.log(rng.uniform(0.01, 0.08, (n, 3))).astype(np.float32)
    gm = GaussianMap(**{k: torch.tensor(v, device=device) for k, v in f.items()})
    q = torch.tensor([0.99, 0.02, -0.03, 0.01], device=device)
    t = torch.tensor([0.02, -0.01, 0.03], device=device)
    return gm, q, t, Camera(height=120, width=160, fx=150.0, fy=150.0, cx=80.0, cy=60.0)


def bench_config(workdir: str, **overrides):
    """bench.py:48-78's settings for the port, its run directory under
    `workdir`; overrides update a section (dict) or set a key."""
    from splatam_tpu_torch.slam.config import load_experiment_config

    config = load_experiment_config(os.path.join(ROOT, "configs", "synthetic", "splatam.py"))
    config["workdir"] = workdir
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


def drive_path(name: str, config: dict, frames: int, device, k2_per_frame=None):
    """Run `frames` frames of the online loop; launch counts are zeroed
    just before and read after every frame. Fatal checks: the path's
    kernels launched from frame 1 on, the other kernels never, finite
    poses, a map that densification grows after frame 0 (frame 0's mapping
    may prune the first frame's cloud); with k2_per_frame = (frame 0, later frames), K2's
    launches in each frame (one per tracking and one per mapping iteration
    on the generic path). Returns (runtime, launch counts)."""
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
    k2_before = 0
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
        if i == 0:
            n_frame0 = rt.gm.num_active()
        k2 = launches["composite_backward"] - k2_before
        k2_before = launches["composite_backward"]
        if k2_per_frame is not None and k2 != k2_per_frame[min(i, 1)]:
            fail(f"{name} frame {i}: {k2} K2 launches, the config implies {k2_per_frame[min(i, 1)]}")
    launches = launch_counts()
    if not (np.isfinite(rt.cam_rots[:frames]).all() and np.isfinite(rt.cam_trans[:frames]).all()):
        fail(f"{name}: non-finite poses")
    if not rt.gm.num_active() > n_frame0:
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


def check_launches(name: str, launches: dict, label: str | None = None) -> None:
    """PATH_KERNELS[name]'s kernels launched, the others not."""
    must, never = PATH_KERNELS[name]
    label = label or name
    print(f"{label}: launches={launches}", flush=True)
    if min(launches[k] for k in must) == 0:
        fail(f"{label}: a kernel of the path was never launched: {launches}")
    if any(launches[k] for k in never):
        fail(f"{label}: a kernel off the path was launched: {launches}")


QUALITY = ("psnr", "ms_ssim", "lpips_synthetic", "depth_l1", "depth_rmse", "ate_rmse")


# replica_bench's (upstream configs/replica/splatam.py) tracking and mapping losses
LOSS_PHASES = {"loss_track": (True, dict(use_sil_for_loss=True, sil_thres=0.99)),
               "loss_map": (False, dict(use_sil_for_loss=False, sil_thres=0.5))}


def loss_work(h: int, w: int, mapping: bool) -> tuple[int, int]:
    """(bytes, operations) of the loss kernel at h x w: ten input planes
    read once (image, colour, depth, depth^2, silhouette, depth_gt) and the
    four gradient planes written once; in mapping, SSIM's blurs per pixel
    and channel (five moments and three back-blurs, separable: 8 x 2 x 11
    multiply-adds, 2 operations each)."""
    return 14 * h * w * 4, (3 * h * w * 8 * 2 * 11 * 2 if mapping else 0)


def check_loss_kernel(final_map, final_frame) -> tuple:
    """Phase 5b: get_loss's loss kernel (csrc/loss.cu) on a render of path
    1's final map at its last pose against that frame, as a tracking and as
    a mapping call: against its plain version (the closed form in float32,
    no TF32; the loss within 1e-5, each gradient plane within 1e-5 of its
    own largest value, the mask count exact), twice bit for bit; times in
    turns with its plain version (the kernel's row: its device time under
    torch.profiler where verified), and beside the PyTorch composition it
    replaces (forward and autograd backward to the image and depth), and
    FusedLoss forward and backward; the memory each holds between forward
    and backward; bounds. Returns (errs, times, bounds, library)."""
    import torch

    from splatam_tpu_torch.core import fused_loss
    from splatam_tpu_torch.scripts.harness import device_busy
    from splatam_tpu_torch.slam import steps

    view, q, t, cam = final_map
    color, depth_gt = final_frame
    out = steps.densify_render(view, q, t, cam)
    img = torch.stack([*out.im, out.depth, out.depth_sq, out.silhouette])
    errs, times, library, work = {}, {}, {}, {}
    label = f"loss, {WIDTH}x{HEIGHT}"
    for name, (tracking, keys) in LOSS_PHASES.items():
        pcfg = steps.PhaseConfig(use_l1=True, ignore_outlier_depth_loss=False, w_im=0.5,
                                 w_depth=1.0, **keys)
        r = fused_loss.route(pcfg, tracking)
        args = (img[:3], img[3], img[4], img[5], color, depth_gt, r)
        res, grad, gscale = fused_loss.loss_terms(*args)
        with torch.backends.cudnn.flags(allow_tf32=False):
            ref_res, ref_grad, ref_gscale = fused_loss.loss_terms_plain(*args)
        loss_rel = abs(float(res[0]) - float(ref_res[0])) / max(abs(float(ref_res[0])), 1e-30)
        err, rels = rel_err(grad, ref_grad)
        again = fused_loss.loss_terms(*args)
        same = all(torch.equal(a, b) for a, b in zip(again, (res, grad, gscale)))
        ok = (loss_rel <= 1e-5 and max(rels) <= 1e-5 and float(res[3]) == float(ref_res[3])
              and torch.equal(gscale, ref_gscale) and same)
        print(f"[{label}] {name}: loss {float(res[0]):.6f} (plain {float(ref_res[0]):.6f}, "
              f"rel {loss_rel:.1e}), mask {int(res[3])}, max_abs_err={err:.3e} "
              f"worst_plane_rel={max(rels):.1e} tol=1e-05 repeat_equal={same} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version ({label})")
        errs[name] = err

        def composition(r=r):
            x = img.detach().requires_grad_(True)
            return fused_loss.loss_composition(x[:3], x[3], x[4], x[5], color, depth_gt, r)[0], x

        def fused(r=r):
            x = img.detach().requires_grad_(True)
            return fused_loss.fused_loss(x[:3], x[3], x[4], x[5], color, depth_gt, r)[0], x

        held = {}
        for route, fn in (("composition", composition), ("fused", fused)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            loss, x = fn()
            torch.cuda.synchronize()
            held[route] = (torch.cuda.memory_allocated() - base) / 1e6
            torch.autograd.grad(loss, x)
            del loss, x

        def both(fn):
            return lambda: torch.autograd.grad(*fn())

        times.update(time_turns([(name, lambda args=args: fused_loss.loss_terms(*args),
                                  lambda args=args: fused_loss.loss_terms_plain(*args))]))
        busy = device_busy(lambda args=args: fused_loss.loss_terms(*args), img.device, 20)
        print(f"[{label}] {name}: device time {busy.ms:.4f} ms a call (profiler, both "
              f"kernels, verified={busy.verified}): "
              + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 20e3:.4f}"
                          for e in busy.events), flush=True)
        if busy.verified:  # the kernels' own time, without the host's launch gaps
            times[name] = (busy.ms, times[name][1])
        library[name] = min(event_ms(both(composition), 20, 3) for _ in range(2))
        fused_ms = min(event_ms(both(fused), 20, 3) for _ in range(2))
        print(f"[{label}] {name}: forward+backward, composition {library[name]:.3f} ms "
              f"(holds {held['composition']:.2f} MB until its backward), FusedLoss "
              f"{fused_ms:.3f} ms (holds {held['fused']:.2f} MB)", flush=True)
        work[name] = loss_work(HEIGHT, WIDTH, not tracking)
    bounds = report_bounds(work, times, label)
    return errs, times, bounds, library


def report_quality(label: str, metrics: dict, card: str) -> None:
    """Print the final evaluation's metrics; fatal unless all are finite."""
    vals = [metrics[k] for k in QUALITY] + list(metrics.get("runtime", {}).values())
    rt = metrics.get("runtime")
    runtime = (f"; tracking {rt['tracking_iter_ms']:.2f} ms/iteration, "
               f"{rt['tracking_frame_s']:.3f} s/frame; mapping {rt['mapping_iter_ms']:.2f} "
               f"ms/iteration, {rt['mapping_frame_s']:.3f} s/frame" if rt else "")
    print(f"[{label}] PSNR {metrics['psnr']:.4f} dB, MS-SSIM {metrics['ms_ssim']:.5f}, LPIPS "
          f"(synthetic) {metrics['lpips_synthetic']:.5f}, depth L1 "
          f"{100 * metrics['depth_l1']:.4f} cm, depth RMSE {100 * metrics['depth_rmse']:.4f} cm, "
          f"ATE {100 * metrics['ate_rmse']:.4f} cm{runtime} ({card})", flush=True)
    if not all(math.isfinite(v) for v in vals):
        fail(f"{label}: a metric is not finite: {metrics}")


def _run_dir(config) -> str:
    return os.path.join(config["workdir"], config["run_name"])


def _load_params(path: str, label: str) -> dict:
    import numpy as np

    if not os.path.exists(path):
        fail(f"{label}: {path} was not written")
    params = dict(np.load(path, allow_pickle=True))
    missing = [k for k in PARAM_KEYS if k not in params]
    if missing:
        fail(f"{label}: {os.path.basename(path)} lacks {missing}")
    return params


def eval_split(config, params: dict, device) -> None:
    """One frame's eval (the last) split into the synthetic frame's
    generation (host ray cast, wall ms), its render (K1 and the binning
    around it), MS-SSIM and LPIPS: CUDA-event ms per call (events span the
    host's gaps too)."""
    import numpy as np

    from splatam_tpu_torch.core.camera import setup_camera
    from splatam_tpu_torch.core.losses import ms_ssim
    from splatam_tpu_torch.data import dataset_from_config, frame_to_tensors
    from splatam_tpu_torch.eval import evaluate
    from splatam_tpu_torch.eval.lpips import lpips_fn

    ds = dataset_from_config(config["data"])
    i = FRAMES_SLAM - 1
    t0 = time.time()
    for _ in range(2):
        color_np, depth_np, intr, _ = ds[i]
    frame_ms = (time.time() - t0) * 1e3 / 2
    cam = setup_camera(color_np.shape[1], color_np.shape[0], intr[:3, :3], None)
    gm = evaluate._map_from_params(params, device)
    q = np.asarray(params["cam_unnorm_rots"])[0, :, i]
    t = np.asarray(params["cam_trans"])[0, :, i]
    color, depth = frame_to_tensors(color_np, depth_np, device)
    lpips = lpips_fn(device=device)
    out = evaluate.render_at_pose(gm, q, t, cam)
    im, gt = out.im * (depth > 0)[None], color * (depth > 0)[None]
    ms = {"dataset frame (host)": frame_ms,
          "render": event_ms(lambda: evaluate.render_at_pose(gm, q, t, cam), 5, 1),
          "ms_ssim": event_ms(lambda: ms_ssim(im, gt), 5, 1),
          "lpips": event_ms(lambda: lpips(im.clamp(0, 1), gt.clamp(0, 1)), 5, 1)}
    print(f"path 4 eval of one frame, {cam.width}x{cam.height}, {len(params['means3D'])} "
          f"Gaussians: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)


def check_panels(run: str, config: dict) -> None:
    """tracking.visualize_tracking_loss wrote one panel PNG per tracked frame
    (1..n-1), each read back by read_png: the 2x4 grid of full-size panels
    where matplotlib does not import (this machine), else the figure."""
    from splatam_tpu_torch.data.png import read_png

    try:
        import matplotlib  # noqa: F401
        grid = None
    except ImportError:
        data = config["data"]
        grid = (2 * data["desired_image_height"], 4 * data["desired_image_width"])
    viz = os.path.join(run, "tracking_loss_viz")
    names = sorted(os.listdir(viz)) if os.path.isdir(viz) else []
    want = [f"{t:04d}.png" for t in range(1, FRAMES_SLAM)]
    shapes = [read_png(os.path.join(viz, n)).shape for n in names]
    ok = names == want and all(grid is None or sh[:2] == grid for sh in shapes)
    print(f"path 4 tracking-loss panels: {names}, shapes {sorted(set(shapes))} "
          f"(expected {grid or 'matplotlib figures'}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"path 4: tracking-loss panels {names} of shapes {shapes}")


def drive_slam(work: str, device, card: str) -> dict:
    """Path 4 (a)-(d), see the module docstring. Returns the launch counts
    of the run, its eval and its resume."""
    import numpy as np
    import torch

    from splatam_tpu_torch.data import dataset_from_config
    from splatam_tpu_torch.eval.evaluate import eval_sequence
    from splatam_tpu_torch.io.ply import load_ply
    from splatam_tpu_torch.scripts import export_ply
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts
    from splatam_tpu_torch.slam.config import seed_everything
    from splatam_tpu_torch.slam.pipeline import rgbd_slam

    config = bench_config(work, data={"num_frames": FRAMES_SLAM}, save_checkpoints=True,
                          checkpoint_interval=CKPT_EVERY, run_name="path4",
                          tracking={"visualize_tracking_loss": True})
    run = _run_dir(config)
    launches = {}

    # (a) the run
    seed_everything(0)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    metrics = rgbd_slam(copy.deepcopy(config), device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches["path 4"] = launch_counts()
    check_launches("path 4", launches["path 4"])
    if launches["path 4"]["composite_forward"] != PATH4_K1:
        fail(f"path 4: {launches['path 4']['composite_forward']} K1 launches, expected {PATH4_K1}")
    check_panels(run, config)
    params = _load_params(os.path.join(run, "params.npz"), "path 4")
    for t in range(0, FRAMES_SLAM, CKPT_EVERY):
        _load_params(os.path.join(run, f"params{t}.npz"), "path 4")
    kf_path = os.path.join(run, f"keyframe_time_indices{RESUME_AT}.npy")
    if not os.path.exists(kf_path):
        fail(f"path 4: {kf_path} was not written")
    kfs = params["keyframe_time_indices"].tolist()
    print(f"path 4: {FRAMES_SLAM} frames in {wall:.3f} s with its eval, {len(params['means3D'])} "
          f"Gaussians, keyframes {kfs}", flush=True)
    if kfs != SLAM_KEYFRAMES:
        fail(f"path 4: keyframes {kfs}, expected {SLAM_KEYFRAMES}")
    if not (np.isfinite(params["cam_unnorm_rots"]).all() and np.isfinite(params["cam_trans"]).all()):
        fail("path 4: non-finite poses")
    report_quality("path 4", metrics, card)

    # (b) eval again on the saved params.npz
    cfg_m = config["mapping"]
    ds = dataset_from_config(config["data"])
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    again = eval_sequence(ds, params, FRAMES_SLAM, os.path.join(run, "eval_again"),
                          cfg_m["sil_thres"], cfg_m["num_iters"], cfg_m["add_new_gaussians"],
                          eval_every=config["eval_every"], device=device)
    torch.cuda.synchronize()
    print(f"path 4 eval: {time.time() - t0:.3f} s for {FRAMES_SLAM} frames", flush=True)
    launches["path 4 eval"] = launch_counts()
    check_launches("path 4 eval", launches["path 4 eval"])
    same = again == {k: v for k, v in metrics.items() if k != "runtime"}
    print(f"path 4 eval of params.npz equal to the run's bit for bit: {same}", flush=True)
    if not same:
        fail(f"path 4: eval of params.npz {again} differs from the run's {metrics}")
    eval_split(config, params, device)

    # (c) resume from checkpoint RESUME_AT, in a run directory of its own
    resume = dict(copy.deepcopy(config), run_name="path4_resume", load_checkpoint=True,
                  checkpoint_time_idx=RESUME_AT)
    os.makedirs(_run_dir(resume))
    for name in (f"params{RESUME_AT}.npz", f"keyframe_time_indices{RESUME_AT}.npy"):
        shutil.copy(os.path.join(run, name), _run_dir(resume))
    seed_everything(0)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    resumed = rgbd_slam(resume, device)
    torch.cuda.synchronize()
    launches["path 4 resume"] = launch_counts()
    check_launches("path 4", launches["path 4 resume"], "path 4 resume")
    rparams = _load_params(os.path.join(_run_dir(resume), "params.npz"), "path 4 resume")
    if not (np.isfinite(rparams["cam_unnorm_rots"]).all()
            and np.isfinite(rparams["cam_trans"]).all()):
        fail("path 4 resume: non-finite poses")
    print(f"path 4 resume from frame {RESUME_AT}: {time.time() - t0:.3f} s, keyframes "
          f"{rparams['keyframe_time_indices'].tolist()}, {len(rparams['means3D'])} Gaussians",
          flush=True)
    report_quality("path 4 resumed", resumed, card)

    # (d) export_ply, load_ply
    exp = os.path.join(work, "path4_experiment.py")
    with open(exp, "w") as f:
        f.write(f"config = {config!r}\n")
    back = load_ply(export_ply.main([exp]))
    n = len(params["means3D"])
    ok = (all(np.array_equal(back[k], params[k].reshape(n, -1)) for k in
              ("means3D", "unnorm_rotations", "logit_opacities"))
          and np.array_equal(back["log_scales"], np.tile(params["log_scales"], (1, 3)))
          and np.abs(back["rgb_colors"] - params["rgb_colors"]).max() <= 1e-6)
    print(f"path 4 export_ply -> load_ply: {n} Gaussians, arrays given back={ok}", flush=True)
    if not ok:
        fail("path 4: load_ply does not give back params.npz's arrays")
    return launches


@contextlib.contextmanager
def working_dir(path: str):
    here = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(here)


def write_trees(work: str) -> str:
    """Paths 5-7's working directory: a `configs` link to the repo's, a
    Replica-V2 room_0 tree (frames 0, 2, .., 10 of a 12-frame pan in imap/00,
    frames 1, 5, 9 held out in imap/01) and a TUM freiburg1_desk tree (5
    frames), each the synthetic scene rendered through its dataset YAML's
    camera at the YAML's size and depth scale."""
    from splatam_tpu_torch.data import load_dataset_config
    from splatam_tpu_torch.data.export import synthetic_sequence, write_replica_v2, write_tum

    real = os.path.join(work, "real")
    os.makedirs(real)
    os.symlink(os.path.join(ROOT, "configs"), os.path.join(real, "configs"))
    t0 = time.time()
    for yaml_path, frames, write in (
            ("replica_v2.yaml", 2 * FRAMES_REPLICA, lambda ds, scale: write_replica_v2(
                os.path.join(real, "data", "Replica_V2", "room_0"), ds,
                train=range(0, 2 * FRAMES_REPLICA, 2),
                test=range(1, 4 * NVS_FRAMES - 2, 4), depth_scale=scale)),
            ("TUM/freiburg1_desk.yaml", FRAMES_TUM, lambda ds, scale: write_tum(
                os.path.join(real, "data", "TUM_RGBD", "rgbd_dataset_freiburg1_desk"), ds,
                depth_scale=scale))):
        cam = load_dataset_config(os.path.join(ROOT, "configs", "data", yaml_path))["camera_params"]
        write(synthetic_sequence(frames, cam["image_height"], cam["image_width"], cam["fx"],
                                 cam["fy"], cam["cx"], cam["cy"]), cam["png_depth_scale"])
    print(f"paths 5-7: trees written in {time.time() - t0:.1f} s (host ray cast, write_png)",
          flush=True)
    return real


# Runs a CLI module's main() as `python -m <module> <args>` does, then
# writes the process's launch counts and main()'s return value to a file.
CLI = ("import importlib, json, sys\n"
       "import torch\n"
       "out, sys.argv = sys.argv[1], sys.argv[2:]\n"
       "metrics = importlib.import_module(sys.argv[0]).main()\n"
       "from splatam_tpu_torch.scripts.harness import launch_counts\n"
       "peak = torch.cuda.max_memory_allocated() / 2**30\n"
       "with open(out, 'w') as f:\n"
       "    json.dump({'launches': launch_counts(), 'metrics': metrics, 'peak_gib': peak}, f,\n"
       "              default=float)\n")


def run_cli(real: str, module: str, config: str, label: str):
    """`python -m <module> <config>` in `real` (SCENE_NUM=0, SEED=0), a
    process of its own whose launch counts start at 0; fatal unless it
    exits 0 and launched PATH_KERNELS[label]'s kernels and no other.
    Returns (launch counts, main()'s metrics)."""
    import torch

    out = os.path.join(real, label.replace(" ", "_") + ".json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               SCENE_NUM="0", SEED="0")
    torch.cuda.empty_cache()
    t0 = time.time()
    sys.stdout.flush()
    res = subprocess.run([sys.executable, "-c", CLI, out, module, config], cwd=real, env=env)
    if res.returncode != 0:
        fail(f"{label}: python -m {module} {config} exited {res.returncode}")
    with open(out) as f:
        got = json.load(f)
    print(f"{label}: python -m {module} {config}: {time.time() - t0:.1f} s with its start, "
          f"peak memory allocated {got['peak_gib']:.2f} GiB", flush=True)
    check_launches(label, got["launches"])
    return got["launches"], got["metrics"]


def loader_time(real: str, config_path: str, label: str) -> None:
    """The host time of dataset[i] (read, decode, resize) over the tree,
    and the image reader the loader uses."""
    from splatam_tpu_torch.data import dataset_from_config
    from splatam_tpu_torch.slam.config import load_experiment_config

    with working_dir(real):
        ds = dataset_from_config(load_experiment_config(config_path)["data"])
        t0 = time.time()
        for i in range(len(ds)):
            color, *_ = ds[i]
        ms = (time.time() - t0) * 1e3 / len(ds)
    print(f"{label} loader: {ms:.1f} ms per frame (host; read, decode, resize to "
          f"{color.shape[1]}x{color.shape[0]}) over {len(ds)} frames, images read by "
          f"{ds.imread.name}", flush=True)


def time_read_png(real: str, work: str) -> None:
    """read_png on TUM frame 0's 640x480 16-bit depth image, as written
    (filter 0) and re-encoded with every row Paeth-filtered (its slowest
    case: a Python loop over each row's bytes); host ms, best of 3."""
    import glob

    import numpy as np

    from splatam_tpu_torch.data.png import read_png, write_png

    src = sorted(glob.glob(os.path.join(real, "data", "TUM_RGBD", "*", "depth", "*.png")))[0]
    depth = read_png(src)
    paeth = os.path.join(work, "paeth.png")
    write_png(paeth, depth, filter_type=4)
    ms = {}
    for name, path in (("filter 0", src), ("Paeth", paeth)):
        times = []
        for _ in range(3):
            t0 = time.time()
            back = read_png(path)
            times.append((time.time() - t0) * 1e3)
        if not np.array_equal(back, depth):
            fail(f"read_png: the {name} file reads back different")
        ms[name] = min(times)
    print(f"read_png, {depth.shape[1]}x{depth.shape[0]} {depth.dtype}: filter 0 "
          f"{ms['filter 0']:.1f} ms, Paeth {ms['Paeth']:.1f} ms (host)", flush=True)


def finite_poses(params_path: str, label: str) -> None:
    import numpy as np

    params = _load_params(params_path, label)
    if not (np.isfinite(params["cam_unnorm_rots"]).all() and np.isfinite(params["cam_trans"]).all()):
        fail(f"{label}: non-finite poses")


def drive_real(real: str, work: str, device, card: str) -> dict:
    """Paths 5-7 (see the module docstring) in the working directory
    write_trees made. Returns their launch counts."""
    from splatam_tpu_torch.slam.config import load_experiment_config

    try:
        import PIL
        print(f"Pillow {PIL.__version__} imports", flush=True)
    except ImportError:
        print("Pillow is not installed: PNG trees are read by read_png", flush=True)
    launches = {}

    # Path 5: Replica-V2 through the CLI, then the NVS eval on its params.npz.
    cfg = "configs/replica_v2/splatam.py"
    launches["path 5"], metrics = run_cli(real, "splatam_tpu_torch.scripts.splatam", cfg, "path 5")
    finite_poses(os.path.join(real, "experiments", "ReplicaV2", "room_0_0", "params.npz"), "path 5")
    report_quality("path 5", metrics, card)
    launches["path 5 nvs"], nvs = run_cli(real, "splatam_tpu_torch.scripts.eval_novel_view",
                                          "configs/replica_v2/eval_novel_view.py", "path 5 nvs")
    print(f"[path 5 nvs] PSNR {nvs['psnr']:.4f} dB, MS-SSIM {nvs['ms_ssim']:.5f}, depth L1 "
          f"{100 * nvs['depth_l1']:.4f} cm over {nvs['num_valid_frames']} valid held-out "
          f"frames ({card})", flush=True)
    if not all(math.isfinite(nvs[k]) for k in ("psnr", "ms_ssim", "depth_l1")):
        fail(f"path 5 nvs: a metric is not finite: {nvs}")
    loader_time(real, cfg, "path 5")

    # Path 6: TUM freiburg1_desk through the CLI.
    cfg = "configs/tum/splatam.py"
    launches["path 6"], metrics = run_cli(real, "splatam_tpu_torch.scripts.splatam", cfg, "path 6")
    finite_poses(os.path.join(real, "experiments", "TUM", "freiburg1_desk_seed0", "params.npz"),
                 "path 6")
    report_quality("path 6", metrics, card)
    loader_time(real, cfg, "path 6")
    time_read_png(real, work)

    # Path 7a: SplaTAM-S (densification at 600x340) on path 5's tree.
    with working_dir(real):
        config = load_experiment_config("configs/replica/splatam_s.py")
        config["data"].update(basedir="./data/Replica_V2", sequence="room_0",
                              gradslam_data_cfg="./configs/data/replica_v2.yaml")
        track, mapping = config["tracking"]["num_iters"], config["mapping"]["num_iters"]
        rt, launches["path 7a"] = drive_path("path 7a", config, FRAMES_REPLICA, device,
                                             k2_per_frame=(mapping, track + mapping))
        dense = (rt.densify_cam.width, rt.densify_cam.height)
        data = config["data"]
        print(f"path 7a: tracking {rt.tracking_cam.width}x{rt.tracking_cam.height}, "
              f"densification {dense[0]}x{dense[1]}, {rt.iters_run} tracking iterations in "
              f"the last frame", flush=True)
        if (dense != (data["densification_image_width"], data["densification_image_height"])
                or rt.iters_run != track):
            fail(f"path 7a: densification at {dense}, {rt.iters_run} tracking iterations")
        del rt

        # Path 7b: Replica-V2 with coarse-to-fine tracking.
        config = load_experiment_config("configs/replica_v2/splatam.py")
        config["tracking"]["coarse_to_fine"] = copy.deepcopy(C2F)
        config["data"]["num_frames"] = FRAMES_C2F
        track, mapping = config["tracking"]["num_iters"], config["mapping"]["num_iters"]
        rt, launches["path 7b"] = drive_path("path 7b", config, FRAMES_C2F, device,
                                             k2_per_frame=(mapping, track + mapping))
        print(f"path 7b: levels {C2F['levels']} at {rt.tracking_cam.width}x"
              f"{rt.tracking_cam.height}, {rt.iters_run} tracking iterations in the last frame",
              flush=True)
        if rt.iters_run != track:
            fail(f"path 7b: {rt.iters_run} tracking iterations, the config implies {track}")
        del rt
    return launches


def check_training(label: str, metrics: dict, launches: dict, iters: int, run_dir: str,
                   evals: tuple, scales: int, card: str) -> dict:
    """Paths 8 and 9: K2 once per training iteration, the densify passes
    (one must clone or split), the eval directories, finite quality and
    params.npz with `scales` log-scale columns. Returns params.npz."""
    import numpy as np

    if launches["composite_backward"] != iters:
        fail(f"{label}: {launches['composite_backward']} K2 launches for {iters} iterations")
    passes = metrics["densify_passes"]
    for p in passes:
        print(f"{label} densify at iteration {p['iteration']}: cloned {p['cloned']}, split "
              f"{p['split']}, {p['active']} Gaussians active", flush=True)
    if not any(p["cloned"] + p["split"] for p in passes):
        fail(f"{label}: no densify pass cloned or split")
    for name in evals:
        if not os.path.isdir(os.path.join(run_dir, name)) or not os.listdir(
                os.path.join(run_dir, name)):
            fail(f"{label}: {name}/ was not written")
    report_quality(label, metrics, card)
    tr = metrics["training"]
    print(f"{label}: {iters} training iterations at {tr['iter_ms']:.2f} ms each (wall, with "
          f"the frame reads), {len(passes)} densify passes at {tr['pass_ms']:.1f} ms each "
          f"({card})", flush=True)
    params = _load_params(os.path.join(run_dir, "params.npz"), label)
    if params["log_scales"].ndim != 2 or params["log_scales"].shape[1] != scales:
        fail(f"{label}: params.npz log_scales {params['log_scales'].shape}, expected "
             f"[N, {scales}]")
    return params


def training_experiment(real: str, name: str, base: str, data: dict, train: dict) -> str:
    """An experiment file in `real` that loads the repo config `base` and
    updates its data and train sections; prints the changes."""
    path = os.path.join(real, name)
    with open(path, "w") as f:
        f.write("from importlib.machinery import SourceFileLoader\n"
                f"config = SourceFileLoader('base', {base!r}).load_module().config\n"
                f"config['data'].update({data!r})\n"
                f"config['train'].update({train!r})\n")
    print(f"{name}: {base} with data {data}, train {train}", flush=True)
    return name


def drive_training(real: str, work: str, device, card: str) -> dict:
    """Paths 8-10 (see the module docstring). Returns their launch counts."""
    import numpy as np
    import torch

    from splatam_tpu_torch.slam.config import load_experiment_config

    tree = dict(basedir="./data/Replica_V2", sequence="room_0",
                gradslam_data_cfg="./configs/data/replica_v2.yaml")
    launches = {}
    with working_dir(real):
        base = load_experiment_config("configs/replica/gaussian_splatting.py")
    print(f"path 8 cuts: num_iters_mapping {base['train']['num_iters_mapping']} -> {GS_ITERS}; "
          f"eval_intermediate_at [7000] -> {GS_EVAL_AT}; num_frames "
          f"{base['data']['num_frames']} and eval_num_frames {base['data']['eval_num_frames']} "
          f"-> the tree's (-1)", flush=True)
    exp = training_experiment(real, "path8_gaussian_splatting.py",
                              "configs/replica/gaussian_splatting.py",
                              dict(tree, num_frames=-1, eval_num_frames=-1),
                              dict(num_iters_mapping=GS_ITERS, eval_intermediate_at=GS_EVAL_AT))
    launches["path 8"], metrics = run_cli(
        real, "splatam_tpu_torch.scripts.gaussian_splatting", exp, "path 8")
    params = check_training("path 8", metrics, launches["path 8"], GS_ITERS,
                            os.path.join(real, "experiments", "Replica_GS", "room0_0"),
                            ("eval_1k", "eval"), 3, card)
    check_trained_params(params, "path 8", device)
    del params
    torch.cuda.empty_cache()

    ckpt = "./experiments/ReplicaV2/room_0_0/params.npz"
    print(f"path 9 cuts: num_iters_mapping 15000 -> {POST_ITERS}; param_ckpt_path -> path 5's "
          f"{ckpt}", flush=True)
    exp = training_experiment(real, "path9_post_splatam_opt.py",
                              "configs/replica/post_splatam_opt.py",
                              dict(tree, param_ckpt_path=ckpt),
                              dict(num_iters_mapping=POST_ITERS))
    launches["path 9"], metrics = run_cli(
        real, "splatam_tpu_torch.scripts.post_splatam_opt", exp, "path 9")
    # The map keeps the checkpoint's distribution (path 5's is isotropic).
    src = np.load(os.path.join(real, ckpt))
    params = check_training("path 9", metrics, launches["path 9"], POST_ITERS,
                            os.path.join(real, "experiments", "Replica_PostOpt", "room0_seed0"),
                            ("eval",), src["log_scales"].shape[1], card)
    same = all(np.array_equal(params[k], src[k]) for k in ("cam_unnorm_rots", "cam_trans"))
    print(f"path 9: poses equal to the checkpoint's bit for bit: {same}; "
          f"{len(src['means3D'])} Gaussians in, {len(params['means3D'])} out", flush=True)
    if not same:
        fail("path 9: the poses differ from the checkpoint's")
    check_trained_params(params, "path 9", device)
    del params
    split_path9_eval(real, exp, dict(src), metrics, device)
    del src
    torch.cuda.empty_cache()
    launches["path 10"] = drive_gs_loop(work, device, card)
    return launches


def split_path9_eval(real: str, exp: str, params5: dict, metrics9: dict, device) -> None:
    """Path 5's own params.npz evaluated at path 9's settings (its eval
    dataset: the tree at 600x340 with eval_stride, frame 0), beside path 9's
    metrics: says whether the PSNR gap between paths 5 and 9 belongs to the
    evaluation or to post_splatam_opt."""
    from splatam_tpu_torch.eval.evaluate import eval_sequence
    from splatam_tpu_torch.scripts.gaussian_splatting import _build_dataset
    from splatam_tpu_torch.slam.config import load_experiment_config

    with working_dir(real):
        config = load_experiment_config(exp)
        data, train = config["data"], config["train"]
        h, w = data["desired_image_height"], data["desired_image_width"]
        eval_ds = _build_dataset(config, h, w, stride=data.get("eval_stride", 1))
        m5 = eval_sequence(eval_ds, params5, len(eval_ds), os.path.join(real, "eval_path5_at9"),
                           sil_thres=train["sil_thres"], mapping_iters=POST_ITERS,
                           add_new_gaussians=True, eval_every=config.get("eval_every", 1),
                           device=device, save_plots=False)
    print(f"path 9 eval split: path 5's params.npz at path 9's evaluation ({len(eval_ds)} "
          f"frame(s) at {w}x{h}, eval_stride {data.get('eval_stride')}): PSNR {m5['psnr']:.4f} "
          f"dB, depth L1 {100 * m5['depth_l1']:.4f} cm; path 9's trained map there: PSNR "
          f"{metrics9['psnr']:.4f} dB, depth L1 {100 * metrics9['depth_l1']:.4f} cm", flush=True)
    if not all(math.isfinite(m5[k]) for k in ("psnr", "depth_l1")):
        fail(f"path 9 eval split: a metric is not finite: {m5}")


def drive_gs_loop(work: str, device, card: str) -> dict:
    """Path 10: in-loop 3DGS on path 1's configuration; mapping's wall per
    frame is read around map_frame. Returns its launch counts."""
    import torch

    from splatam_tpu_torch.slam.config import load_experiment_config
    from splatam_tpu_torch.slam.pipeline import SLAMRuntime

    densify = copy.deepcopy(load_experiment_config(os.path.join(
        ROOT, "configs", "synthetic", "splatam.py"))["mapping"]["densify_dict"])
    densify.update(GS_LOOP_SCHEDULE)
    config = bench_config(work, mapping=dict(use_gaussian_splatting_densification=True,
                                             densify_dict=densify))
    mapping = config["mapping"]["num_iters"]
    map_frame, map_s = SLAMRuntime.map_frame, []

    def timed(rt, *args):
        torch.cuda.synchronize()
        t0 = time.time()
        map_frame(rt, *args)
        torch.cuda.synchronize()
        map_s.append(time.time() - t0)

    SLAMRuntime.map_frame = timed
    try:
        rt, launches = drive_path("path 10", config, FRAMES_GS_LOOP, device,
                                  k2_per_frame=(mapping, mapping))
    finally:
        SLAMRuntime.map_frame = map_frame
    for p in rt.gs_passes:
        print(f"path 10 frame {p['frame']} densify at iteration {p['iteration']}: cloned "
              f"{p['cloned']}, split {p['split']}, {p['active']} Gaussians active", flush=True)
    if len(rt.gs_passes) != FRAMES_GS_LOOP * len(range(
            GS_LOOP_SCHEDULE["start_after"], GS_LOOP_SCHEDULE["stop_after"] + 1,
            GS_LOOP_SCHEDULE["densify_every"])):
        fail(f"path 10: {len(rt.gs_passes)} densify passes")
    print(f"path 10: mapping {', '.join(f'{s:.3f}' for s in map_s)} s per frame, "
          f"{1e3 * sum(map_s[1:]) / (mapping * (len(map_s) - 1)):.2f} ms per mapping iteration "
          f"after frame 0 with the passes ({card})", flush=True)
    last = FRAMES_GS_LOOP - 1
    check_trained_map(rt.gm, torch.as_tensor(rt.cam_rots[last], device=device),
                      torch.as_tensor(rt.cam_trans[last], device=device), rt.cam,
                      "path 10 final", names=LOOP_KERNELS)
    del rt
    return launches


# Path 11: the generic render of any channels on path 1's final map at its
# last pose: (label, colours, their kind, append_depth_channels). Kernel
# channels: the colours, plus z and z^2 with depth appended.
GENERIC_CASES = (
    ("a rgb", 3, "rgb", False),  # ch 3: the reference's RGB pass
    ("b [z, 1, z^2]", 3, "depth", False),  # ch 3: the reference's depth/silhouette pass
    ("c one channel", 1, "random", False),  # ch 1
    ("d 8 channels + depth", 8, "random", True),  # ch 10, the widest
    ("e rgb + depth", 3, "rgb", True),  # ch 5: render_rgbd_sil's rows
    *((f"f {c} channels", c, "random", False) for c in (2, 4, 6, 7, 8, 9)),
)
REFERENCE_N = 2000  # path 11's anisotropic map at 160x120 for the naive and tiles backends


def generic_map(view, q, t, cam, device) -> SimpleNamespace:
    """Path 11's inputs: the map in the camera's frame at the pose, its
    projection and binning (the kernels' attributes), each case's colours."""
    import torch

    from splatam_tpu_torch.render import api, binning
    from splatam_tpu_torch.slam import steps

    with torch.no_grad():
        means, rots = steps.transform_to_frame(view, q, t, False, False)
        proj, aux = api.project_gaussians(cam, means, rots, view.logit_opacities,
                                          view.log_scales, view.active)
        b = binning.build_bins(proj, aux, cam.width, cam.height)
    gen = torch.Generator(device).manual_seed(11)
    z = proj.depth[:, None]
    colors = {}
    for label, n, kind, _ in GENERIC_CASES:
        colors[label] = {"rgb": view.rgb_colors,
                         "depth": torch.cat([z, torch.ones_like(z), z * z], 1),
                         "random": None}[kind]
        if colors[label] is None:
            colors[label] = torch.rand((z.shape[0], n), device=device, generator=gen)
    return SimpleNamespace(cam=cam, means=means, rots=rots, view=view, proj=proj, b=b, z=z,
                           colors=colors, gen=gen)


def drive_generic(m) -> tuple:
    """Path 11's run: each case through render_gaussians, forward and the
    backward of a seeded weighting of every output row; counts zeroed just
    before each case and read just after, which must show one launch of K1
    and K2 at the case's channel count and of K3 at 6 + that count, and no
    other. Case e's rows must equal render_rgbd_sil's bit for bit. Returns
    the counts summed over the cases."""
    import torch

    from splatam_tpu_torch.render import api
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts

    cam, v = m.cam, m.view
    total = {}
    for label, n, _, append in GENERIC_CASES:
        ch, rows = (n + 2, n + 3) if append else (n, n)
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in (m.means, m.colors[label], m.rots, v.logit_opacities, v.log_scales)]
        w = torch.randn((rows, cam.height, cam.width), device=m.z.device, generator=m.gen)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.time()
        img, radii, n_pairs = api.render_gaussians(cam, *leaves, v.active,
                                                   append_depth_channels=append)
        grads = torch.autograd.grad((img * w).sum(), leaves)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        launches = launch_counts()
        for k, c in launches.items():
            total[k] = total.get(k, 0) + c
        moved = {k: c for k, c in launches.items() if c}
        want = {instance_name("composite_forward", ch): 1,
                instance_name("composite_backward", ch): 1,
                instance_name("segment_reduce", 6 + ch): 1}
        finite = bool(torch.isfinite(img).all()) and all(bool(torch.isfinite(g).all())
                                                         for g in grads)
        print(f"path 11 {label}: kernel ch {ch}, image {tuple(img.shape)}, {n_pairs} pairs, "
              f"fwd+bwd {ms:.1f} ms wall, launches {moved}, finite={finite}", flush=True)
        if moved != want:
            fail(f"path 11 {label}: launches {moved}, expected {want}")
        if img.shape != (rows, cam.height, cam.width) or not finite:
            fail(f"path 11 {label}: image {tuple(img.shape)}, finite={finite}")
        if label.startswith("e "):
            with torch.no_grad():
                out = api.render_rgbd_sil(cam, m.means, v.rgb_colors, m.rots, v.logit_opacities,
                                          v.log_scales, v.active)
            same = torch.equal(img.detach(), torch.cat([out.im, out.depth[None],
                                                        out.silhouette[None],
                                                        out.depth_sq[None]]))
            print(f"path 11 {label}: equal to render_rgbd_sil bit for bit={same}", flush=True)
            if not same:
                fail("path 11: render_gaussians at ch 5 differs from render_rgbd_sil")
    return total


def check_generic_kernels(m, label: str) -> tuple:
    """K1, K2 and K3 on each path 11 case's own inputs against their plain
    versions (K1 bit for bit), K2 and K3 twice; then, once per width
    instance beside the SLAM loop's, its time (CUDA events over 20
    launches, the smaller of two turns), its plain version's (one call),
    its bound and, for K3, index_add_'s. Returns (errors, times, bounds,
    library ms) keyed by kernel name."""
    import torch

    from splatam_tpu_torch.render import bounds as B
    from splatam_tpu_torch.render import composite

    cam, b = m.cam, m.b
    w, h = cam.width, cam.height
    a = torch.cat([m.proj.xy, m.proj.conic, m.proj.opacity[:, None]], 1)[b.pair_gauss.long()]
    wc = B.walk_counts(a[:, 0:2], a[:, 2:5], a[:, 5], b.tile_start, w, h,
                       warp_w=composite.WARP_W)
    del a
    print(f"walk counts: path 11 {wc}", flush=True)
    errs, times, bounds, library = {}, {}, {}, {}
    for case, n, _, append in GENERIC_CASES:
        ch = n + 2 if append else n
        chans = torch.cat([m.colors[case], m.z, m.z * m.z], 1) if append else m.colors[case]
        attrs = torch.cat([m.proj.xy, m.proj.conic, m.proj.opacity[:, None], chans],
                          1).contiguous()
        state = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h)
        g = torch.randn((ch + 1, h, w), device=attrs.device, generator=m.gen)
        dgen = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, state, g)
        names = (instance_name("composite_forward", ch), instance_name("composite_backward", ch),
                 instance_name("segment_reduce", 6 + ch))
        ts, pg = b.tile_start, b.pair_gauss
        cases = [
            (names[0], lambda: composite.composite_forward(attrs, pg, ts, w, h),
             lambda: composite.composite_forward_plain(attrs, pg, ts, w, h)),
            (names[1], lambda: composite.composite_backward(attrs, pg, ts, w, h, state, g),
             lambda: composite.composite_backward_plain(attrs, pg, ts, w, h, state, g)),
            (names[2], lambda: composite.segment_reduce(dgen, b.dst, b.offsets, b.counts),
             lambda: composite.segment_reduce_plain(dgen, b.dst, b.offsets, b.counts)),
        ]
        plain = {}
        case_label = f"{label}, case {case}, ch {ch}"
        case_errs = check_cases(cases, case_label, plain_ms=plain)
        check_repeat(cases, case_label)
        for name, kernel, _ in cases:
            if name not in WIDE or name in times:
                continue
            errs[name] = case_errs[name]
            ms = min(event_ms(kernel, 20, 3), event_ms(kernel, 20, 3))
            times[name] = (ms, plain[name])
            print(f"time {name}: kernel {ms:.3f} ms, plain {plain[name]:.3f} ms", flush=True)
        work = {
            names[0]: (B.nbytes(attrs, pg, ts, state), B.forward_walk_ops(wc, ch)),
            names[1]: (B.nbytes(attrs, pg, ts, g, dgen) + B.image_rows_bytes(state, 2),
                       B.backward_walk_ops(wc, ch)),
            names[2]: (B.nbytes(dgen, b.dst, b.offsets, b.counts)
                       + b.counts.numel() * dgen.shape[1] * 4, dgen.numel()),
        }
        new = {k: v for k, v in work.items() if k in times and k not in bounds}
        bounds.update(report_bounds(new, times, case_label))
        if names[2] in new:
            library[names[2]] = library_index_add(names[2], dgen, b)
        del attrs, state, g, dgen, cases
    return errs, times, bounds, library


@contextlib.contextmanager
def naive_in_binned_order(cam):
    """The naive backend ordering its Gaussians by the kernels' depth key
    (binning.quantized_depth at this image's tile count, ties in index
    order, as a tile's pairs sort) in place of the exact depth: the same
    front-to-back order as the kernels within every tile."""
    from splatam_tpu_torch.render import binning, naive

    gx, gy = binning.grid_shape(cam.width, cam.height)
    bits = binning.depth_bits_for(gx * gy)
    exact = naive.composite_naive

    def binned(proj, aux, channels, width, height):
        key = binning.quantized_depth(proj.depth.detach(), bits).to(proj.depth.dtype)
        return exact(proj._replace(depth=key), aux, channels, width, height)

    naive.composite_naive = binned
    try:
        yield
    finally:
        naive.composite_naive = exact


def check_references(device) -> None:
    """render_gaussians through the kernels against its naive and tiles
    backends on the card, at 160x120 on an anisotropic map of REFERENCE_N
    Gaussians, at kernel ch 3 (three colours) and 10 (eight colours and
    depth): images within 1e-4, each gradient within 5e-5 of its largest
    magnitude (the JAX suite's tolerances for its backends). The naive
    backend runs twice: in its exact-depth order, and in the kernels'
    quantized-depth order (naive_in_binned_order), which splits how much
    of its distance from the kernels is the order of near-equal depths."""
    import numpy as np
    import torch

    from splatam_tpu_torch.render import api
    from splatam_tpu_torch.slam import steps

    gm, q, t, cam = small_scene(device, n=REFERENCE_N, aniso=True)
    with torch.no_grad():
        means, rots = steps.transform_to_frame(gm, q, t, False, False)
    gen = torch.Generator(device).manual_seed(12)
    for n, append in ((3, False), (8, True)):
        colors = torch.rand((gm.capacity, n), device=device, generator=gen)
        rows = n + 3 if append else n
        w = torch.randn((rows, cam.height, cam.width), device=device, generator=gen)
        out = {}
        for backend in ("auto", "naive", "naive, binned order", "tiles"):
            leaves = [a.detach().clone().requires_grad_(True)
                      for a in (means, colors, rots, gm.logit_opacities, gm.log_scales)]
            order = (naive_in_binned_order(cam) if backend == "naive, binned order"
                     else contextlib.nullcontext())
            torch.cuda.synchronize()
            t0 = time.time()
            with order:
                img, _, _ = api.render_gaussians(cam, *leaves, gm.active,
                                                 backend=backend.partition(",")[0],
                                                 append_depth_channels=append)
                grads = torch.autograd.grad((img * w).sum(), leaves)
            torch.cuda.synchronize()
            out[backend] = (img.detach(), grads, time.time() - t0)
        img_a, grads_a, _ = out["auto"]
        for backend in ("naive", "naive, binned order", "tiles"):
            img, grads, secs = out[backend]
            img_err = float((img - img_a).abs().max())
            grad_rel = [float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))
                        for g, r in zip(grads, grads_a)]
            ok = img_err <= 1e-4 and max(grad_rel) <= 5e-5
            print(f"path 11 references, 160x120, {REFERENCE_N} Gaussians, ch "
                  f"{n + 2 if append else n}: {backend} ({secs:.1f} s fwd+bwd) vs the kernels: "
                  f"image {img_err:.2e} (tol 1e-4), gradients "
                  f"{', '.join(f'{r:.1e}' for r in grad_rel)} of their largest (tol 5e-5) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok or not np.isfinite(grad_rel).all():
                fail(f"path 11: the kernels disagree with the {backend} backend")


def drive_viewers(work: str, device) -> dict:
    """Path 12: final_recon and online_recon as `python -m` in processes of
    their own on path 4's run directory (its experiment file: the viz
    section of configs/synthetic/splatam.py, 600x340): 24 orbit views
    through 24 K1 launches, one replay frame per frame; one view decoded
    with read_png equal to render_view's uint8 in this process. Returns
    their launch counts."""
    import numpy as np

    from splatam_tpu_torch.data.png import read_png
    from splatam_tpu_torch.scripts.final_recon import N_VIEWS, orbit_w2c, to_uint8
    from splatam_tpu_torch.slam.config import load_experiment_config
    from splatam_tpu_torch.viz import scene

    exp = os.path.join(work, "path4_experiment.py")
    params = os.path.join(work, "path4", "params.npz")
    launches = {}
    launches["path 12 final_recon"], views = run_cli(
        work, "splatam_tpu_torch.scripts.final_recon", exp, "path 12 final_recon")
    launches["path 12 online_recon"], frames = run_cli(
        work, "splatam_tpu_torch.scripts.online_recon", exp, "path 12 online_recon")
    k1 = (launches["path 12 final_recon"]["composite_forward"],
          launches["path 12 online_recon"]["composite_forward"])
    replays = [os.path.join(work, "path4", "online_replay", f"replay_{t:04d}.png")
               for t in frames]
    written = all(os.path.exists(f) for f in [*views, *replays])
    print(f"path 12: final_recon wrote {len(views)} views with {k1[0]} K1 launches, "
          f"online_recon {len(frames)} replay frames with {k1[1]} K1 launches; every PNG "
          f"written={written}", flush=True)
    if len(views) != N_VIEWS or k1 != (N_VIEWS, FRAMES_SLAM) or frames != list(
            range(FRAMES_SLAM)) or not written:
        fail(f"path 12: {len(views)} views, frames {frames}, K1 launches {k1}")
    viz = load_experiment_config(exp)["viz"]
    gm, w2cs, _ = scene.load_scene_data(params, device)
    _, k = scene.load_camera(viz, params)
    im, _, _ = scene.render_view(gm, orbit_w2c(w2cs[-1], 0), k, viz)
    got = read_png(views[0])
    same = got.shape == (viz["viz_h"], viz["viz_w"], 3) and np.array_equal(got, to_uint8(im))
    print(f"path 12: view 0 ({got.shape[1]}x{got.shape[0]}) decoded equal to render_view's "
          f"uint8 here={same}", flush=True)
    if not same:
        fail("path 12: final_recon's view 0 differs from render_view in this process")
    return launches


def drive_gauntlet(work: str, device, card: str) -> dict:
    """Path 13: the micro-gauntlets (scripts/gauntlet.py MICRO: clean, 30
    frames, and scan, 39 frames at motion_scale 1.0, both 160x120, rebin 8,
    60/60 iterations) through the port's run_variant, as gates: a breached
    floor fails. Then K1, K4, K5 and K3-8 on the clean run's final map at
    160x120 (7.5 tile rows) against their plain versions. Returns the
    launch counts."""
    import torch

    from splatam_tpu_torch.scripts import gauntlet
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts

    workdir = os.path.join(work, "gauntlet")
    launches = {}
    for name, micro in gauntlet.MICRO.items():
        label = f"path 13 {name}"
        torch.cuda.synchronize()
        reset_launch_counts()
        m = gauntlet.run_micro(name, workdir, device)
        torch.cuda.synchronize()
        launches[label] = launch_counts()
        check_launches(label, launches[label])
        report_quality(label, m, card)
        ate = 100 * m["ate_rmse"]
        print(f"[{label}] {micro['frames']} frames at {gauntlet.MICRO_HW[1]}x"
              f"{gauntlet.MICRO_HW[0]}: ATE {ate:.4f} cm (floor < {micro['ate_cm']}), PSNR "
              f"{m['psnr']:.4f} dB (floor >= {micro['psnr']}), {m['wall_s']} s with its eval "
              f"-> {'PASS' if m['pass'] else 'FAIL'} ({card})", flush=True)
        if not m["pass"]:
            fail(f"{label}: a micro-gauntlet floor broke (ATE {ate:.4f} cm, PSNR "
                 f"{m['psnr']:.4f} dB)")
    params = _load_params(os.path.join(workdir, "gauntlet_clean", "params.npz"), "path 13 clean")
    check_trained_params(params, "path 13 clean", device,
                         names=("composite_forward", "fused_forward", "fused_backward",
                                "segment_reduce"))
    return launches


def live_stream(config: dict) -> list:
    """Path 14's NeRFCapture stream: the synthetic scene at the config's full
    resolution (its size times downscale_factor), one frame per
    data.num_frames, depth at PHONE_DEPTH_HW, with an empty read after the
    first sample and a sample without depth after the second. The frames
    are ray-cast here, in threads, before any timing."""
    from concurrent.futures import ThreadPoolExecutor

    from splatam_tpu_torch.data.imgproc import resize_nearest
    from splatam_tpu_torch.data.synthetic import SyntheticDataset
    from splatam_tpu_torch.live.replay import to_sample

    data = config["data"]
    n = data["num_frames"]
    h = int(data["desired_image_height"] * data["downscale_factor"])
    w = int(data["desired_image_width"] * data["downscale_factor"])
    ds = SyntheticDataset(num_frames=n, height=h, width=w)
    t0 = time.time()
    with ThreadPoolExecutor(8) as ex:
        frames = list(ex.map(ds.__getitem__, range(n)))
    samples = [to_sample(i, c, resize_nearest(d[..., 0], *PHONE_DEPTH_HW), k, p)
               for i, (c, d, k, p) in enumerate(frames)]
    c, _, k, p = frames[-1]
    print(f"path 14 stream: {n} frames at {w}x{h}, depth {PHONE_DEPTH_HW[1]}x"
          f"{PHONE_DEPTH_HW[0]}, ray-cast in {time.time() - t0:.1f} s before the run", flush=True)
    return [samples[0], None, samples[1], to_sample(n, c, None, k, p), *samples[2:]]


def drive_live(work: str, device, card: str) -> dict:
    """Path 14: configs/iphone/online_demo.py as written (1920x1440 samples,
    downscale 2 -> 960x720, 10 frames, 60/60 iterations, window 32, rebin 1)
    through live_slam on a replayed stream (live_stream): K1, K2 and K3-11
    launched, K2 once per tracking and mapping iteration, the fused kernels
    never; s/frame, ATE against the served poses, the Gaussian count; K1,
    K2 and K3-11 on its final map at 960x720 against their plain versions;
    then nerfcapture2dataset's loop on the same samples, read back through
    configs/iphone/splatam.py's loader: equal to the served frames within
    the PNG depth quantisation. Returns the launch counts."""
    from pathlib import Path

    import numpy as np
    import torch

    from splatam_tpu_torch.data import dataset_from_config
    from splatam_tpu_torch.data.imgproc import resize_linear
    from splatam_tpu_torch.eval.ate import evaluate_ate
    from splatam_tpu_torch.live.replay import SampleReader
    from splatam_tpu_torch.scripts import iphone_demo, nerfcapture2dataset
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts
    from splatam_tpu_torch.slam.config import load_experiment_config, seed_everything
    from splatam_tpu_torch.slam.pipeline import _w2c_from_qt

    config = load_experiment_config(os.path.join(ROOT, "configs", "iphone", "online_demo.py"))
    config["workdir"] = os.path.join(work, "live")
    n = config["data"]["num_frames"]
    track, mapping = config["tracking"]["num_iters"], config["mapping"]["num_iters"]
    stream = live_stream(config)

    step, step_s = iphone_demo._step_frame, []

    def timed(rt, live_ds, time_idx):
        torch.cuda.synchronize()
        t0 = time.time()
        step(rt, live_ds, time_idx)
        torch.cuda.synchronize()
        step_s.append(time.time() - t0)

    iphone_demo._step_frame = timed
    seed_everything(config["seed"])
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.time()
    try:
        rt = iphone_demo.live_slam(config, device, SampleReader(stream))
    finally:
        iphone_demo._step_frame = step
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"path 14": launch_counts()}
    check_launches("path 14", launches["path 14"])
    k2 = launches["path 14"]["composite_backward"]
    if k2 != mapping + (n - 1) * (track + mapping):
        fail(f"path 14: {k2} K2 launches, the config implies {mapping + (n - 1) * (track + mapping)}")
    if not (np.isfinite(rt.cam_rots).all() and np.isfinite(rt.cam_trans).all()):
        fail("path 14: non-finite poses")
    est = [_w2c_from_qt(rt.cam_rots[i], rt.cam_trans[i]) for i in range(n)]
    ate = evaluate_ate(rt.gt_w2c_all, est)
    steady = sorted(step_s[1:])
    print(f"path 14: {n} frames at {rt.cam.width}x{rt.cam.height} in {wall:.3f} s "
          f"({wall / n:.3f} s/frame with decode and PNG writes); frame step "
          f"{', '.join(f'{s:.3f}' for s in step_s)} s, median after frame 0 "
          f"{steady[len(steady) // 2]:.3f} s; ATE {100 * ate:.4f} cm against the served poses; "
          f"{rt.gm.num_active()} Gaussians; keyframes {rt.keyframe_time_indices}; densify at "
          f"{rt.densify_cam.width}x{rt.densify_cam.height} ({card})", flush=True)
    if not math.isfinite(ate) or (rt.densify_cam, rt.tracking_cam) != (rt.cam, rt.cam):
        fail(f"path 14: ATE {ate}, densify/tracking cameras differ from the main one")
    last = n - 1
    check_trained_map(rt.gm, torch.as_tensor(rt.cam_rots[last], device=device),
                      torch.as_tensor(rt.cam_trans[last], device=device), rt.cam,
                      "path 14 final")
    gt_c2w = [np.linalg.inv(w2c) for w2c in rt.gt_w2c_all]
    del rt
    torch.cuda.empty_cache()

    # The dataset capture of the same samples, read back by the offline config's loader.
    real = os.path.join(work, "real_iphone")
    os.makedirs(real)
    os.symlink(os.path.join(ROOT, "configs"), os.path.join(real, "configs"))
    with working_dir(real):
        capture = load_experiment_config("configs/iphone/dataset.py")
        t0 = time.time()
        nerfcapture2dataset.dataset_capture_loop(
            SampleReader([s for s in stream if s is None or s.has_depth]),
            Path(capture["workdir"]) / capture["run_name"], capture["overwrite"], n,
            capture["depth_scale"])
        secs = time.time() - t0
        data = load_experiment_config("configs/iphone/splatam.py")["data"]
        ds = dataset_from_config(data)
        h, w = data["desired_image_height"], data["desired_image_width"]
        samples = [s for s in stream if s and s.has_depth]
        errs = np.zeros(4)
        for i in range(n):
            color, depth, k, pose = ds[i]
            served = iphone_demo._decode_frame(samples[i], w, h, samples[i].width / w)
            image = iphone_demo._sample_image(samples[i])
            errs = np.maximum(errs, [np.abs(color - resize_linear(image, h, w)).max(),
                                     np.abs(depth - served[1]).max(),
                                     np.abs(k - served[2]).max(),
                                     np.abs(pose - gt_c2w[i]).max()])
    # depth: truncated to the uint16 step of depth_scale / 65535 m, the
    # product rounded in float32 first (well under 1% of a step here)
    step = capture["depth_scale"] / 65535
    ok = (len(ds) == n and errs[0] <= 1e-4 and errs[1] <= 1.01 * step
          and errs[2] <= 1e-4 and errs[3] <= 1e-5)
    print(f"path 14 capture: {n} frames in {secs:.1f} s, read back at {w}x{h} by "
          f"configs/iphone/splatam.py's loader ({ds.imread.name}): colour {errs[0]:.1e} (tol 1e-4), "
          f"depth {errs[1]:.2e} m (tol {1.01 * step:.2e}, a uint16 step), "
          f"intrinsics {errs[2]:.1e}, pose {errs[3]:.1e} (tol 1e-5) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("path 14: the captured tree does not read back as the served frames")
    return launches


# ---------------------------------------------------------------------------
# Path 15: row bands
# ---------------------------------------------------------------------------

TRACK_PCFG = dict(use_sil_for_loss=True, sil_thres=0.99, use_l1=True,
                  ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0)
MAP_PCFG = dict(use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
                ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0)


def multichip_scene(device, top: bool = False):
    """tests/test_multichip.py's scene (256 Gaussians, seed 0) and frame
    (seed 1) at 80x64: with 4 bands of 32 rows band 3 starts past the last
    row and renders nothing. With `top` every Gaussian sits in the upper
    part of the view (y in [-1, -0.6]), so band 1 of 2 has rows and no
    pair: the kernels walk tiles with empty lists."""
    import numpy as np
    import torch

    from splatam_tpu_torch.core.camera import Camera
    from splatam_tpu_torch.core.gaussians import GaussianMap

    rng = np.random.default_rng(0)
    n = 256
    f = dict(means3d=np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, -0.6 if top else 1, n),
                               rng.uniform(1.5, 4, n)], -1).astype(np.float32),
             rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
             unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
             logit_opacities=rng.normal(1.0, 0.5, (n,)).astype(np.float32),
             log_scales=np.log(rng.uniform(0.02, 0.08, (n, 1))).astype(np.float32),
             active=np.ones(n, bool))
    gm = GaussianMap(**{k: torch.tensor(v, device=device) for k, v in f.items()})
    rng = np.random.default_rng(1)
    color = torch.tensor(rng.uniform(0, 1, (3, 80, 64)).astype(np.float32), device=device)
    depth = torch.tensor(rng.uniform(1.0, 4.0, (80, 64)).astype(np.float32), device=device)
    q = torch.tensor([1.0, 0.01, 0.0, 0.0], device=device)
    t = torch.tensor([0.02, -0.01, 0.03], device=device)
    return gm, q, t, Camera(height=80, width=64, fx=60.0, fy=60.0, cx=32.0, cy=40.0), color, depth


ROUTES = ("tracking", "mapping fused", "generic")
# The most one pair flipping across the alpha cutoff (alpha >= 1/255 applied
# or skipped) moves a pixel's silhouette: alpha / (1 - alpha) <= 1/254, plus
# the T < 1e-4 stop flipping (1e-4) and rounding (1e-5).
SIL_FLIP = 1.0 / 254.0 + 1e-4 + 1e-5


def banded_loss(route: str, gm, q, t, cam, color, depth, bands):
    """(loss, aux, gradient columns) of steps.get_loss on one route
    (bands_multicard.route_inputs) with `bands` (None: the full image), at
    path 1's phase settings."""
    from splatam_tpu_torch.scripts import bands_multicard
    from splatam_tpu_torch.slam import steps

    pcfg = steps.PhaseConfig(**(TRACK_PCFG if route == "tracking" else MAP_PCFG))
    return bands_multicard.route_loss(route, gm, q, t, cam, color, depth, bands, pcfg)


def banded_render(route: str, gm, q, t, cam, bands):
    """(the route's render through steps.loss_render, still differentiable,
    and what its gradients are taken of), with `bands`."""
    from splatam_tpu_torch.scripts import bands_multicard
    from splatam_tpu_torch.slam import steps

    g, q_, t_, ps, dummy, wrt = bands_multicard.route_inputs(route, gm, q, t, cam, bands)
    tracking = route == "tracking"
    return steps.loss_render(g, q_, t_, cam, tracking, not tracking, ps, dummy, bands), wrt


def render_vjp(out, wrt, cot) -> list:
    """The gradient columns of the render's rgb and depth under the
    cotangents cot = (rgb [3, H, W], depth [H, W])."""
    import torch

    from splatam_tpu_torch.scripts import bands_multicard

    return bands_multicard.columns(torch.autograd.grad((out.im, out.depth), wrt, cot,
                                                       retain_graph=True))


def moved_pixels(got, ref):
    """[H, W] pixels where any channel of the banded render lies off the
    full image's by more than 1e-5 (relative past 1): the pixels a pair
    flipping across the alpha cutoff (or the T < 1e-4 stop) changes."""
    import torch

    a = torch.cat([got.im, got.depth[None], got.silhouette[None], got.depth_sq[None]]).detach()
    b = torch.cat([ref.im, ref.depth[None], ref.silhouette[None], ref.depth_sq[None]]).detach()
    return ((a - b).abs() > 1e-5 * b.abs().clamp(min=1.0)).any(0)


def boundary_rows(cam, n: int):
    """[H] the image rows within one 16-row tile of a band boundary."""
    import torch

    from splatam_tpu_torch.parallel import spatial

    h_local, _ = spatial.shard_heights(cam.height, n)
    rows = torch.arange(cam.height)
    near = torch.zeros(cam.height, dtype=torch.bool)
    for k in range(1, n):
        near |= (rows >= k * h_local - 16) & (rows < k * h_local + 16)
    return near


def straddlers(gm, q, t, cam, bands):
    """[N] the Gaussians with pairs in two or more bands."""
    import torch

    from splatam_tpu_torch.slam import steps

    with torch.no_grad():
        structs = steps.loss_pair_structure(gm, q, t, cam, bands=bands)
        return torch.stack([ps.counts.to(q.device) > 0 for ps in structs]).sum(0) >= 2


def worst_column(bs, us, rows=None):
    """(the worst column's largest difference over its largest value, its
    index); with `rows`, over those rows of the per-Gaussian columns only
    (None if there are none)."""
    out = None
    for c, (b, u) in enumerate(zip(bs, us)):
        top = max(float(u.abs().max()), 1e-30)
        if rows is not None:
            if u.shape[0] != rows.shape[0]:
                continue
            b, u = b[rows], u[rows]
        e = float((b - u).abs().max()) / top if u.numel() else 0.0
        out = max(out or (e, c), (e, c))
    return out


def worst_l2(bs, us) -> float:
    """The worst column's relative L2 error."""
    return max(float((b - u).norm()) / max(float(u.norm()), 1e-30) for b, u in zip(bs, us))


def vjp_numbers(got, ref, color, depth, straddle) -> dict:
    """got, ref: (render, what its gradients are taken of) of banded_render.
    The pixels that moved (moved_pixels), and the render's gradient
    columns under an L1 loss's cotangent of ref (rgb and depth) that is
    zero at the moved pixels: the worst column over its largest value
    (and its index), over the Gaussians in `straddle`, and by relative
    L2."""
    import torch

    (out_b, wrt_b), (out_u, wrt_u) = got, ref
    moved = moved_pixels(out_b, out_u)
    keep = (~moved).float()
    with torch.no_grad():
        cot = (torch.sign(out_u.im - color) * keep,
               torch.sign(out_u.depth - depth) * (depth > 0) * keep)
    vb, vu = render_vjp(out_b, wrt_b, cot), render_vjp(out_u, wrt_u, cot)
    return dict(moved_map=moved, moved=int(moved.sum()), vjp=worst_column(vb, vu),
                vjp_straddle=None if straddle is None else worst_column(vb, vu, straddle),
                vjp_l2=worst_l2(vb, vu))


def parity_numbers(got, ref, vjp: dict) -> dict:
    """How far a banded route lies from the full image's: the loss's
    relative error; the silhouette's largest difference and the pixels off
    by more than 1e-5; radii > 0 equal; the get_loss gradient's worst
    column, by its largest difference over its largest value and by its
    relative L2 error; and vjp_numbers."""
    (loss_b, aux_b, cols_b), (loss_u, aux_u, cols_u) = got, ref
    d = (aux_b.silhouette - aux_u.silhouette).abs()
    return dict(loss=abs(loss_b - loss_u) / max(abs(loss_u), 1e-30), sil=float(d.max()),
                pixels=int((d > 1e-5).sum()),
                radii=bool(((aux_b.radii > 0) == (aux_u.radii > 0)).all()),
                grad=worst_column(cols_b, cols_u)[0], grad_l2=worst_l2(cols_b, cols_u), **vjp)


def parity_ok(x: dict, shift: dict | None) -> bool:
    """tests/test_multichip.py's gates: loss within 1e-5, radii > 0 equal,
    and the render's gradient columns (vjp_numbers) within 5e-5 of their
    largest value, also over the Gaussians with pairs in two bands or
    more. Strict (shift None): also the silhouette within 1e-5 at every
    pixel and the get_loss gradient columns within 5e-5.

    With `shift` (the full image against itself with its rows moved by one
    float32 ulp of the image height): a band computes each pair's pixel
    position with its own NDC terms, which round otherwise by about that
    much. A pair at the alpha cutoff then flips in one render and not the
    other, so every pixel's silhouette must stay within what one flip
    moves (SIL_FLIP) and no more pixels may move than under the shift; the
    render's gradients are taken with a cotangent that is zero at the
    moved pixels, so flips move no gradient. A small Gaussian's gradient
    still moves with its position by up to what the shift moves it, so
    each column holds 5e-5 of its largest value by relative L2 and, row
    by row, 5e-5 or twice the shift's, whichever is larger."""
    ok = x["loss"] <= 1e-5 and x["radii"] and math.isfinite(x["loss"])
    straddle = x["vjp_straddle"][0] if x["vjp_straddle"] is not None else 0.0
    if shift is None:
        return (ok and x["vjp"][0] <= 5e-5 and straddle <= 5e-5 and x["pixels"] == 0
                and x["grad"] <= 5e-5)
    tol = max(5e-5, 2 * shift["vjp"][0])
    return (ok and x["vjp"][0] <= tol and straddle <= tol and x["vjp_l2"] <= 5e-5
            and x["sil"] <= SIL_FLIP and x["pixels"] <= shift["pixels"])


def fmt_vjp(x: dict) -> str:
    s = (f"{x['moved']} pixels moved in any channel; render gradient off them worst column "
         f"{x['vjp'][0]:.1e} of its largest (column {x['vjp'][1]}), relative L2 "
         f"{x['vjp_l2']:.1e}")
    if x["vjp_straddle"] is not None:
        s += f", {x['vjp_straddle'][0]:.1e} over the Gaussians in two bands or more"
    return s


def fmt_parity(x: dict) -> str:
    return (f"loss rel {x['loss']:.1e}, silhouette max|diff| {x['sil']:.1e} ({x['pixels']} "
            f"pixels > 1e-5), radii > 0 equal {x['radii']}, get_loss gradient worst column "
            f"{x['grad']:.1e} of its largest (relative L2 {x['grad_l2']:.1e}); {fmt_vjp(x)}")


def check_band_parity(scene, label: str, strict: bool) -> None:
    """Path 15 (a) on one scene: each route with 2 and 4 bands against the
    full image (parity_ok; strict: test_multichip.py's gates, else beside
    the full image under a one-ulp row shift)."""
    import torch

    from splatam_tpu_torch.parallel import spatial
    from splatam_tpu_torch.slam import steps

    gm, q, t, cam, color, depth = scene
    ref = {r: banded_loss(r, gm, q, t, cam, color, depth, None) for r in ROUTES}
    ref_out = {r: banded_render(r, gm, q, t, cam, None) for r in ROUTES}
    ulp = 2.0 ** (math.floor(math.log2(cam.height)) - 23)
    cam_s = cam._replace(cy=cam.cy + ulp)
    shift = {}
    for r in ROUTES:
        got = banded_loss(r, gm, q, t, cam_s, color, depth, None)
        d = (got[1].silhouette - ref[r][1].silhouette).abs()
        shift[r] = dict(pixels=int((d > 1e-5).sum()), sil=float(d.max()), **vjp_numbers(
            banded_render(r, gm, q, t, cam_s, None), ref_out[r], color, depth, None))
        print(f"[path 15 {label}] {r}, the full image with cy + {ulp:.2e} px: silhouette "
              f"max|diff| {shift[r]['sil']:.1e} ({shift[r]['pixels']} pixels > 1e-5); "
              f"{fmt_vjp(shift[r])}", flush=True)
    thr = MAP_PCFG["sil_thres"]
    out_u = steps.densify_render(gm, q, t, cam)
    cand_u = steps.densify_candidates(out_u, depth, thr)
    for n in (2, N_BANDS):
        bands = spatial.make_bands(n, q.device)
        straddle = straddlers(gm, q, t, cam, bands)
        edge = boundary_rows(cam, n).to(q.device)
        for r in ROUTES:
            x = parity_numbers(banded_loss(r, gm, q, t, cam, color, depth, bands), ref[r],
                               vjp_numbers(banded_render(r, gm, q, t, cam, bands), ref_out[r],
                                           color, depth, straddle))
            ok = parity_ok(x, None if strict else shift[r])
            print(f"[path 15 {label}, {n} bands] {r}: {fmt_parity(x)}; "
                  f"{int(x['moved_map'][edge].sum())} moved pixels of "
                  f"{int(edge.sum()) * cam.width} within a tile of a band boundary, "
                  f"{int(straddle.sum())} Gaussians in two bands or more "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"path 15 ({label}): {r} with {n} bands differs from the full image")
        pad = cam.width * cam.height
        big = type(gm)(*(torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype,
                                                   device=a.device)]) for a in gm))
        ts = torch.zeros((big.means3d.shape[0],), device=q.device)
        _, _, n_b, drop_b = steps.densify_step(big, ts, color, depth, q, t, 1, cam, thr, bands)
        out_b = steps.densify_render(gm, q, t, cam, bands)
        cand_b = steps.densify_candidates(out_b, depth, thr)
        # a candidate may differ only where the two renders differ past rounding
        # or the silhouette lies within 1e-5 of the threshold
        near = (out_u.silhouette - thr).abs() <= 1e-5
        stray = int(((cand_b != cand_u) & ~moved_pixels(out_b, out_u) & ~near).sum())
        ok = drop_b == 0 and n_b == int(cand_b.sum()) and stray == 0
        print(f"[path 15 {label}, {n} bands] densify_step: {n_b} added vs "
              f"{int(cand_u.sum())}, {int((cand_b != cand_u).sum())} candidates differ, "
              f"{stray} of them where the renders agree {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"path 15 ({label}): densify_step with {n} bands differs from the full image")
        del big, ts, out_b, cand_b
        if q.is_cuda:
            torch.cuda.empty_cache()


def band_inputs(gm, q, t, cam, k: int, n: int, seed: int) -> SimpleNamespace:
    """kernel_inputs of band k of n: its structure (world-8 rows gathered
    per pair), its pose vector (cy - row0, the full image's limits, NDC
    terms from the band's own width and height) and its generic render's
    attrs, as parallel/spatial.py builds them."""
    import torch

    from splatam_tpu_torch.core.transforms import build_rotation, normalize
    from splatam_tpu_torch.parallel import spatial
    from splatam_tpu_torch.render import api, composite, fused_iso
    from splatam_tpu_torch.slam import steps

    bands = spatial.make_bands(n, q.device)
    h_local, _ = spatial.shard_heights(cam.height, n)
    cam_b = cam._replace(height=spatial.band_rows(cam.height, n)[k])
    intr = (cam.fx, cam.fy, cam.cx, cam.cy - k * h_local)
    w, h = cam.width, cam_b.height
    with torch.no_grad():
        means_cam, rots = steps.transform_to_frame(gm, q, t, False, False)
        rows8 = fused_iso.pack_world8(gm.means3d, gm.logit_opacities, gm.log_scales,
                                      gm.rgb_colors, gm.active)
        ps = spatial.compute_pair_structure_sharded(bands, cam, means_cam, rots,
                                                    gm.logit_opacities, gm.log_scales,
                                                    gm.active, world_rows8=rows8)[k]
        pose = fused_iso.make_pose_vec(build_rotation(normalize(q)[None])[0], t, w, h,
                                       *fused_iso._geom_for(cam_b, intr, (cam.width,
                                                                          cam.height))[2])
        proj, _ = api.project_gaussians(cam_b, means_cam, rots, gm.logit_opacities,
                                        gm.log_scales, gm.active, intr, (cam.width, cam.height))
    gen = torch.Generator(q.device).manual_seed(seed)
    state = fused_iso.fused_forward(ps.world8, pose, ps.tile_start, w, h)
    g = torch.randn((6, h, w), device=q.device, generator=gen)
    dpair = fused_iso.fused_backward(ps.world8, pose, ps.tile_start, w, h, state, g)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d],
                      1).contiguous()
    gstate = composite.composite_forward(attrs, ps.pair_gauss, ps.tile_start, w, h)
    g2 = torch.randn((6, h, w), device=q.device, generator=gen)
    dgen = composite.composite_backward(attrs, ps.pair_gauss, ps.tile_start, w, h, gstate, g2)
    return SimpleNamespace(w=w, h=h, attrs=attrs, b=ps, gstate=gstate, g2=g2, dgen=dgen, ps=ps,
                           pose=pose, state=state, g=g, dpair=dpair, rows8=rows8)


def drive_bands(work: str, device, final_map, final_frame) -> dict:
    """Path 15: returns the launch counts of (c)-(f)."""
    import numpy as np
    import torch

    from splatam_tpu_torch.eval.evaluate import report_progress
    from splatam_tpu_torch.scripts import (
        dryrun_multichip, exp_gather, probe_saturation, profile_map_ablate, profile_sharded,
    )
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts
    from splatam_tpu_torch.slam.pipeline import _w2c_from_qt

    t0 = time.time()
    view, q, t, cam = final_map
    check_band_parity((view, q, t, cam, *final_frame), f"path 1's map, {WIDTH}x{HEIGHT}",
                      strict=False)
    check_band_parity(multichip_scene(device), "80x64, band 3 of 4 past the image",
                      strict=True)
    check_band_parity(multichip_scene(device, top=True), "80x64, the map in the top rows",
                      strict=True)
    x = band_inputs(view, q, t, cam, 1, N_BANDS, seed=5)
    label = f"band 1 of {N_BANDS}, {x.w}x{x.h}, {x.ps.n_pairs} pairs"
    cases = kernel_cases(x)
    check_cases(cases, label)
    check_repeat(cases, label)
    del x, cases
    torch.cuda.empty_cache()
    print(f"path 15 (a, b): {time.time() - t0:.1f} s", flush=True)

    launches, runs = {}, {}
    for name, shards in (("path 15 unbanded", 0), ("path 15 bands", N_BANDS)):
        t1 = time.time()
        rt, launches[name] = drive_path(name, bench_config(work, tpu={"spatial_shards": shards}),
                                        FRAMES_BANDS, device)
        last = FRAMES_BANDS - 1
        span = rt.gm.span()
        color, depth = final_frame_of(rt, last, device)
        m = report_progress(type(rt.gm)(*(a[:span] for a in rt.gm)), rt.cam_rots[last],
                            rt.cam_trans[last], color, depth, rt.cam, TRACK_PCFG["sil_thres"],
                            tracking=True, gt_w2c_list=rt.gt_w2c_all,
                            est_w2c_list=[_w2c_from_qt(rt.cam_rots[i], rt.cam_trans[i])
                                          for i in range(FRAMES_BANDS)])
        runs[name] = m
        print(f"[{name}] {FRAMES_BANDS} frames in {time.time() - t1:.1f} s: ATE "
              f"{m['ate_rmse'] * 100:.4f} cm, PSNR {m['psnr']:.4f} dB, {rt.gm.num_active()} "
              f"Gaussians, bands {rt.bands}", flush=True)
        if not (np.isfinite(m["ate_rmse"]) and np.isfinite(m["psnr"])):
            fail(f"{name}: non-finite ATE or PSNR: {m}")
        del rt
        torch.cuda.empty_cache()
    plain, banded = launches["path 15 unbanded"], launches["path 15 bands"]
    # the loss runs once an iteration, on the gathered image
    times_of = {k: 1 if k in LOSS_PHASES else N_BANDS for k in plain}
    off = {k: (plain[k], banded[k]) for k in plain if banded[k] != times_of[k] * plain[k]}
    print(f"path 15 (c): launches with {N_BANDS} bands {N_BANDS}x those without (the loss's "
          f"equal): {not off}", flush=True)
    if off:
        fail(f"path 15 (c): launches not {N_BANDS}x (the loss's: 1x) the unbanded run's: {off}")

    def counted(name, fn):
        t1 = time.time()
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = launch_counts()
        check_launches(name, launches[name])
        print(f"{name}: {time.time() - t1:.1f} s", flush=True)
        return out

    counted("path 15 dryrun", lambda: dryrun_multichip.main(["--bands", str(N_BANDS)]))
    counted("path 15 profile_sharded", lambda: profile_sharded.main(
        ["--shards", "1", "2", "4", "--reps", "2"]))
    counted("path 15 profile_map_ablate", lambda: profile_map_ablate.main(
        ["--n", str(PROFILE_N), "--h", str(HEIGHT), "--w", str(WIDTH), "--iters", "3",
         "--reps", "2"]))
    counted("path 15 probe_saturation", lambda: probe_saturation.main(
        ["--frames", "3", "--h", str(HEIGHT), "--w", str(WIDTH)]))

    def gathers():
        exp_gather.table_gathers(1835008, int(1835008 * 1.08) // 128 * 128, device, 10, 2)
        return exp_gather.tracking_gather(view, q, t, cam, device, 10, 2)

    counted("path 15 exp_gather", gathers)
    print(f"path 15: {time.time() - t0:.1f} s", flush=True)
    return launches


# Path 16 (a, b): bench.py's JSON keys (bench.py:163-179) and the port's `device`
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "aggregation", "warmup_frames",
              "rebin_every", "frame0_s", "max_frame_s", "n_gaussians_final", "device"}
# Path 16 (c): the binning variants (render.binning.BinOptions); the J-slot
# order's, and the structure holding the same pairs in the classic order
VARIANTS = {"classic": {}, "tile_cull": {"tile_cull": True}, "direct_j=2": {"direct_j": 2},
            "both": {"tile_cull": True, "direct_j": 2}}
ORDER_OF = {"direct_j=2": "classic", "both": "tile_cull"}


def run_bench(label: str, **env) -> tuple:
    """`python -m splatam_tpu_torch.scripts.bench` at its defaults (and
    `env`) in a process of its own, its stderr echoed but the launch line:
    fatal unless it exits 0 and prints bench.py's keys with `device` and
    finite numbers, having launched PATH_KERNELS[label]'s kernels and no
    other. Returns (its JSON, its launch counts, its per-frame lines)."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.time()
    sys.stdout.flush()
    res = subprocess.run([sys.executable, "-m", "splatam_tpu_torch.scripts.bench"], cwd=ROOT,
                         env=dict(os.environ, **env), capture_output=True, text=True,
                         timeout=900)
    lines = res.stderr.splitlines()
    for line in lines:
        if not line.startswith("launches: "):
            print(f"  [{label}] {line}")
    if res.returncode != 0:
        fail(f"{label}: the bench exited {res.returncode}")
    result = json.loads(res.stdout.strip().splitlines()[-1])
    numbers = [v for k, v in result.items() if isinstance(v, (int, float))]
    if set(result) != BENCH_KEYS or not all(math.isfinite(v) for v in numbers):
        fail(f"{label}: the bench's result {result}")
    launches = json.loads(next(ln for ln in lines if ln.startswith("launches: "))[10:])
    check_launches(label, launches)
    print(f"{label}: {result['value']} s/frame ({result['metric']}), frame0 "
          f"{result['frame0_s']} s, max {result['max_frame_s']} s, "
          f"{result['n_gaussians_final']} Gaussians, {result['device']}; "
          f"{time.time() - t0:.1f} s with its start", flush=True)
    return result, launches, [ln for ln in lines if ln.startswith("frame ")]


def variant_renders(view, q, t, cam, opts, cot) -> dict:
    """The three routes' renders on one binning variant's structures of
    the map at pose (q, t), forward and backward under the cotangent cot
    [6, H, W] (on the rows r, g, b, depth, silhouette, depth^2): tracking in
    pair space on the world-8 structure (K4, K5; the pose's gradient),
    mapping's fused render (K4, K5, K3-8) and the generic render with the
    3DGS harvest (K1, K2, K3-11) on the mapping structure (each Gaussian
    parameter's gradient). Returns {route: (image rows, gradient
    columns [N, k] (the pose's [4, 1] and [3, 1]) ...)} and the structures."""
    import torch

    from splatam_tpu_torch.render import api
    from splatam_tpu_torch.slam import steps

    ps_w = steps.loss_pair_structure(view, q, t, cam, with_world16=True, bin_opts=opts)
    ps_m = steps.loss_pair_structure(view, q, t, cam, bin_opts=opts)
    keys = ("means3d", "rgb_colors", "logit_opacities", "log_scales")

    def rows(out):
        return torch.cat([out.im, out.depth[None], out.silhouette[None], out.depth_sq[None]])

    def run(out, wrt):
        img = rows(out)
        grads = torch.autograd.grad(img, wrt, cot)
        return img.detach(), [g.reshape(g.shape[0], -1) for g in grads]

    res = {}
    q_, t_ = q.clone().requires_grad_(True), t.clone().requires_grad_(True)
    res["tracking"] = run(api.render_rgbd_sil_pairspace(cam, ps_w, q_, t_), (q_, t_))
    params = {k: getattr(view, k).detach().requires_grad_(True) for k in keys}
    res["mapping fused"] = run(api.render_rgbd_sil_mapping_fused(
        cam, ps_m, *params.values(), view.active, q, t), tuple(params.values()))
    params = {k: getattr(view, k).detach().requires_grad_(True) for k in keys}
    dummy = torch.zeros((view.means3d.shape[0], 2), device=q.device, requires_grad=True)
    out = steps.loss_render(view._replace(**params), q, t, cam, False, True, ps_m, dummy)
    res["generic"] = run(out, (*params.values(), dummy))
    return res, ps_w, ps_m


# The kernel whose output each route's rows come from, for its TOL
ROUTE_TOL = {"tracking": ("fused_forward", "fused_backward"),
             "mapping fused": ("fused_forward", "segment_reduce"),
             "generic": ("composite_forward", "segment_reduce11")}


def reordered_tiles(ps, ref) -> "torch.Tensor":
    """[T] bool: the tiles whose pair list differs between two structures
    of the same pairs per tile."""
    import torch

    if not torch.equal(ps.tile_start, ref.tile_start):
        fail("path 16 (c): a reordered structure holds other pairs per tile")
    diff = (ps.pair_gauss != ref.pair_gauss).to(torch.int32)
    lens = (ps.tile_start[1:] - ps.tile_start[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(lens.numel(), device=diff.device), lens)
    return torch.zeros(lens.numel(), dtype=torch.int32, device=diff.device).index_add_(
        0, tile, diff) > 0


def tile_pixels(tiles, cam) -> "torch.Tensor":
    """[H, W] bool: the pixels of the given tiles."""
    import torch

    from splatam_tpu_torch.render.binning import TILE, grid_shape

    gx, gy = grid_shape(cam.width, cam.height)
    m = tiles.reshape(gy, gx).repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)
    return m[:cam.height, :cam.width]


def gaussians_in(tiles, ps, n: int) -> "torch.Tensor":
    """[N] bool: the Gaussians with a pair in one of the given tiles."""
    import torch

    lens = (ps.tile_start[1:] - ps.tile_start[:-1]).long()
    hit = torch.repeat_interleave(tiles, lens)
    out = torch.zeros(n, dtype=torch.bool, device=tiles.device)
    out[ps.pair_gauss.long()[hit]] = True
    return out


def order_ok(ps, view, q, t, cam, direct_j: int) -> bool:
    """The structure's pairs run in the order the binning defines, from
    keys recomputed out of the map's projection: by tile, then quantized
    depth, then (direct_j = J > 0) the slots j < J before the others, then
    Gaussian index, each step strictly increasing."""
    import torch

    from splatam_tpu_torch.render import api, binning
    from splatam_tpu_torch.slam import steps

    with torch.no_grad():
        means_cam, rots_cam = steps.transform_to_frame(view, q, t, False, False)
        proj, aux = api.project_gaussians(cam, means_cam, rots_cam, view.logit_opacities,
                                          view.log_scales, view.active)
    gx, gy = binning.grid_shape(cam.width, cam.height)
    qd = binning.quantized_depth(proj.depth, binning.depth_bits_for(gx * gy), cam.far)
    lens = (ps.tile_start[1:] - ps.tile_start[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(lens.numel(), device=lens.device), lens)
    g = ps.pair_gauss.long()
    j = ((tile // gx - aux.rect_min[g, 1]) * aux.rect_wh[g, 0] + tile % gx
         - aux.rect_min[g, 0])
    key = tile * (qd.max() + 1) + qd[g]
    if direct_j:
        key = key * 2 + (j >= direct_j)
    key = key * view.means3d.shape[0] + g
    return bool((key[1:] > key[:-1]).all()) and bool(((j >= 0) & (j < aux.rect_wh[
        g, 0] * aux.rect_wh[g, 1])).all())


def compare_variant(name: str, got: dict, ref: dict, moved_px, moved_g) -> None:
    """Path 16 (c): each route's image rows and gradient columns on a
    variant's structures against those on the classic ones, by each row's
    TOL of its largest value, outside the pixels and Gaussians of tiles
    whose tied pairs the variant reorders (moved_px, moved_g; what it does
    inside them is printed, and the pose's gradient, a sum over every pair,
    is then printed only)."""
    import torch

    for route, (img, grads) in got.items():
        rimg, rgrads = ref[route]
        tol_img, tol_grad = (TOL[k] for k in ROUTE_TOL[route])
        keep = (~moved_px).to(img.dtype)
        _, rels = rel_err(img * keep, rimg * keep)
        bits = torch.equal(img, rimg)
        g_rels, g_bits = [], True
        for g, r in zip(grads, rgrads):
            rows = ~moved_g if g.shape[0] == moved_g.shape[0] else None
            gk, rk = (g, r) if rows is None else (g[rows], r[rows])
            scale = r.abs().amax(0).clamp_min(1e-30)
            g_rels.append(float(((gk - rk).abs().amax(0) / scale).max()) if gk.numel() else 0.0)
            g_bits = g_bits and torch.equal(g, r)
        inside = float((img - rimg).abs().amax()) if bool(moved_px.any()) else 0.0
        gated = [e for e, g in zip(g_rels, grads)
                 if g.shape[0] == moved_g.shape[0] or not bool(moved_px.any())]
        ok = max(rels) <= tol_img and max(gated, default=0.0) <= tol_grad
        print(f"[path 16 {name}] {route}: images worst_row_rel={max(rels):.1e} (tol "
              f"{tol_img:.0e}), equal bit for bit={bits}; gradients worst_column_rel="
              f"{max(g_rels):.1e} (tol {tol_grad:.0e}), equal bit for bit={g_bits}; "
              f"{int(moved_px.sum())} pixels in reordered tiles (max|diff| {inside:.2e}), "
              f"{int(moved_g.sum())} Gaussians with pairs there {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"path 16 (c): {route} on the {name} structures differs from the classic")


def drive_variants(final_map, device) -> dict:
    """Path 16 (c): returns the launch counts of the variants' renders."""
    import torch

    from splatam_tpu_torch.render.binning import BinOptions
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts
    from splatam_tpu_torch.slam import steps

    view, q, t, cam = final_map
    gen = torch.Generator(device).manual_seed(16)
    cot = torch.randn((6, cam.height, cam.width), device=device, generator=gen)
    reset_launch_counts()
    outs, structs = {}, {}
    for name, opts in VARIANTS.items():
        outs[name], *structs[name] = variant_renders(view, q, t, cam, BinOptions(**opts), cot)
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launches("path 16 variants", launches)
    n_classic = structs["classic"][1].n_pairs
    for name, opts in VARIANTS.items():
        ps_w, ps_m = structs[name]
        ms = event_ms(lambda o=BinOptions(**opts): steps.loss_pair_structure(
            view, q, t, cam, bin_opts=o), 5, 1)
        print(f"path 16 {name}: {ps_m.n_pairs} pairs, {ps_m.n_culled} culled "
              f"({100.0 * ps_m.n_culled / n_classic:.2f}% of {n_classic}); structure build "
              f"{ms:.3f} ms", flush=True)
    for name, opts in VARIANTS.items():
        ok = all(order_ok(ps, view, q, t, cam, opts.get("direct_j", 0))
                 for ps in structs[name])
        print(f"path 16 {name}: pairs in the binning's order, from keys recomputed out of the "
              f"projection: {ok}", flush=True)
        if not ok:
            fail(f"path 16 (c): the {name} structures are out of their order")
    for name in list(VARIANTS)[1:]:
        ps_w, ps_m = structs[name]
        moved = torch.zeros(ps_m.tile_start.numel() - 1, dtype=torch.bool, device=device)
        if name in ORDER_OF:
            ref_w, ref_m = structs[ORDER_OF[name]]
            moved = reordered_tiles(ps_m, ref_m)
            if not torch.equal(moved, reordered_tiles(ps_w, ref_w)):
                fail(f"path 16 (c): the {name} structures reorder different tiles")
            print(f"path 16 {name}: {int(moved.sum())} of {moved.numel()} tiles hold tied "
                  f"pairs it orders unlike {ORDER_OF[name]}", flush=True)
        compare_variant(name, outs[name], outs["classic"], tile_pixels(moved, cam),
                        gaussians_in(moved, ps_m, view.means3d.shape[0]))
    del outs, structs
    for name in ("tile_cull", "both"):
        x = kernel_inputs(view, q, t, cam, seed=16, bin_opts=BinOptions(**VARIANTS[name]))
        label = (f"path 16, the {name} structures, {x.ps.n_pairs} pairs (fused), "
                 f"{x.b.n_pairs} (generic)")
        cases = kernel_cases(x)
        check_cases(cases, label)
        check_repeat(cases, label)
        del x, cases
        torch.cuda.empty_cache()
    return launches


def drive_bench(final_map, device) -> dict:
    """Path 16: returns the launch counts of (a)-(d)."""
    import torch

    from splatam_tpu_torch.scripts import entry
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts

    t0 = time.time()
    launches = {}
    base, launches["path 16 bench"], _ = run_bench("path 16 bench")
    cull, launches["path 16 bench cull"], frames = run_bench("path 16 bench cull",
                                                             BENCH_TILE_CULL="1")
    shares = [ln.split("(")[-1].rstrip(")") for ln in frames]
    print(f"path 16 (b): {cull['value']} s/frame under the cull against {base['value']} "
          f"(frame0 {cull['frame0_s']} / {base['frame0_s']}, max {cull['max_frame_s']} / "
          f"{base['max_frame_s']}); culled per frame {', '.join(shares)}; "
          f"{cull['n_gaussians_final']} Gaussians against {base['n_gaussians_final']}",
          flush=True)
    if abs(cull["n_gaussians_final"] - base["n_gaussians_final"]) > 0.01 * base[
            "n_gaussians_final"]:
        fail("path 16 (b): the culled bench's final map is more than 1% off the classic one's")
    t1 = time.time()
    launches["path 16 variants"] = drive_variants(final_map, device)
    print(f"path 16 (c): {time.time() - t1:.1f} s", flush=True)

    reset_launch_counts()
    fn, args = entry.entry("cuda")
    with torch.no_grad():
        outs = fn(*args)
    torch.cuda.synchronize()
    launches["path 16 entry"] = launch_counts()
    check_launches("path 16 entry", launches["path 16 entry"])
    shapes = [tuple(o.shape) for o in outs]
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    print(f"path 16 (d): entry() on the card: {shapes}, finite={finite}, K1 launches "
          f"{launches['path 16 entry']['composite_forward']}", flush=True)
    if shapes != [(3, 128, 160), (128, 160), (128, 160)] or not finite:
        fail("path 16 (d): entry() gave the wrong shapes or non-finite values")
    print(f"path 16: {time.time() - t0:.1f} s", flush=True)
    return launches


def final_frame_of(rt, idx: int, device):
    """Frame idx of the runtime's dataset on the device (colour, depth)."""
    from splatam_tpu_torch.data import frame_to_tensors

    color_np, depth_np, _, _ = rt.dataset[idx]
    return frame_to_tensors(color_np, depth_np, device)


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
    check_repeat(kernel_cases(x), label)
    check_pair_mode(x, label)
    check_fused_modes(x, label)
    report_fused_cull(x, "fused render, " + label)
    check_cases(probe_cases(x.ps, x.pose, x.w, x.h), label, equal_to={
        "fwd2": lambda: fused_iso.fused_forward(x.ps.world8, x.pose, x.ps.tile_start, x.w, x.h)})

    work = tempfile.mkdtemp(prefix="chip_smoke_")  # the SLAM runs' directories
    atexit.register(shutil.rmtree, work, True)
    launches = {}
    rt, launches["path 1"] = drive_path("path 1", bench_config(work), FRAMES, device)

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
    check_repeat(cases, label)
    check_pair_mode(x, label)
    check_fused_modes(x, label)
    report_kernel_info()
    count_histogram(x.ps.counts, "fused path, K3 at 8 columns")
    count_histogram(x.b.counts, "generic render, K3 at 11 columns")
    times = time_turns(cases)
    time_turns(indexed_cases(x))
    library = library_k3(x)
    bounds = report_bounds(kernel_work(x), times, label)
    report_fused_cull(x, "fused render")
    del x, cases
    # paths 11 and 15 render this map (path 1's final one) at this pose
    final_map = (view, q_l, t_l, rt.cam)
    final_frame = final_frame_of(rt, FRAMES - 1, device)
    for table, loss_table in zip((errs, times, bounds, library),
                                 check_loss_kernel(final_map, final_frame)):
        table.update(loss_table)
    profile_frame(rt, FRAMES, "path 1", device)
    del rt, view
    torch.cuda.empty_cache()

    rt, launches["path 2"] = drive_path("path 2", bench_config(work, tpu={"rebin_every": 1}),
                                        FRAMES_GENERIC, device)
    profile_frame(rt, FRAMES_GENERIC, "path 2", device)
    del rt
    torch.cuda.empty_cache()

    rt, launches["path 3"] = drive_path(
        "path 3", bench_config(work, gaussian_distribution="anisotropic"), FRAMES_GENERIC,
        device)
    check_aniso_pair_rows(rt, FRAMES_GENERIC - 1, device)
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
    torch.cuda.empty_cache()

    launches.update(drive_slam(work, device, card))
    torch.cuda.empty_cache()
    real = write_trees(work)
    launches.update(drive_real(real, work, device, card))
    torch.cuda.empty_cache()
    launches.update(drive_training(real, work, device, card))
    torch.cuda.empty_cache()

    t0 = time.time()
    m = generic_map(*final_map, device)
    print(f"path 11: render_gaussians on path 1's final map, {m.view.means3d.shape[0]} Gaussians, "
          f"{m.b.n_pairs} pairs, {WIDTH}x{HEIGHT}", flush=True)
    launches["path 11"] = drive_generic(m)
    wide = check_generic_kernels(m, f"path 11, {WIDTH}x{HEIGHT}")
    for table, wide_table in zip((errs, times, bounds, library), wide):
        table.update(wide_table)
    del m
    torch.cuda.empty_cache()
    check_references(device)
    print(f"path 11: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    launches.update(drive_viewers(work, device))
    print(f"path 12: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    launches.update(drive_gauntlet(work, device, card))
    torch.cuda.empty_cache()
    print(f"path 13: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    launches.update(drive_live(work, device, card))
    torch.cuda.empty_cache()
    print(f"path 14: {time.time() - t0:.1f} s", flush=True)
    launches.update(drive_bands(work, device, final_map, final_frame))
    launches.update(drive_bench(final_map, device))
    del final_map, final_frame
    torch.cuda.empty_cache()

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
