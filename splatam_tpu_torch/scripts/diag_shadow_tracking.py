"""Diagnostic: single-frame tracking error against a drift-free map
(counterpart of scripts/diag_shadow_tracking.py).

    python -m splatam_tpu_torch.scripts.diag_shadow_tracking [--frames 60] [--h 120]
        [--w 160] [--iters 60] [--lr_decay 0.05] [--c2f 4:10,2:10] [--device cpu]

Runs SLAM with ground-truth poses feeding densification and mapping, and
ALSO runs the tracker each frame from the constant-velocity init taken
from the ground truth, in SHADOW: its estimate is measured against the
ground truth, then discarded. This splits the gauntlet's trajectory error
into the estimator's bias and noise (the per-frame shadow error measured
here) and feedback accumulation (everything else: full-SLAM drift minus
this). Prints each frame's error and the summary (mean, median, p90, max
in cm and degrees). Runs on the card unless --device cpu is given; exits 2
when asked for the card and there is none. The JAX script's --direct_j
selects a binning variant the port left out on purpose (ROADMAP,
section 1): it exits 2 saying so. --workdir defaults to
./experiments/shadow (the JAX script's is under /tmp).
"""
from __future__ import annotations

import os

import numpy as np

from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.scripts.gauntlet import ROOT, parse_levels


def shadow_config(frames: int = 60, h: int = 120, w: int = 160, iters: int = 60,
                  lr_decay: float = 0.05, workdir: str = "./experiments/shadow",
                  c2f: list | None = None, c2f_stride: bool = False,
                  c2f_extra: bool = False) -> dict:
    """configs/synthetic/splatam.py with the JAX script's changes
    (scripts/diag_shadow_tracking.py:52-78)."""
    from splatam_tpu_torch.slam.config import load_experiment_config

    config = load_experiment_config(os.path.join(ROOT, "configs", "synthetic", "splatam.py"))
    config["workdir"] = workdir
    config["data"]["desired_image_height"] = h
    config["data"]["desired_image_width"] = w
    config["data"]["num_frames"] = frames
    config["data"]["motion_scale"] = 2.0
    config["tracking"]["num_iters"] = iters
    config["tracking"]["lr_decay_frac"] = lr_decay
    config["mapping"]["num_iters"] = 60
    config["mapping_window_size"] = 24
    config["keyframe_every"] = 5
    config.setdefault("tpu", {})["rebin_every"] = 8
    if c2f:
        config["tracking"]["coarse_to_fine"] = {
            "enabled": True, "levels": c2f, "downsample": "stride" if c2f_stride else "pool"}
        config["tracking"]["c2f_extra_iters"] = bool(c2f_extra)
    return config


def _errors(est_w2c: np.ndarray, gt_w2c: np.ndarray) -> tuple[float, float]:
    """(camera-centre distance in cm, rotation angle in degrees)."""
    c2w_e, c2w_g = np.linalg.inv(est_w2c), np.linalg.inv(gt_w2c)
    et = np.linalg.norm(c2w_e[:3, 3] - c2w_g[:3, 3]) * 100
    d_rot = c2w_e[:3, :3] @ c2w_g[:3, :3].T
    er = np.degrees(np.arccos(np.clip((np.trace(d_rot) - 1) / 2, -1, 1)))
    return float(et), float(er)


def shadow_errors(config: dict, device="cuda", log=print) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame shadow tracking errors of frames 1.. (cm, degrees), each
    frame tracked from the ground truth's constant-velocity init on a map
    built at the ground-truth poses (scripts/diag_shadow_tracking.py:80-135),
    through the runtime's own phases and keyframe store."""
    from splatam_tpu_torch.data import frame_to_tensors
    from splatam_tpu_torch.slam.config import seed_everything
    from splatam_tpu_torch.slam.pipeline import SLAMRuntime, _w2c_from_qt

    seed_everything(0)
    rt = SLAMRuntime(config, device)
    errs_t, errs_r = [], []
    for time_idx in range(rt.num_frames):
        color_np, depth_np, _, gt_pose = rt.dataset[time_idx]
        gt_w2c = np.linalg.inv(gt_pose)
        rt.gt_w2c_all.append(gt_w2c)
        color, depth = frame_to_tensors(color_np, depth_np, rt.device)
        if time_idx > 0:
            # Constant-velocity init from the ground truth: on a drift-free
            # map the init error is exactly the motion model's.
            prev = np.linalg.inv(rt.gt_w2c_all[time_idx - 1])
            init_c2w = prev
            if time_idx > 1:
                pprev = np.linalg.inv(rt.gt_w2c_all[time_idx - 2])
                init_c2w = prev @ np.linalg.inv(pprev) @ prev
            rt.set_gt_pose(time_idx, np.linalg.inv(init_c2w))
            rt.compact()
            rt.track_frame(time_idx, color, depth)
            et, er = _errors(_w2c_from_qt(rt.cam_rots[time_idx], rt.cam_trans[time_idx]), gt_w2c)
            errs_t.append(et)
            errs_r.append(er)
            log(f"frame {time_idx}: shadow err {et:.4f} cm / {er:.4f} deg")
        # The ground-truth pose goes forward; the tracker's is discarded.
        rt.set_gt_pose(time_idx, gt_w2c)
        if time_idx > 0:
            rt.densify_frame(time_idx, color, depth)
        selected = rt.select_keyframes(time_idx, depth_np)
        rt._stage_keyframe(rt.kf_scratch_slot, color_np, depth_np)
        rt.map_frame(time_idx, selected)
        if time_idx == 0 or (time_idx + 1) % config["keyframe_every"] == 0:
            rt.add_keyframe(time_idx, color_np, depth_np)
    return np.array(errs_t), np.array(errs_r)


def summary(t: np.ndarray, r: np.ndarray) -> str:
    """The JAX script's closing lines."""
    return (f"\nshadow tracking error over {len(t)} frames (map built with GT poses):\n"
            f"  translation cm: mean {t.mean():.4f}  median {np.median(t):.4f}  "
            f"p90 {np.percentile(t, 90):.4f}  max {t.max():.4f}\n"
            f"  rotation deg:   mean {r.mean():.4f}  median {np.median(r):.4f}  "
            f"p90 {np.percentile(r, 90):.4f}  max {r.max():.4f}\n"
            f"  signed mean (drift direction indicator): see per-frame log")


def main(argv=None) -> tuple[np.ndarray, np.ndarray]:
    ap = harness.parser(__doc__)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--h", type=int, default=120)
    ap.add_argument("--w", type=int, default=160)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--lr_decay", type=float, default=0.05)
    ap.add_argument("--workdir", default="./experiments/shadow")
    ap.add_argument("--c2f", default="",
                    help="coarse-to-fine levels 'factor:iters,...', e.g. '4:10,2:10'")
    ap.add_argument("--c2f_stride", action="store_true",
                    help="strided c2f downsample instead of average pooling")
    ap.add_argument("--c2f_extra", action="store_true",
                    help="run coarse iters on top of --iters instead of within")
    ap.add_argument("--direct_j", type=int, default=0, help="not ported (exits 2)")
    args = ap.parse_args(argv)
    if args.direct_j:
        ap.error("--direct_j selects a binning variant the port left out on purpose "
                 "(ROADMAP, section 1)")
    device = harness.resolve_device(args.device, "diag_shadow_tracking")
    config = shadow_config(args.frames, args.h, args.w, args.iters, args.lr_decay,
                           args.workdir, parse_levels(args.c2f) if args.c2f else None,
                           args.c2f_stride, args.c2f_extra)
    t, r = shadow_errors(config, device)
    print(summary(t, r))
    return t, r


if __name__ == "__main__":
    main()
