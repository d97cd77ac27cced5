"""Quality gauntlet: long rotation-heavy synthetic SLAM with hard ATE/PSNR
floors (counterpart of scripts/gauntlet.py).

    python -m splatam_tpu_torch.scripts.gauntlet [--frames 120] [--h 240] [--w 320]
        [--variant clean|noise|loop|scan|replica|both|all] [--rebin 8]
        [--track_iters 60] [--map_iters 60] [--bootstrap frames:iters]
        [--cur_prob p] [--c2f 4:10,2:10] [--direct_j J] [--tile_cull] [--workdir DIR]
        [--device cpu]

The reference validates itself by its end-of-run metrics on Replica, TUM
and ScanNet, which the repo does not ship; this is the falsifiable
stand-in: a 120-frame 320x240 procedural sequence with rotation-heavy
motion, run end to end through rgbd_slam with full tracking (never the
ground-truth poses), in variants (clean, depth noise, an out-and-back
loop, a three-leg scan, Replica conditions). `all` runs clean, noise and
scan; `both` clean and noise. Each variant passes when ATE < its floor
and PSNR >= its floor (THRESHOLDS); results go to
<workdir>/gauntlet_results.json, PASS/FAIL is printed per variant, and
the process exits 1 when a floor breaks. Runs on the card unless
--device cpu is given; exits 2 when asked for the card and there is none.

Departures from the JAX script:
- its GAUNTLET_MAP_ITERS, GAUNTLET_BOOTSTRAP and GAUNTLET_CUR_PROB
  environment variables are the flags --map_iters, --bootstrap
  frames:iters and --cur_prob here; they set the same config keys, and
  the port reads no environment variable;
- --direct_j and --tile_cull set tpu.direct_j and tpu.tile_cull, as the
  JAX script's do (scripts/gauntlet.py:188-191);
- --cpu is --device cpu;
- --workdir defaults to ./experiments/gauntlet (the JAX script's is under
  /tmp).
"""
from __future__ import annotations

import json
import os
import sys
import time

from splatam_tpu_torch.scripts import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The JAX script's floors, unchanged (scripts/gauntlet.py:35-76), calibrated
# on a TPU v5e about 25% beyond its best measured results at 320x240,
# rebin 8, 60 tracking iterations (clean 1.21 cm / 41.0 dB, noise
# 0.83-0.91 cm / 43.7 dB); GAUNTLET.md has the drift study behind them.
THRESHOLDS = {
    "clean": {"ate_cm": 1.5, "psnr": 35.0},
    "noise": {"ate_cm": 1.2, "psnr": 38.0},
    # Out and back over mapped views (trajectory "loop"): the return leg
    # freezes the drift but cannot cancel the outward leg's integral, so
    # ATE sits near the clean pan's (measured 1.06 cm on the TPU).
    "loop": {"ate_cm": 1.35, "psnr": 35.0},
    # Three sweeps (trajectory "scan"): drift integrates over the first leg
    # only, then every frame revisits mapped territory (measured 0.549 cm).
    # Re-densification at inter-leg pose offsets double-surfaces the
    # thrice-visited angles, hence the lower PSNR floor (measured 26.7).
    "scan": {"ate_cm": 0.7, "psnr": 25.0},
    # Replica conditions at 1200x680: half the clean motion per frame,
    # 40 tracking / 60 mapping iterations. The floor is the north star
    # itself (<= 0.4 cm, >= 34 dB, BASELINE.md), not a calibrated margin;
    # the TPU record (0.834 cm) does not meet it either. Run with
    # --variant replica --h 680 --w 1200 --track_iters 40.
    "replica": {"ate_cm": 0.4, "psnr": 34.0},
}
VARIANTS = {"all": ["clean", "noise", "scan"], "both": ["clean", "noise"]}
# The micro-gauntlets (tests/test_gauntlet.py): 160x120, rebin 8, 60/60
# iterations, with their floors. clean, 30 frames: calibrated on the CPU at
# 2.633 cm / 37.87 dB, floors ~25% out. scan, 39 frames at motion_scale 1.0
# (2.0's apex velocity reversal breaks tracking at 160x120): calibrated on
# a TPU v5e at 1.295 cm / 42.2 dB, floors ~35% out.
MICRO_HW = (120, 160)
MICRO = {
    "clean": {"frames": 30, "overrides": None, "ate_cm": 3.3, "psnr": 35.0},
    "scan": {"frames": 39, "overrides": {"data": {"motion_scale": 1.0}}, "ate_cm": 1.8,
             "psnr": 37.0},
}


def variant_config(name: str, frames: int, h: int, w: int, rebin: int, workdir: str,
                   track_iters: int = 60, overrides: dict | None = None,
                   map_iters: int = 60, bootstrap: tuple | None = None,
                   cur_prob: float | None = None) -> dict:
    """The variant's experiment config: configs/synthetic/splatam.py with
    the JAX run_variant's changes (scripts/gauntlet.py:79-160). overrides
    merge two levels deep ({"tracking": {"lrs": ...}} updates a section);
    bootstrap = (frames, iterations) front-loads the mapping budget."""
    from splatam_tpu_torch.slam.config import load_experiment_config

    config = load_experiment_config(os.path.join(ROOT, "configs", "synthetic", "splatam.py"))
    config["workdir"] = workdir
    config["run_name"] = f"gauntlet_{name}"
    data = config["data"]
    data["desired_image_height"] = h
    data["desired_image_width"] = w
    data["num_frames"] = frames
    # ~60 degrees of view sweep: enough that constant-velocity init and
    # tracking are exercised, with a map of a few hundred thousand Gaussians.
    data["motion_scale"] = 2.0
    if name == "replica":
        data["motion_scale"] = 0.5
        data["texture_octaves"] = 3
    # Tracking lr annealing: constant-lr Adam orbits the minimum at an
    # lr-proportional radius, a per-frame floor that accumulates as drift.
    config["tracking"]["lr_decay_frac"] = 0.05
    if name in ("loop", "scan"):
        data["trajectory"] = name
    if name == "noise":
        # TUM-like sensor noise; the 10x-median outlier threshold (~20 cm
        # here) stays well above it.
        data["depth_noise_sigma"] = 0.01
    # The reference scales tracking iterations with the motion per frame
    # (Replica 40 at ~0.25 deg/frame); this sequence moves ~2x Replica.
    config["tracking"]["num_iters"] = track_iters
    config["tracking"]["use_gt_poses"] = False
    config["mapping"]["num_iters"] = map_iters
    if bootstrap:
        config["mapping"]["bootstrap_frames"] = int(bootstrap[0])
        config["mapping"]["bootstrap_num_iters"] = int(bootstrap[1])
    if cur_prob is not None:
        config["mapping"]["current_frame_prob"] = float(cur_prob)
    config["mapping_window_size"] = 24
    config["keyframe_every"] = 5
    config["eval_every"] = 5
    config["report_global_progress_every"] = 25
    config.setdefault("tpu", {})
    config["tpu"]["rebin_every"] = rebin
    for k, v in (overrides or {}).items():
        if isinstance(v, dict) and isinstance(config.get(k), dict):
            config[k].update(v)
        else:
            config[k] = v
    return config


def run_variant(name: str, frames: int, h: int, w: int, rebin: int, workdir: str,
                track_iters: int = 60, overrides: dict | None = None, device="cuda",
                **knobs) -> dict:
    """rgbd_slam on variant_config(...) (knobs: map_iters, bootstrap,
    cur_prob), seeded from the config's seed; its metrics with wall_s."""
    from splatam_tpu_torch.slam.config import seed_everything
    from splatam_tpu_torch.slam.pipeline import rgbd_slam

    config = variant_config(name, frames, h, w, rebin, workdir, track_iters, overrides,
                            **knobs)
    seed_everything(int(config.get("seed", 0)))
    t0 = time.time()
    metrics = rgbd_slam(config, device)
    metrics["wall_s"] = round(time.time() - t0, 1)
    return metrics


def run_micro(name: str, workdir: str, device="cuda", track_iters: int = 60) -> dict:
    """The micro-gauntlet `name` (MICRO) through run_variant; its metrics
    with `pass` (ATE < and PSNR >= its floors)."""
    micro = MICRO[name]
    m = run_variant(name, micro["frames"], *MICRO_HW, 8, workdir, track_iters,
                    overrides=micro["overrides"], device=device)
    m["pass"] = m["ate_rmse"] * 100 < micro["ate_cm"] and m["psnr"] >= micro["psnr"]
    return m


def parse_levels(spec: str) -> list:
    """'4:10,2:10' -> [[4, 10], [2, 10]]."""
    return [[int(f), int(n)] for f, n in (lv.split(":") for lv in spec.split(","))]


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=320)
    ap.add_argument("--rebin", type=int, default=8)
    ap.add_argument("--track_iters", type=int, default=60)
    ap.add_argument("--map_iters", type=int, default=60)
    ap.add_argument("--bootstrap", default="", help="frames:iters of front-loaded mapping")
    ap.add_argument("--cur_prob", type=float, default=None,
                    help="mapping.current_frame_prob")
    ap.add_argument("--variant", default="all",
                    choices=["clean", "noise", "loop", "scan", "replica", "both", "all"])
    ap.add_argument("--workdir", default="./experiments/gauntlet")
    ap.add_argument("--c2f", default="",
                    help="coarse-to-fine levels 'factor:iters,...', e.g. '4:10,2:10'")
    ap.add_argument("--c2f_stride", action="store_true",
                    help="strided c2f downsample instead of average pooling")
    ap.add_argument("--c2f_extra", action="store_true",
                    help="run coarse iters on top of track_iters instead of within")
    ap.add_argument("--direct_j", type=int, default=0,
                    help="tpu.direct_j: the J-slot pair order (render/binning.py)")
    ap.add_argument("--tile_cull", action="store_true",
                    help="exact alpha-cutoff (gaussian, tile) pair culling")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "gauntlet")

    overrides: dict = {}
    if args.direct_j:
        overrides.setdefault("tpu", {})["direct_j"] = args.direct_j
    if args.tile_cull:
        overrides.setdefault("tpu", {})["tile_cull"] = True
    if args.c2f:
        overrides["tracking"] = {
            "coarse_to_fine": {"enabled": True, "levels": parse_levels(args.c2f),
                               "downsample": "stride" if args.c2f_stride else "pool"},
            "c2f_extra_iters": bool(args.c2f_extra),
        }
    knobs = dict(map_iters=args.map_iters, cur_prob=args.cur_prob,
                 bootstrap=tuple(args.bootstrap.split(":")) if args.bootstrap else None)

    results, failures = {}, []
    for name in VARIANTS.get(args.variant, [args.variant]):
        print(f"\n===== gauntlet variant: {name} =====")
        m = run_variant(name, args.frames, args.h, args.w, args.rebin, args.workdir,
                        args.track_iters, overrides=overrides, device=device, **knobs)
        ate_cm = m["ate_rmse"] * 100
        th = THRESHOLDS[name]
        ok = ate_cm < th["ate_cm"] and m["psnr"] >= th["psnr"]
        results[name] = {
            "ate_cm": round(ate_cm, 4),
            "psnr": round(m["psnr"], 3),
            "depth_l1_cm": round(m["depth_l1"] * 100, 4),
            "ms_ssim": round(m["ms_ssim"], 4),
            # canonical `lpips` only with the pretrained weights, else `lpips_synthetic`
            **{k: round(m[k], 4) for k in ("lpips", "lpips_synthetic") if k in m},
            "lpips_calibration": m.get("lpips_calibration", "unavailable"),
            "wall_s": m["wall_s"],
            "runtime": m.get("runtime", {}),
            "thresholds": th,
            "device": harness.describe(device),
            "pass": ok,
        }
        if not ok:
            failures.append(name)
        print(f"[{name}] ATE {ate_cm:.3f} cm (< {th['ate_cm']}), "
              f"PSNR {m['psnr']:.2f} (>= {th['psnr']}) -> {'PASS' if ok else 'FAIL'}")

    out_path = os.path.join(args.workdir, "gauntlet_results.json")
    os.makedirs(args.workdir, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nresults -> {out_path}")
    print(json.dumps(results, indent=2))
    if failures:
        print(f"GAUNTLET FAILED: {failures}")
        sys.exit(1)
    print("GAUNTLET PASSED")
    return results


if __name__ == "__main__":
    main()
