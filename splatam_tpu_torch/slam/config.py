"""Experiment config loading and default backfill.

Two-tier config system with reference parity:
  1. Experiment configs are executable Python modules exporting a `config`
     dict, loaded with SourceFileLoader (scripts/splatam.py:999-1001).
  2. Dataset/camera YAMLs with recursive inherit_from merging
     (splatam_tpu.data.dataconfig).

`backfill_defaults` mirrors the in-code default handling at
scripts/splatam.py:455-517, plus a `tpu` section for the static-capacity
knobs this framework adds (buffer capacities, render backend).
"""
from __future__ import annotations

import os
import random
from importlib.machinery import SourceFileLoader

import numpy as np


def load_experiment_config(path: str) -> dict:
    module = SourceFileLoader(os.path.basename(path), path).load_module()
    return module.config


def seed_everything(seed: int = 42) -> None:
    """Parity: utils/common_utils.py:8-22 (python/numpy seeding; host
    sampling uses np.random)."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    print(f"Seed set to: {seed} (type: {type(seed)})")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def backfill_defaults(config: dict) -> dict:
    config = dict(config)
    tracking = config.setdefault("tracking", {})
    if "use_depth_loss_thres" not in tracking:
        tracking["use_depth_loss_thres"] = False
        tracking["depth_loss_thres"] = 100000
    tracking.setdefault("visualize_tracking_loss", False)
    tracking.setdefault("forward_prop", True)
    config.setdefault("gaussian_distribution", "isotropic")
    config.setdefault("report_iter_progress", False)
    config.setdefault("load_checkpoint", False)
    config.setdefault("checkpoint_time_idx", 0)
    config.setdefault("save_checkpoints", False)
    config.setdefault("checkpoint_interval", 100)
    config.setdefault("use_wandb", False)
    config.setdefault("eval_every", 5)
    config.setdefault("report_global_progress_every", 500)
    config.setdefault("scene_radius_depth_ratio", 3)
    config.setdefault("mean_sq_dist_method", "projective")
    config.setdefault("seed", 0)

    data = config.setdefault("data", {})
    data.setdefault("ignore_bad", False)
    data.setdefault("use_train_split", True)
    if "densification_image_height" not in data:
        data["densification_image_height"] = data["desired_image_height"]
        data["densification_image_width"] = data["desired_image_width"]
    if "tracking_image_height" not in data:
        data["tracking_image_height"] = data["desired_image_height"]
        data["tracking_image_width"] = data["desired_image_width"]

    h, w = data["desired_image_height"], data["desired_image_width"]
    tpu = config.setdefault("tpu", {})
    # Capacity for the masked Gaussian buffers: frame-0 init creates up to
    # H*W Gaussians, densification adds more; grow-on-demand handles the rest.
    tpu.setdefault("capacity", _next_pow2(int(h * w * 1.25)))
    # CEILING on the adaptive per-phase pair budget (pipeline._phase_rcfg
    # sizes the actual buffers to ~2x the live map). Pairs scale with the
    # MAP, not the image, so the ceiling must not be image-derived alone —
    # long sequences grow past h*w*2 and would silently drop pairs.
    tpu.setdefault("pair_cap", max(_next_pow2(int(h * w * 2)), 1 << 21))
    tpu.setdefault("tile_k_max", 2048)
    tpu.setdefault("backend", "auto")
    # >1 = row-shard render across that many devices
    # (parallel/spatial.py); 0/1 = single chip.
    tpu.setdefault("spatial_shards", 0)
    # Pair-structure reuse (render.api.PairStructure): tracking rebins every
    # K iterations, mapping computes one structure per distinct keyframe per
    # chunk. 1 = exact per-iteration binning (reference semantics).
    tpu.setdefault("rebin_every", 1)
    return config
