"""params.npz save/load — the interchange format consumed by eval, viz,
post-opt, and PLY export.

A copy of splatam_tpu/io/params_io.py (numpy only; importing that module
would also import jax, through splatam_tpu/__init__.py), so both packages
write and read the same files.

Schema parity: scripts/splatam.py:973-986 and utils/common_utils.py:25-52:
  means3D [N,3], rgb_colors [N,3], unnorm_rotations [N,4],
  logit_opacities [N,1], log_scales [N,S], cam_unnorm_rots [1,4,F],
  cam_trans [1,3,F], timestep [N], intrinsics [3,3], w2c [4,4],
  org_width, org_height, gt_w2c_all_frames [F,4,4],
  keyframe_time_indices [K].
"""
from __future__ import annotations

import os

import numpy as np


def params2cpu(params: dict) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def save_params(output_params: dict, output_dir: str) -> None:
    """Parity: utils/common_utils.py:35-43."""
    params = params2cpu(output_params)
    os.makedirs(output_dir, exist_ok=True)
    np.savez(os.path.join(output_dir, "params.npz"), **params)


def save_params_ckpt(output_params: dict, output_dir: str, time_idx: int) -> None:
    """Parity: utils/common_utils.py:45-52."""
    params = params2cpu(output_params)
    os.makedirs(output_dir, exist_ok=True)
    np.savez(os.path.join(output_dir, f"params{time_idx}.npz"), **params)


def load_params(path: str) -> dict:
    return dict(np.load(path, allow_pickle=True))
