"""What the map viewers share: params.npz loading and the render of a view.

Counterpart of splatam_tpu/viz/scene.py (the reference's
viz_scripts/final_recon.py:25-169: load_camera, load_scene_data, render,
rgbd2pcd). A view renders through the generic render (eval.evaluate
render_at_w2c, with the backend the caller names) on the map's device.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_tpu_torch.core.camera import setup_camera
from splatam_tpu_torch.core.gaussians import from_params_dict
from splatam_tpu_torch.core.transforms import build_rotation
from splatam_tpu_torch.eval.evaluate import render_at_w2c


def load_camera(cfg: dict, scene_path: str):
    """The first frame's w2c [4, 4] and the intrinsics [3, 3] scaled to the
    viewer's viz_w x viz_h (float64)."""
    params = dict(np.load(scene_path, allow_pickle=True))
    w2c = np.asarray(params["w2c"], np.float64)
    k = np.asarray(params["intrinsics"], np.float64)[:3, :3].copy()
    k[0, :] *= cfg["viz_w"] / params["org_width"]
    k[1, :] *= cfg["viz_h"] / params["org_height"]
    return w2c, k


def estimated_w2cs(params: dict) -> list:
    """Each frame's estimated w2c [4, 4] float32 from the saved camera
    rotations and translations."""
    cam_rots = np.asarray(params["cam_unnorm_rots"])[0]  # [4, F]
    cam_trans = np.asarray(params["cam_trans"])[0]  # [3, F]
    all_w2cs = []
    for t_i in range(cam_rots.shape[-1]):
        q = cam_rots[:, t_i]
        q = q / np.linalg.norm(q)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = build_rotation(torch.as_tensor(q, dtype=torch.float32)[None])[0].numpy()
        w2c[:3, 3] = cam_trans[:, t_i]
        all_w2cs.append(w2c)
    return all_w2cs


def load_scene_data(scene_path: str, device="cuda"):
    """(GaussianMap on `device`, each frame's estimated w2c [4, 4] float32,
    the params dict)."""
    params = dict(np.load(scene_path, allow_pickle=True))
    return from_params_dict(params, device), estimated_w2cs(params), params


def render_view(gm, w2c, k, cfg, backend: str = "auto", white_bg: bool = True):
    """(im [3, H, W] in [0, 1], depth [H, W], sil [H, W]) as numpy at an
    arbitrary view. The reference renders RGB against a white background
    (final_recon.py:110-122); since silhouette = 1 - T_final, the
    background is added afterwards as im + (1 - sil)."""
    cam = setup_camera(cfg["viz_w"], cfg["viz_h"], k, None, cfg.get("viz_near", 0.01),
                       cfg.get("viz_far", 100.0))
    out = render_at_w2c(gm, np.asarray(w2c, np.float32), cam, backend)
    im, sil = out.im.cpu().numpy(), out.silhouette.cpu().numpy()
    if white_bg:
        im = im + (1.0 - sil)[None]
    return np.clip(im, 0, 1), out.depth.cpu().numpy(), sil


def rgbd2pcd_np(color, depth, w2c, k, cfg):
    """Backproject a rendered RGB-D view to a coloured point cloud (numpy;
    final_recon.py:130-169, the depth-colormap render mode included, which
    needs matplotlib)."""
    height, width = depth.shape
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    xx = (xx - k[0][2]) / k[0][0]
    yy = (yy - k[1][2]) / k[1][1]
    z = depth.reshape(-1)
    pts_cam = np.stack([xx.reshape(-1) * z, yy.reshape(-1) * z, z], axis=-1)
    c2w = np.linalg.inv(w2c)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]

    if cfg.get("render_mode") == "depth":
        import matplotlib.pyplot as plt

        cols = z.copy()
        bg_mask = (cols < 15).astype(np.float64)
        cols = cols * bg_mask
        cnorm = plt.Normalize(vmin=0, vmax=cols.max() if cols.max() > 0 else 1)
        cols = plt.cm.ScalarMappable(norm=cnorm, cmap=plt.get_cmap("jet")).to_rgba(cols)[:, :3]
        cols = cols * bg_mask[:, None] + (1 - bg_mask[:, None]) * 1.0
    else:
        cols = color.transpose(1, 2, 0).reshape(-1, 3)
    return pts, cols
