"""The final reconstruction viewer (counterpart of viz_scripts/final_recon.py).

    python -m splatam_tpu_torch.scripts.final_recon <config> [--device cpu]

Reads <workdir>/<run_name>/params.npz and renders it at the config's
`viz` size through the generic render with the config's `tpu.backend`
(render.api.render_gaussians). With open3d installed it opens the
reference's interactive point-cloud viewer with the camera frustums and
trajectory; without it (headless) it writes a 24-view orbit around the
last estimated camera to <run_dir>/viz_frames/view_###.png (data/png.py).
Runs on the card unless --device cpu is given; exits 2 when asked for the
card and there is none.
"""
from __future__ import annotations

import os

import numpy as np

from splatam_tpu_torch.data.png import write_png
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.slam.config import load_experiment_config
from splatam_tpu_torch.viz.scene import load_camera, load_scene_data, render_view, rgbd2pcd_np

N_VIEWS = 24


def to_uint8(im: np.ndarray) -> np.ndarray:
    """[3, H, W] in [0, 1] -> [H, W, 3] uint8, as the viewers write it."""
    return (im.transpose(1, 2, 0) * 255).astype(np.uint8)


def orbit_w2c(base: np.ndarray, i: int, n_views: int = N_VIEWS) -> np.ndarray:
    """View i of the orbit: base turned about its y axis by an angle from
    -0.05 pi to 0.15 pi."""
    ang = 2 * np.pi * i / n_views * 0.1 - 0.05 * np.pi
    rot = np.eye(4)
    c, s = np.cos(ang), np.sin(ang)
    rot[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return rot @ base


def make_lineset_data(all_w2cs, k, cfg):
    """Camera frustum and trajectory line segments (final_recon.py:194-223)."""
    frustum_pts, traj_pts = [], []
    scale = 0.05
    for w2c in all_w2cs:
        c2w = np.linalg.inv(w2c)
        corners = np.array([[0, 0, 0], [-scale, -scale, scale * 2], [scale, -scale, scale * 2],
                            [scale, scale, scale * 2], [-scale, scale, scale * 2]])
        frustum_pts.append(corners @ c2w[:3, :3].T + c2w[:3, 3])
        traj_pts.append(c2w[:3, 3])
    return np.stack(frustum_pts), np.stack(traj_pts)


def visualize_headless(scene_path, viz_cfg, backend, out_dir, device,
                       n_views: int = N_VIEWS) -> list:
    """Write the orbit's views as PNGs; returns their paths."""
    gm, all_w2cs, _ = load_scene_data(scene_path, device)
    w2c0, k = load_camera(viz_cfg, scene_path)
    base = all_w2cs[-1] if len(all_w2cs) else w2c0
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(n_views):
        im, _, _ = render_view(gm, orbit_w2c(base, i, n_views), k, viz_cfg, backend)
        paths.append(os.path.join(out_dir, f"view_{i:03d}.png"))
        write_png(paths[-1], to_uint8(im))
    print(f"Headless viz: wrote {n_views} rendered views to {out_dir}")
    return paths


def visualize_o3d(o3d, scene_path, viz_cfg, backend, device) -> None:
    """The reference's interactive viewer: the rendered view as a point
    cloud, re-rendered from the viewer's camera every tick."""
    gm, all_w2cs, _ = load_scene_data(scene_path, device)
    w2c, k = load_camera(viz_cfg, scene_path)
    view_scale = viz_cfg["view_scale"]
    w = int(viz_cfg["viz_w"] * view_scale)
    h = int(viz_cfg["viz_h"] * view_scale)
    view_w2c = w2c.copy()
    if viz_cfg.get("offset_first_viz_cam", True):
        view_w2c[:3, 3] += view_w2c[:3, :3].T @ np.array([0, 0, -0.5])

    vis = o3d.visualization.Visualizer()
    vis.create_window(width=w, height=h, visible=True)
    im, depth, _ = render_view(gm, view_w2c, k, viz_cfg, backend)
    pts, cols = rgbd2pcd_np(im, depth, view_w2c, k, viz_cfg)
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(pts)
    pcd.colors = o3d.utility.Vector3dVector(cols)
    vis.add_geometry(pcd)
    if viz_cfg.get("visualize_cams", True) and len(all_w2cs):
        frustums, _ = make_lineset_data(all_w2cs, k, viz_cfg)
        for fr in frustums[::max(1, len(frustums) // 100)]:
            ls = o3d.geometry.LineSet()
            ls.points = o3d.utility.Vector3dVector(fr)
            ls.lines = o3d.utility.Vector2iVector(
                np.array([[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]]))
            ls.colors = o3d.utility.Vector3dVector(np.tile([[0.2, 0.2, 0.8]], (8, 1)))
            vis.add_geometry(ls)

    view_control = vis.get_view_control()
    cparams = o3d.camera.PinholeCameraParameters()
    cparams.extrinsic = view_w2c
    cparams.intrinsic.intrinsic_matrix = k * view_scale
    cparams.intrinsic.height = h
    cparams.intrinsic.width = w
    view_control.convert_from_pinhole_camera_parameters(cparams, allow_arbitrary=True)
    while True:
        cam_params = view_control.convert_to_pinhole_camera_parameters()
        cur_w2c = np.asarray(cam_params.extrinsic)
        cur_k = np.asarray(cam_params.intrinsic.intrinsic_matrix) / view_scale
        im, depth, sil = render_view(gm, cur_w2c, cur_k, viz_cfg, backend)
        if viz_cfg.get("show_sil", False):
            im = np.tile(sil[None], (3, 1, 1))
        pts, cols = rgbd2pcd_np(im, depth, cur_w2c, cur_k, viz_cfg)
        pcd.points = o3d.utility.Vector3dVector(pts)
        pcd.colors = o3d.utility.Vector3dVector(cols)
        vis.update_geometry(pcd)
        if not vis.poll_events():
            break
        vis.update_renderer()
    vis.destroy_window()


def open3d_or_none():
    try:
        import open3d
    except ImportError:
        return None
    return open3d


def main(argv=None):
    """The viewer; headless, the list of PNGs written."""
    ap = harness.parser(__doc__)
    ap.add_argument("experiment", type=str, help="Path to experiment file")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "final_recon")
    config = load_experiment_config(args.experiment)
    run_dir = os.path.join(config["workdir"], config["run_name"])
    scene_path = os.path.join(run_dir, "params.npz")
    backend = config.get("tpu", {}).get("backend", "auto")
    o3d = open3d_or_none()
    if o3d is not None:
        return visualize_o3d(o3d, scene_path, config["viz"], backend, device)
    print("Open3D not available; rendering headless views instead.")
    return visualize_headless(scene_path, config["viz"], backend,
                              os.path.join(run_dir, "viz_frames"), device)


if __name__ == "__main__":
    main()
