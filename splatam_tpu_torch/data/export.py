"""Write the synthetic sequence to disk in a real dataset's layout, so the
real-format loaders and the configs that name them can run where no
dataset is shipped (chip_smoke.py's paths 5-7, the tests). Images go
through png.write_png: no imaging library is needed.

    ds = synthetic_sequence(9, 680, 1200, fx=600.0, fy=600.0, cx=599.5, cy=339.5)
    write_replica_v2("data/Replica_V2/room_0", ds, train=range(0, 9, 2),
                     test=range(1, 9, 2))

Colour is stored as uint8 (rounded), depth as uint16 (metres times the
format's scale, rounded), the pose as the frame's camera-to-world matrix.
"""
from __future__ import annotations

import os

import numpy as np

from splatam_tpu_torch.data.png import write_png
from splatam_tpu_torch.data.synthetic import SyntheticDataset


def synthetic_sequence(num_frames: int, height: int, width: int, fx: float, fy: float,
                       cx: float, cy: float) -> SyntheticDataset:
    """The synthetic sequence (seed 0) rendered through the camera (fx, fy,
    cx, cy) at height x width, e.g. a dataset YAML's camera."""
    ds = SyntheticDataset(num_frames=num_frames, height=height, width=width)
    ds.fx, ds.fy, ds.cx, ds.cy = float(fx), float(fy), float(cx), float(cy)
    return ds


def _write_frame(ds: SyntheticDataset, i: int, color_path: str, depth_path: str,
                 depth_scale: float) -> np.ndarray:
    """Render frame i, write its two PNGs; returns its c2w."""
    color, depth = ds.render_frame(ds.poses[i])
    write_png(color_path, np.clip(np.rint(color), 0, 255).astype(np.uint8))
    d = np.clip(np.rint(depth[..., 0].astype(np.float64) * depth_scale), 0, 65535)
    write_png(depth_path, d.astype(np.uint16))
    return ds.poses[i]


def _write_split(folder: str, ds: SyntheticDataset, frames, depth_scale: float) -> None:
    os.makedirs(os.path.join(folder, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(folder, "depth"), exist_ok=True)
    poses = [_write_frame(ds, i, os.path.join(folder, "rgb", f"rgb_{k}.png"),
                          os.path.join(folder, "depth", f"depth_{k}.png"), depth_scale)
             for k, i in enumerate(frames)]
    with open(os.path.join(folder, "traj_w_c.txt"), "w") as f:
        for c2w in poses:
            f.write(" ".join(repr(float(v)) for v in np.asarray(c2w).reshape(-1)) + "\n")


def write_replica_v2(scene_dir: str, ds: SyntheticDataset, train, test=(),
                     depth_scale: float = 1000.0) -> None:
    """Replica-V2 (vMAP) layout: imap/00 holds the frames `train` of ds,
    imap/01 the held-out frames `test` (rgb/rgb_i.png, depth/depth_i.png,
    traj_w_c.txt with one row-major c2w per line)."""
    _write_split(os.path.join(scene_dir, "imap", "00"), ds, list(train), depth_scale)
    if len(test):
        _write_split(os.path.join(scene_dir, "imap", "01"), ds, list(test), depth_scale)


# TUM stamps: colour at 30 Hz from freiburg1_desk's first stamp; each depth
# image 6 ms before its colour frame, each ground-truth pose 4 ms after.
TUM_T0, TUM_FPS, TUM_DEPTH_OFFSET, TUM_POSE_OFFSET = 1305031452.791720, 30.0, -0.006, 0.004


def write_tum(seq_dir: str, ds: SyntheticDataset, depth_scale: float = 5000.0) -> None:
    """TUM RGB-D layout: rgb/ and depth/ named by timestamp, rgb.txt and
    depth.txt (three `#` header lines, `stamp path`), groundtruth.txt
    (`stamp tx ty tz qx qy qz qw`), each depth image and pose on stamps of
    their own."""
    from scipy.spatial.transform import Rotation

    os.makedirs(os.path.join(seq_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(seq_dir, "depth"), exist_ok=True)
    rgb, depth, gt = [], [], []
    for i in range(len(ds)):
        t = TUM_T0 + i / TUM_FPS
        c_name, d_name = f"rgb/{t:.6f}.png", f"depth/{t + TUM_DEPTH_OFFSET:.6f}.png"
        c2w = _write_frame(ds, i, os.path.join(seq_dir, c_name), os.path.join(seq_dir, d_name),
                           depth_scale)
        rgb.append(f"{t:.6f} {c_name}")
        depth.append(f"{t + TUM_DEPTH_OFFSET:.6f} {d_name}")
        q = Rotation.from_matrix(np.asarray(c2w[:3, :3], np.float64)).as_quat()
        gt.append(f"{t + TUM_POSE_OFFSET:.6f} " + " ".join(f"{v:.9f}" for v in (*c2w[:3, 3], *q)))
    bag = os.path.basename(os.path.normpath(seq_dir))
    for name, title, rows in (("rgb.txt", "color images", rgb),
                              ("depth.txt", "depth maps", depth),
                              ("groundtruth.txt", "ground truth trajectory", gt)):
        fields = "timestamp tx ty tz qx qy qz qw" if name == "groundtruth.txt" \
            else "timestamp filename"
        with open(os.path.join(seq_dir, name), "w") as f:
            f.write(f"# {title}\n# file: '{bag}.bag'\n# {fields}\n")
            f.write("\n".join(rows) + "\n")
