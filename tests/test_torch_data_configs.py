"""The repo's real-dataset configs in the port, on trees written at their
YAML's size.

A working directory holds a `configs` link to the repo's configs and a
`data/` (or `experiments/`) tree, so each config runs with its relative
paths as written.

- configs/replica_v2/splatam.py and configs/tum/splatam.py end to end
  against the JAX package (rgbd_slam's frame order, tests/test_torch_slam.py's
  harness). The trees are the synthetic scene rendered through the YAML's
  camera (Replica-V2 1200x680 at 1000 per m; TUM freiburg1_desk 640x480 at
  5000 per m, with TUM's timestamp files), written by data/export.py. Cuts:
  desired_image_* 48x64, 3 frames, 6 tracking and 8 mapping iterations, and
  the JAX runtime's CPU render backend (tpu section); rebin_every stays 1 as
  the configs leave it. Poses within 1e-4 and equal active counts.
- SLAMRuntime(load_experiment_config(p), "cpu") starts, with no refusal,
  for configs/{replica,replica_v2,tum,scannet,scannetpp}/splatam.py,
  configs/replica/splatam_s.py and configs/iphone/splatam.py, each on a
  two-frame tree in its format at its YAML's (or capture's) size.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from splatam_tpu_torch.data.export import synthetic_sequence, write_replica_v2, write_tum
from splatam_tpu_torch.slam.config import load_experiment_config
from splatam_tpu_torch.slam.pipeline import SLAMRuntime
from splatam_tpu.core.gaussians import compact_to_numpy as j_compact
from splatam_tpu_torch.core.gaussians import compact_to_numpy
from test_torch_slam import run_both

torch.set_num_threads(1)  # see tests/test_torch_slam.py

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FRAMES = 3


def _workdir(root):
    os.makedirs(root, exist_ok=True)
    if not os.path.exists(os.path.join(root, "configs")):
        os.symlink(os.path.join(REPO, "configs"), os.path.join(root, "configs"))
    return root


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """Replica-V2 room_0 and TUM freiburg1_desk trees of the synthetic scene,
    at their YAMLs' sizes and cameras."""
    root = _workdir(str(tmp_path_factory.mktemp("rendered")))
    ds = synthetic_sequence(FRAMES, 680, 1200, fx=600.0, fy=600.0, cx=599.5, cy=339.5)
    write_replica_v2(os.path.join(root, "data", "Replica_V2", "room_0"), ds, range(FRAMES))
    ds = synthetic_sequence(FRAMES, 480, 640, fx=517.3, fy=516.5, cx=318.6, cy=255.3)
    write_tum(os.path.join(root, "data", "TUM_RGBD", "rgbd_dataset_freiburg1_desk"), ds)
    return root


def _cut(path):
    def make(tmp_path):
        config = load_experiment_config(os.path.join("configs", path))
        config["data"].update(desired_image_height=48, desired_image_width=64,
                              num_frames=FRAMES)
        config["tracking"]["num_iters"] = 6
        config["mapping"]["num_iters"] = 8
        config["tpu"] = dict(capacity=1 << 13, pair_cap=1 << 15, tile_k_max=2048,
                             backend="tiles")
        return config
    return make


@pytest.mark.parametrize("path", ["replica_v2/splatam.py", "tum/splatam.py"])
def test_real_config_matches_jax(rendered, monkeypatch, path):
    monkeypatch.chdir(rendered)
    for var in ("SCENE_NUM", "SEED"):
        monkeypatch.delenv(var, raising=False)
    rt, jrt, t_active, j_active = run_both(rendered, make_config=_cut(path))
    assert rt.rebin_every == 1 and len(rt.dataset) == FRAMES
    assert (rt.cam.height, rt.cam.width) == (48, 64)
    assert t_active == j_active
    np.testing.assert_allclose(rt.cam_rots, jrt.cam_rots, atol=1e-4)
    np.testing.assert_allclose(rt.cam_trans, jrt.cam_trans, atol=1e-4)
    assert np.abs(rt.cam_trans[-1]).max() > 1e-3  # the camera moved
    assert [k["id"] for k in rt.keyframe_list] == [k["id"] for k in jrt.keyframe_list]
    # Map means: Adam (eps 1e-15) turns a float-noise gradient into a full
    # lr-sized step, so an entry may differ by up to lr per iteration
    # (tests/test_torch_slam.py's bound).
    diff = np.abs(compact_to_numpy(rt.gm)["means3D"] - j_compact(jrt.gm)["means3D"])
    cfg_m = rt.config["mapping"]
    assert diff.max() <= cfg_m["lrs"]["means3D"] * cfg_m["num_iters"] * FRAMES, diff.max()


# ---- two-frame trees for the construction check ----------------------------

def _images(h, w, depth_scale, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    color = np.stack([xx * 255 // w, yy * 255 // h, rng.integers(0, 256, (h, w))],
                     -1).astype(np.uint8)
    depth = np.rint((2.0 + 0.5 * xx / w) * depth_scale).astype(np.uint16)
    return color, depth


def _write(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    assert cv2.imwrite(path, img)


def _replica(root):
    seq = os.path.join(root, "data", "Replica", "room0")
    for i in range(2):
        color, depth = _images(680, 1200, 6553.5, i)
        _write(os.path.join(seq, "results", f"frame{i:06d}.jpg"), color)
        _write(os.path.join(seq, "results", f"depth{i:06d}.png"), depth)
    np.savetxt(os.path.join(seq, "traj.txt"), np.tile(np.eye(4).reshape(1, -1), (2, 1)))


def _scannet(root):
    seq = os.path.join(root, "data", "scannet", "scene0000_00")
    for i in range(2):
        color, depth = _images(968, 1296, 1000.0, i)
        _write(os.path.join(seq, "color", f"{i}.jpg"), color)
        _write(os.path.join(seq, "depth", f"{i}.png"), depth)
        os.makedirs(os.path.join(seq, "pose"), exist_ok=True)
        np.savetxt(os.path.join(seq, "pose", f"{i}.txt"), np.eye(4))


def _scannetpp(root):
    dslr = os.path.join(root, "data", "ScanNet++", "data", "8b5caf3398", "dslr")
    names = ["DSC00000.JPG", "DSC00001.JPG"]
    for i, name in enumerate(names):
        color, depth = _images(1168, 1752, 1000.0, i)
        _write(os.path.join(dslr, "undistorted_images", name), color)
        _write(os.path.join(dslr, "undistorted_depths", name.replace(".JPG", ".png")), depth)
    frames = [{"file_path": n, "transform_matrix": np.eye(4).tolist(), "is_bad": False}
              for n in names]
    os.makedirs(os.path.join(dslr, "nerfstudio"))
    with open(os.path.join(dslr, "nerfstudio", "transforms_undistorted.json"), "w") as f:
        json.dump({"h": 1168, "w": 1752, "fl_x": 1500.0, "fl_y": 1500.0, "cx": 876.0,
                   "cy": 584.0, "frames": frames, "test_frames": []}, f)
    with open(os.path.join(dslr, "train_test_lists.json"), "w") as f:
        json.dump({"train": names, "test": []}, f)


def _iphone(root):
    seq = os.path.join(root, "experiments", "iPhone_Captures", "capture")
    for i in range(2):
        color, depth = _images(1440, 1920, 6553.5, i)
        _write(os.path.join(seq, "rgb", f"{i}.png"), color)
        _write(os.path.join(seq, "depth", f"{i}.png"), depth)
    with open(os.path.join(seq, "transforms.json"), "w") as f:
        json.dump({"h": 1440, "w": 1920, "fl_x": 1400.0, "fl_y": 1400.0, "cx": 960.0,
                   "cy": 720.0, "frames": [{"file_path": f"rgb/{i}.png",
                                            "transform_matrix": np.eye(4).tolist()}
                                           for i in range(2)]}, f)


@pytest.fixture(scope="module")
def trees(rendered):
    for write in (_replica, _scannet, _scannetpp, _iphone):
        write(rendered)
    return rendered


@pytest.mark.parametrize("path, densify", [
    ("replica/splatam.py", None), ("replica/splatam_s.py", (340, 600)),
    ("replica_v2/splatam.py", None), ("tum/splatam.py", None), ("scannet/splatam.py", None),
    ("scannetpp/splatam.py", None), ("iphone/splatam.py", (360, 480)),
])
def test_config_starts(trees, monkeypatch, path, densify):
    """The runtime starts; the densification camera and dataset exist where
    the config gives densification a size of its own; tracking runs at the
    main size in all seven."""
    monkeypatch.chdir(trees)
    for var in ("SCENE_NUM", "SEED", "SCENE", "USE_TRAIN_SPLIT"):
        monkeypatch.delenv(var, raising=False)
    config = load_experiment_config(os.path.join("configs", path))
    rt = SLAMRuntime(config, "cpu")
    data = rt.config["data"]
    assert (rt.cam.height, rt.cam.width) == (data["desired_image_height"],
                                             data["desired_image_width"])
    assert rt.tracking_cam == rt.cam and rt.tracking_dataset is None
    if densify is None:
        assert rt.densify_cam == rt.cam and rt.densify_dataset is None
    else:
        assert (rt.densify_cam.height, rt.densify_cam.width) == densify
        assert rt.densify_dataset is not None
    assert rt.gm.num_active() > 0 and rt.scene_radius > 0
