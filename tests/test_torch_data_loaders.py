"""The port's eleven real-format loaders against the JAX package's.

Each format gets a tiny tree in its own layout, its images written by cv2
or Pillow. splatam_tpu.data.get_dataset and the port's must agree on len
and on every item: colour within 1e-4 (0-255), depth, intrinsics and pose
within 1e-6. The cases take a desired size other than the YAML's, a camera
with a `distortion` key (TUM), start/end/stride, a TUM tree with a dropped
depth frame and jittered stamps, both splits of Replica-V2 and ScanNet++
(ScanNet++ also with ignore_bad), and Azure's three pose sources. The
PNG-only formats run again with Pillow hidden (read through read_png) and
must still agree; a JPEG with Pillow hidden raises. make_datasets equals
the JAX runtime's _make_datasets on a config with separate tracking and
densification sizes.
"""
import json
import os
import sys

import cv2
import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
from PIL import Image

import splatam_tpu.data as jdata
import splatam_tpu_torch.data as tdata
from splatam_tpu.slam.pipeline import _make_datasets
from splatam_tpu_torch.slam.config import backfill_defaults

H, W = 30, 40  # the trees' image size (the YAML's)
FRAMES = 5
CAMERA = {"image_height": H, "image_width": W, "fx": 35.0, "fy": 34.5, "cx": 19.3,
          "cy": 15.2, "png_depth_scale": 1000.0}


def _frame(i: int):
    rng = np.random.default_rng(100 + i)
    yy, xx = np.mgrid[0:H, 0:W]
    color = np.stack([(xx * 6 + i * 9) % 256, (yy * 8 + i * 5) % 256,
                      rng.integers(0, 256, (H, W))], -1).astype(np.uint8)
    depth = (1000 + 40 * xx + 25 * yy + rng.integers(0, 300, (H, W))).astype(np.uint16)
    depth[rng.uniform(size=(H, W)) < 0.05] = 0  # holes
    return color, depth


def _pose(i: int) -> np.ndarray:
    a = 0.1 * i
    c2w = np.eye(4)
    c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    c2w[:3, 3] = [0.3 * i, -0.05 * i, 0.1 * i * i]
    return c2w


def _save(path, img, writer="cv2"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if writer == "pillow":
        Image.fromarray(img).save(path)
        return
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    assert cv2.imwrite(str(path), img)


def _write_yaml(path, name, extra=""):
    lines = [f"dataset_name: '{name}'", "camera_params:"]
    lines += [f"  {k}: {v}" for k, v in CAMERA.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n" + extra)
    return str(path)


def _frames_with(root, color_fmt, depth_fmt, n=FRAMES, writer="cv2"):
    for i in range(n):
        color, depth = _frame(i)
        _save(os.path.join(root, color_fmt.format(i=i)), color, writer)
        _save(os.path.join(root, depth_fmt.format(i=i)), depth)


# ---- one tree per format: (config_dict, basedir, sequence, kwargs) ----------

def tree_icl(tmp):
    seq = tmp / "icl" / "living_room"
    _frames_with(seq, "rgb/{i}.png", "depth/{i}.png", writer="pillow")
    with open(seq / "livingroom.gt.sim", "w") as f:
        for i in range(FRAMES):
            for row in _pose(i)[:3]:
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
            f.write("\n")
    return _write_yaml(tmp / "icl.yaml", "icl"), str(tmp / "icl"), "living_room", {}


def tree_replica(tmp):
    seq = tmp / "Replica" / "room0"
    _frames_with(seq, "results/frame{i:06d}.jpg", "results/depth{i:06d}.png")
    np.savetxt(seq / "traj.txt", np.stack([_pose(i).reshape(-1) for i in range(FRAMES)]))
    cfg = _write_yaml(tmp / "replica.yaml", "replica")
    return cfg, str(tmp / "Replica"), "room0", dict(start=1, end=5, stride=2)


def _replica_v2(tmp, split):
    seq = tmp / "Replica_V2" / "room_0" / "imap"
    _frames_with(seq / "00", "rgb/rgb_{i}.png", "depth/depth_{i}.png")
    np.savetxt(seq / "00" / "traj_w_c.txt", np.stack([_pose(i).reshape(-1) for i in range(FRAMES)]))
    _frames_with(seq / "01", "rgb/rgb_{i}.png", "depth/depth_{i}.png", n=3, writer="pillow")
    np.savetxt(seq / "01" / "traj_w_c.txt", np.stack([_pose(i + 7).reshape(-1) for i in range(3)]))
    cfg = _write_yaml(tmp / "replica_v2.yaml", "replicav2")
    return cfg, str(tmp / "Replica_V2"), "room_0", dict(use_train_split=split == "train")


def tree_replicav2_train(tmp):
    return _replica_v2(tmp, "train")


def tree_replicav2_nvs(tmp):
    return _replica_v2(tmp, "nvs")


def _azure(tmp, odom):
    seq = tmp / "azure" / "seq"
    _frames_with(seq, "color/{i}.jpg", "depth/{i}.png")
    kwargs = {}
    if odom == "log":
        with open(seq / "odometry.log", "w") as f:
            for i in range(FRAMES):
                f.write(f"{i} {i} {i + 1}\n")
                for row in _pose(i):
                    f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
        kwargs["odomfile"] = "odometry.log"
    elif odom == "plain":
        np.savetxt(seq / "poses.txt", np.stack([_pose(i).reshape(-1) for i in range(FRAMES)]))
        kwargs["odomfile"] = "poses.txt"
    return _write_yaml(tmp / "azure.yaml", "azure"), str(tmp / "azure"), "seq", kwargs


def tree_azure_log(tmp):
    return _azure(tmp, "log")


def tree_azure_plain(tmp):
    return _azure(tmp, "plain")


def tree_azure_none(tmp):
    return _azure(tmp, "none")


def _scannet_like(tmp, name, ext):
    seq = tmp / name / "scene0000_00"
    _frames_with(seq, "color/{i}." + ext, "depth/{i}.png")
    for i in range(FRAMES):
        os.makedirs(seq / "pose", exist_ok=True)
        np.savetxt(seq / "pose" / f"{i}.txt", _pose(i))
    return _write_yaml(tmp / f"{name}.yaml", name), str(tmp / name), "scene0000_00", {}


def tree_scannet(tmp):
    return _scannet_like(tmp, "scannet", "jpg")


def tree_ai2thor(tmp):
    return _scannet_like(tmp, "ai2thor", "png")


def _npy_poses(tmp, name, ext):
    seq = tmp / name / "capture"
    _frames_with(seq, "rgb/{i}." + ext, "depth/{i}.png")
    os.makedirs(seq / "poses", exist_ok=True)
    for i in range(FRAMES):
        np.save(seq / "poses" / f"{i}.npy", _pose(i))
    return _write_yaml(tmp / f"{name}.yaml", name), str(tmp / name), "capture", {}


def tree_record3d(tmp):
    return _npy_poses(tmp, "record3d", "png")


def tree_realsense(tmp):
    return _npy_poses(tmp, "realsense", "jpg")


def tree_tum(tmp):
    """Colour at 30 Hz with jitter; each depth image a few ms off its colour
    frame, one of them missing (that colour frame takes the nearest depth
    within max_dt); ground truth at 100 Hz on its own stamps, ending before
    the last colour frame (no pose within max_dt: dropped); one colour frame
    closer than 1/32 s to its predecessor (thinned away)."""
    seq = tmp / "TUM" / "rgbd_dataset_freiburg1_desk"
    rng = np.random.default_rng(3)
    t_rgb = 1305031452.79 + np.arange(9) / 30.0 + rng.uniform(-0.002, 0.002, 9)
    t_rgb[5] = t_rgb[4] + 0.01
    t_rgb[8] = t_rgb[0] + 0.45
    rgb, depth = [], []
    for i, t in enumerate(t_rgb):
        color, d = _frame(i)
        _save(seq / "rgb" / f"{t:.6f}.png", color)
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        if i != 3:
            td = t + rng.uniform(-0.008, 0.008)
            _save(seq / "depth" / f"{td:.6f}.png", d)
            depth.append(f"{td:.6f} depth/{td:.6f}.png")
    t_gt = t_rgb[0] - 0.05 + np.arange(32) / 100.0
    gt = []
    for k, t in enumerate(t_gt):
        a = 0.01 * k
        q = [np.sin(a / 2) * 0.6, np.sin(a / 2) * 0.8, 0.0, np.cos(a / 2)]  # x y z w
        gt.append(f"{t:.4f} {0.01 * k:.4f} {-0.02 * k:.4f} {0.005 * k:.4f} "
                  + " ".join(f"{v:.6f}" for v in q))
    for name, rows in (("rgb.txt", rgb), ("depth.txt", depth), ("groundtruth.txt", gt)):
        with open(seq / name, "w") as f:
            f.write("# header\n# file: 'x.bag'\n# timestamp data\n" + "\n".join(rows) + "\n")
    cfg = _write_yaml(tmp / "tum.yaml", "tum",
                      "  distortion: [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]\n")
    return cfg, str(tmp / "TUM"), "rgbd_dataset_freiburg1_desk", {}


def _scannetpp(tmp, split, ignore_bad=False):
    seq = tmp / "ScanNet++" / "8b5caf3398" / "dslr"
    names = [f"DSC{i:05d}.JPG" for i in range(FRAMES + 2)]
    frames = []
    for i, name in enumerate(names):
        color, depth = _frame(i)
        _save(seq / "undistorted_images" / name, color, writer="pillow" if i % 2 else "cv2")
        _save(seq / "undistorted_depths" / name.replace(".JPG", ".png"), depth)
        frames.append({"file_path": name, "transform_matrix": _pose(i).tolist(),
                       "is_bad": i == 2})
    train, test = names[:FRAMES], names[FRAMES:]
    meta = {"h": H, "w": W, "fl_x": 35.0, "fl_y": 34.5, "cx": 19.3, "cy": 15.2,
            "frames": frames[:FRAMES], "test_frames": frames[FRAMES:]}
    os.makedirs(seq / "nerfstudio", exist_ok=True)
    with open(seq / "nerfstudio" / "transforms_undistorted.json", "w") as f:
        json.dump(meta, f)
    with open(seq / "train_test_lists.json", "w") as f:
        json.dump({"train": train, "test": test}, f)
    return ({"dataset_name": "scannetpp"}, str(tmp / "ScanNet++"), "8b5caf3398",
            dict(use_train_split=split == "train", ignore_bad=ignore_bad,
                 desired_height=24, desired_width=36))


def tree_scannetpp_train(tmp):
    return _scannetpp(tmp, "train")


def tree_scannetpp_ignore_bad(tmp):
    return _scannetpp(tmp, "train", ignore_bad=True)


def tree_scannetpp_nvs(tmp):
    return _scannetpp(tmp, "nvs")


def tree_nerfcapture(tmp):
    seq = tmp / "captures" / "offline_demo"
    _frames_with(seq, "rgb/{i}.png", "depth/{i}.png")
    meta = {"h": H, "w": W, "fl_x": 35.0, "fl_y": 34.5, "cx": 19.3, "cy": 15.2,
            "frames": [{"file_path": f"rgb/{i}.png", "transform_matrix": _pose(i).tolist()}
                       for i in range(FRAMES)]}
    with open(seq / "transforms.json", "w") as f:
        json.dump(meta, f)
    return ({"dataset_name": "nerfcapture"}, str(tmp / "captures"), "offline_demo",
            dict(desired_height=60, desired_width=80))


TREES = {name[5:]: fn for name, fn in globals().items() if name.startswith("tree_")}
# Formats whose colour and depth are PNG: readable without Pillow.
PNG_ONLY = ("icl", "replicav2_train", "replicav2_nvs", "ai2thor", "record3d", "tum",
            "nerfcapture")
JPEG = ("replica", "azure_log", "scannet", "realsense", "scannetpp_train")


def _build(name, tmp_path):
    cfg, basedir, seq, kwargs = TREES[name](tmp_path)
    if isinstance(cfg, str):
        cfg_j, cfg_t = jdata.load_dataset_config(cfg), tdata.load_dataset_config(cfg)
        assert cfg_j == cfg_t
    else:
        cfg_j = cfg_t = cfg
    kwargs.setdefault("desired_height", 24)
    kwargs.setdefault("desired_width", 32)
    return cfg_j, cfg_t, basedir, seq, kwargs


def _assert_same(ref, mine):
    assert len(ref) == len(mine) > 0
    for i in range(len(ref)):
        (rc, rd, rk, rp), (mc, md, mk, mp) = ref[i], mine[i]
        for a, b in ((rc, mc), (rd, md), (rk, mk), (rp, mp)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(mc, rc, rtol=0, atol=1e-4)
        for a, b in ((rd, md), (rk, mk), (rp, mp)):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def _hide_pillow(monkeypatch):
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, mod, None)
    monkeypatch.setitem(sys.modules, "PIL", None)


@pytest.mark.parametrize("name", sorted(TREES))
def test_loader_matches_jax(tmp_path, name):
    cfg_j, cfg_t, basedir, seq, kwargs = _build(name, tmp_path)
    ref = jdata.get_dataset(cfg_j, basedir, seq, **kwargs)
    mine = tdata.get_dataset(cfg_t, basedir, seq, **kwargs)
    assert mine.imread.name == "Pillow"
    _assert_same(ref, mine)
    if name == "tum":  # 9 colour frames: one thinned, one without a pose
        assert len(mine) == 7
    if name == "scannetpp_ignore_bad":
        assert len(mine) == FRAMES - 1
    if name == "replica":  # start=1, end=5, stride=2
        assert len(mine) == 2


@pytest.mark.parametrize("name", PNG_ONLY)
def test_png_formats_without_pillow(tmp_path, monkeypatch, name):
    cfg_j, cfg_t, basedir, seq, kwargs = _build(name, tmp_path)
    ref = jdata.get_dataset(cfg_j, basedir, seq, **kwargs)
    ref_items = [ref[i] for i in range(len(ref))]
    _hide_pillow(monkeypatch)
    mine = tdata.get_dataset(cfg_t, basedir, seq, **kwargs)
    assert mine.imread.name == "read_png"
    _assert_same(ref_items, mine)


@pytest.mark.parametrize("name", JPEG)
def test_jpeg_without_pillow_raises(tmp_path, monkeypatch, name):
    _cfg_j, cfg_t, basedir, seq, kwargs = _build(name, tmp_path)
    _hide_pillow(monkeypatch)
    mine = tdata.get_dataset(cfg_t, basedir, seq, **kwargs)
    with pytest.raises(RuntimeError, match=r"\.(jpg|JPG): reading this format needs Pillow"):
        mine[0]


def test_make_datasets_matches_jax(tmp_path):
    """A Replica-V2 config with densification at 12x16 and tracking at
    24x32 beside the main 48x64 (the YAML's 30x40 is none of them)."""
    cfg_path, basedir, seq, _ = tree_replicav2_train(tmp_path)
    config = backfill_defaults({"data": dict(
        gradslam_data_cfg=cfg_path, basedir=basedir, sequence=f"some/dir/{seq}", start=1,
        end=-1, stride=1, desired_image_height=48, desired_image_width=64,
        densification_image_height=12, densification_image_width=16,
        tracking_image_height=24, tracking_image_width=32)})
    ref = _make_datasets(config)
    mine = tdata.make_datasets(config)
    for r, m in zip(ref, mine):
        _assert_same(r, m)
    assert [m[0][0].shape[:2] for m in mine] == [(48, 64), (12, 16), (24, 32)]
    assert len(mine[0]) == FRAMES - 1
    np.testing.assert_array_equal(tdata.dataset_from_config(config["data"])[1][0], mine[0][1][0])
    same = backfill_defaults({"data": dict(config["data"], densification_image_height=48,
                                           densification_image_width=64,
                                           tracking_image_height=48, tracking_image_width=64)})
    assert tdata.make_datasets(same)[1:] == (None, None)
