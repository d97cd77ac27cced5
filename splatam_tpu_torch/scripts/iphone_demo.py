"""Live online SLAM on a NeRFCapture iPhone stream (counterpart of
scripts/iphone_demo.py; reference scripts/iphone_demo.py:96-465).

    python -m splatam_tpu_torch.scripts.iphone_demo [--config configs/iphone/online_demo.py]
    python -m splatam_tpu_torch.scripts.iphone_demo --device cpu

Each sample with depth is saved in the NeRFCapture layout (rgb/{i}.png and
transforms.json under <workdir>/<run_name>), decoded to the config's size
and fed through the online loop incrementally; params.npz is written at the
end. Samples come from the DDS bridge (live/dds.py, which needs cyclonedds),
or from any reader with its read_next contract passed to live_slam (e.g.
live/replay.py's SampleReader). Runs on the card unless --device cpu is
given; exits 2 when asked for the card and there is none.

Where the live frame differs from rgbd_slam's, it keeps the JAX script's
semantics:
- no densification or tracking dataset: both run at the main size, even
  where the config sets densification_image_* (configs/iphone/online_demo.py
  does);
- map_every gates densification and mapping, tracking runs every frame;
- a keyframe is added only while the store has a free slot before its
  scratch slot (the JAX script's `slot < kf_scratch_slot`), where
  SLAMRuntime.add_keyframe would grow the store;
- the ground-truth pose is the phone's, relative to the first frame;
- samples without depth are skipped.
The runtime is SLAMRuntime's own constructor on the in-memory frame list
(its `datasets` argument), not a copy of it; images are resized through
data/imgproc.py and written through data/png.py (no cv2).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from splatam_tpu_torch.data import frame_to_tensors
from splatam_tpu_torch.data.base import relative_transformation_np
from splatam_tpu_torch.data.imgproc import resize_linear, resize_nearest
from splatam_tpu_torch.data.png import write_png
from splatam_tpu_torch.data.scannetpp import P_FLIP
from splatam_tpu_torch.io.params_io import save_params
from splatam_tpu_torch.live.dds import make_reader
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.slam.config import (backfill_defaults, load_experiment_config,
                                           seed_everything)
from splatam_tpu_torch.slam.pipeline import SLAMRuntime
from splatam_tpu_torch.utils.device import require_device


class _LiveDataset:
    """In-memory frame list with the datasets' __getitem__ contract,
    appended to as samples arrive (frame 0 must exist before the runtime is
    built)."""

    def __init__(self):
        self.frames = []

    def append(self, color, depth, intrinsics, pose):
        self.frames.append((color, depth, intrinsics, pose))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]


def _sample_image(sample) -> np.ndarray:
    return np.asarray(sample.image, dtype=np.uint8).reshape((sample.height, sample.width, 3))


def _decode_frame(sample, desired_w, desired_h, downscale):
    """(color HWC 0-255, depth HW1 metres, intrinsics 4x4 scaled by 1 /
    downscale, c2w pose in the OpenCV convention) of a sample, float32
    (the pose float64). Colour is resized as cv2.resize(INTER_LINEAR) resizes
    uint8, rounded half up: equal to cv2 at an exact 2x reduction (cv2's
    area route, the configs' downscale_factor 2), within one level
    elsewhere (cv2's fixed-point weights); depth by nearest neighbour."""
    image = _sample_image(sample)
    depth = np.asarray(sample.depth_image, dtype=np.uint8).view("<f4").reshape(
        (sample.depth_height, sample.depth_width))
    color = np.floor(resize_linear(image, desired_h, desired_w) + 0.5)
    depth = resize_nearest(depth, desired_h, desired_w)
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = sample.fl_x / downscale
    k[1, 1] = sample.fl_y / downscale
    k[0, 2] = sample.cx / downscale
    k[1, 2] = sample.cy / downscale
    pose = np.asarray(sample.transform_matrix, np.float32).reshape(4, 4).T
    pose = P_FLIP @ pose.astype(np.float64) @ P_FLIP.T
    return color.astype(np.float32), depth[..., None].astype(np.float32), k, pose


def _step_frame(rt: SLAMRuntime, live_ds, time_idx: int) -> None:
    """One live frame (scripts/iphone_demo.py:197-235): compact, pose init
    and tracking after frame 0; densify and map every map_every frames; a
    keyframe every keyframe_every frames while the store has room."""
    config = rt.config
    color_np, depth_np, _, pose = live_ds[time_idx]
    rt.gt_w2c_all.append(np.linalg.inv(pose))
    color, depth = frame_to_tensors(color_np, depth_np, rt.device)
    rt.compact()
    if time_idx > 0:
        rt.init_pose(time_idx)
        t0 = time.time()
        rt.track_frame(time_idx, color, depth)
        print(f"frame {time_idx}: tracking {time.time() - t0:.2f}s")
    if time_idx == 0 or (time_idx + 1) % config["map_every"] == 0:
        if config["mapping"]["add_new_gaussians"] and time_idx > 0:
            rt.densify_frame(time_idx, color, depth)
        selected = rt.select_keyframes(time_idx, depth_np)
        rt._stage_keyframe(rt.kf_scratch_slot, color_np, depth_np)
        t0 = time.time()
        rt.map_frame(time_idx, selected)
        print(f"frame {time_idx}: mapping {time.time() - t0:.2f}s "
              f"(n_gauss={rt.gm.num_active()})")
    if ((time_idx == 0 or (time_idx + 1) % config["keyframe_every"] == 0)
            and len(rt.keyframe_list) < rt.kf_scratch_slot):
        rt.add_keyframe(time_idx, color_np, depth_np)


def live_slam(config: dict, device="cuda", reader=None) -> SLAMRuntime:
    """Run the online loop on data.num_frames samples with depth from
    `reader` (make_reader()'s DDS reader when None); returns the runtime."""
    config = backfill_defaults(config)
    device = require_device(device, "live_slam")
    data_cfg = config["data"]
    num_frames = data_cfg["num_frames"]
    desired_w = data_cfg["desired_image_width"]
    desired_h = data_cfg["desired_image_height"]
    downscale = data_cfg.get("downscale_factor", 1.0)

    if reader is None:
        _domain, reader = make_reader()
    save_path = os.path.join(config["workdir"], config["run_name"])
    os.makedirs(os.path.join(save_path, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(save_path, "depth"), exist_ok=True)
    manifest = {"frames": []}

    live_ds = _LiveDataset()
    rt = None
    first_pose = None
    time_idx = 0
    print("Waiting for frames...")
    while time_idx < num_frames:
        sample = reader.read_next()
        if not sample:
            continue
        if not sample.has_depth:
            print("No depth in frame; skipping (enable depth in NeRFCapture).")
            continue
        frame_start = time.time()
        write_png(os.path.join(save_path, "rgb", f"{time_idx}.png"), _sample_image(sample))
        manifest["frames"].append({
            "transform_matrix": np.asarray(sample.transform_matrix, np.float32)
            .reshape(4, 4).T.tolist(),
            "file_path": f"rgb/{time_idx}.png",
        })
        color, depth, k, pose_abs = _decode_frame(sample, desired_w, desired_h, downscale)
        if first_pose is None:
            first_pose = pose_abs
        pose_rel = relative_transformation_np(first_pose, pose_abs).astype(np.float32)
        live_ds.append(color, depth, k, pose_rel)
        if rt is None:
            rt = SLAMRuntime(config, device, datasets=(live_ds, None, None))
        _step_frame(rt, live_ds, time_idx)
        time_idx += 1
        print(f"[splatam-torch] live frame {time_idx}/{num_frames}: "
              f"{time.time() - frame_start:.3f} s, {rt.gm.num_active()} Gaussians", flush=True)

    with open(os.path.join(save_path, "transforms.json"), "w") as f:
        json.dump(manifest, f, indent=4)
    save_params(rt.export_params(), save_path)
    print(f"Live SLAM finished: {time_idx} frames, saved to {save_path}")
    return rt


def main(argv=None) -> SLAMRuntime:
    ap = harness.parser(__doc__)
    ap.add_argument("--config", default="./configs/iphone/online_demo.py", type=str)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "iphone_demo")
    config = load_experiment_config(args.config)
    seed_everything(seed=config.get("seed", 0))
    return live_slam(config, device)


if __name__ == "__main__":
    main()
