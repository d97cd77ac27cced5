"""The one frame generator: a traffic file's parameters and the seed ->
the frames a cell's run feeds, as a sensor hands them over.

A traffic file (traffic/<name>.json) holds:
  source              where the motion's numbers come from
  fps                 the sensor's frame rate
  rotation_deg_per_s  the camera's average angular speed
  translation_m_per_s the camera's average speed
  start_angle         the orbit angle of the first frame (radians)
  jitter_rad          the start moves by an offset drawn from the seed,
                      uniform within +-jitter_rad
  setup_frames        frames run in set-up, before the measured window
  trace_frames        frames a --trace 1 run profiles
The camera moves on one continuous trajectory through the box room
(slam_bench/scene.py's orbit, its radius and step per frame set so that
it turns and moves at the file's speeds): every frame shows a view of its
own, and every seed runs the same trajectory to within the jitter, so the
same work on inputs of its own. The configuration gives the camera, the
depth scale and the sensor's depth noise, which is drawn anew for every
frame from the seed.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from slam_bench import scene


class Frames(NamedTuple):
    """What the sensor hands over, in host memory."""

    color: np.ndarray  # [F, H, W, 3] uint8
    depth: np.ndarray  # [F, H, W] uint16 in the sensor's units


class Plan:
    """The trajectory: frame i's camera pose, from the traffic and the seed."""

    def __init__(self, traffic: dict, seed: int, n_frames: int):
        fps = float(traffic["fps"])
        turn = math.radians(float(traffic["rotation_deg_per_s"])) / fps
        move = float(traffic["translation_m_per_s"]) / fps
        self.step = turn / scene.LOOK_RATE  # orbit angle a frame
        self.radius = move / self.step
        self.setup_frames = int(traffic["setup_frames"])
        self.trace_frames = int(traffic["trace_frames"])
        self.n_frames = int(n_frames)
        jitter = float(traffic["jitter_rad"])
        self.start = float(traffic["start_angle"]) + float(
            np.random.default_rng(seed).uniform(-jitter, jitter))

    def c2w(self, i: int) -> np.ndarray:
        return scene.orbit_pose(self.start + i * self.step, self.radius)

    def relative_pose(self, i: int) -> np.ndarray:
        """c2w of frame i relative to frame 0 (the loaders' relative_pose)."""
        return np.linalg.inv(self.c2w(0)) @ self.c2w(i)


def make_frames(plan: Plan, camera: dict, sensor: dict, scene_cfg: dict, seed: int,
                device) -> Frames:
    """Ray-cast every frame's view on the device, add the sensor's depth
    noise, quantize, and copy to host memory."""
    c2w = torch.tensor(np.stack([plan.c2w(i) for i in range(plan.n_frames)]),
                       dtype=torch.float64, device=device)
    sigma = float(sensor.get("depth_noise_sigma", 0.0))
    scale = float(camera["png_depth_scale"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    colors, depths = [], []
    for views in torch.split(c2w, 8):  # 8 views a call bounds the ray cast's memory
        color, depth = scene.sensor_frames(views, camera, float(scene_cfg["room_half"]))
        if sigma > 0.0:
            noise = torch.randn(depth.shape, generator=gen, device=device, dtype=torch.float64)
            depth = depth + sigma * noise * depth
        colors.append(color.cpu())
        depths.append(scene.quantize_depth(depth, scale).cpu())
    return Frames(torch.cat(colors).numpy(), torch.cat(depths).numpy().astype(np.uint16))


class SensorStream:
    """The frames under the loaders' __getitem__ contract
    (splatam_tpu_torch/data/base.py): (colour [H, W, 3] float32 0-255,
    depth [H, W, 1] float32 metres, intrinsics [4, 4], c2w pose [4, 4]
    relative to the first frame), converted from the sensor's uint8 and
    uint16 on every read."""

    def __init__(self, plan: Plan, frames: Frames, camera: dict):
        self.plan, self.frames = plan, frames
        self.scale = float(camera["png_depth_scale"])
        k = np.eye(4, dtype=np.float32)
        k[0, 0], k[1, 1] = camera["fx"], camera["fy"]
        k[0, 2], k[1, 2] = camera["cx"], camera["cy"]
        self.intrinsics = k
        self.desired_height, self.desired_width = camera["height"], camera["width"]

    def __len__(self) -> int:
        return self.plan.n_frames

    def __getitem__(self, i: int):
        if not 0 <= i < len(self):
            raise IndexError(f"frame {i} is past the run's {len(self)} frames")
        color = self.frames.color[i].astype(np.float32)
        depth = (self.frames.depth[i].astype(np.float64) / self.scale).astype(np.float32)
        return (color, depth[..., None], self.intrinsics.copy(),
                self.plan.relative_pose(i).astype(np.float32))

    def frame_tensors(self, index: int, device):
        """The frame as the reference reads it: colour [3, H, W] in [0, 1] and
        depth [H, W] in metres, float32 on `device`."""
        color, depth, _, _ = self[index]
        return (torch.as_tensor(color.transpose(2, 0, 1) / 255.0, dtype=torch.float32,
                                device=device),
                torch.as_tensor(depth[..., 0], device=device))
