"""The benchmark's RGB-D scene, ray-cast on the device from the seed.

A copy of the procedural box room that splatam_tpu_torch/data/synthetic.py
casts in numpy on the host (the textured 6 m box, five spheres, one
pillar, the two-octave texture and the interior camera orbit), written in
PyTorch so that a run makes its frames on the card in a few large calls.
The numpy version stays the program's; tests/test_scene.py holds this copy
to it at 64x48 in colour, depth and pose.

Frames are made as a sensor hands them over: colour as uint8 and depth as
uint16 at the configuration's depth scale (0 where nothing was hit).
"""
from __future__ import annotations

import math

import numpy as np
import torch

SPHERES = ((1.9, 0.7, 1.6, 0.55), (-1.8, 0.9, 1.9, 0.45), (1.6, -1.0, -1.8, 0.50),
           (-1.7, -0.6, -1.6, 0.40), (0.1, 1.1, 2.3, 0.35))  # cx, cy, cz, radius
PILLAR = ((-2.45, -3.0, -0.6), (-1.85, 3.0, 0.0))  # axis-aligned box: min, max
ORBIT_RADIUS = 0.8
LOOK_RATE = 1.5  # the view direction turns this many radians per radian of orbit


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """c2w [4, 4] float64 with +z forward (OpenCV convention)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def orbit_pose(angle: float, radius: float = ORBIT_RADIUS) -> np.ndarray:
    """World c2w of the camera at orbit angle `angle` (radians) on the orbit
    of `radius` (the numpy scene's is ORBIT_RADIUS)."""
    eye = np.array([radius * math.sin(angle), 0.25 * math.sin(0.5 * angle + 0.3),
                    radius * math.cos(angle) - 0.5])
    target = eye + np.array([math.sin(LOOK_RATE * angle), 0.1 * math.sin(angle),
                             math.cos(LOOK_RATE * angle)])
    return look_at(eye, target)


def texture(p: torch.Tensor) -> torch.Tensor:
    """Two-octave procedural colour [..., 3] in [0, 1] of world points [..., 3]."""
    x, y, z = p.unbind(-1)
    r = 0.5 + 0.35 * torch.sin(2.1 * x + 0.5) * torch.cos(1.7 * z)
    g = 0.5 + 0.35 * torch.sin(1.3 * y + 1.1) * torch.cos(2.3 * x)
    b = 0.5 + 0.35 * torch.sin(1.9 * z + 2.0) * torch.cos(1.1 * y)
    d = 0.12 * torch.sin(7.9 * x + 1.7) * torch.sin(6.3 * y + 0.4) * torch.sin(8.7 * z)
    d2 = 0.08 * torch.cos(12.1 * x) * torch.cos(9.7 * z + 2.2)
    return torch.clamp(torch.stack([r + d, g + d2, b + 0.5 * (d + d2)], dim=-1), 0.0, 1.0)


def raycast(c2w: torch.Tensor, height: int, width: int, fx: float, fy: float, cx: float,
            cy: float, room_half: float):
    """Colour [V, H, W, 3] in [0, 255] and z-depth [V, H, W] (float64) of the
    views c2w [V, 4, 4] (world frame)."""
    dev = c2w.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float64),
                            torch.arange(width, device=dev, dtype=torch.float64), indexing="ij")
    dirs_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)
    dirs = torch.einsum("hwk,vjk->vhwj", dirs_cam, c2w[:, :3, :3])
    orig = c2w[:, None, None, :3, 3].expand_as(dirs)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    # the room's walls: the exit distance along each axis, nearest of three
    t_hi, t_lo = (room_half - orig) / dirs, (-room_half - orig) / dirs
    t = torch.maximum(t_hi, t_lo).min(dim=-1).values
    a = (dirs * dirs).sum(-1)
    for sx, sy, sz, rad in SPHERES:
        oc = orig - torch.tensor([sx, sy, sz], dtype=torch.float64, device=dev)
        b = (oc * dirs).sum(-1)
        disc = b * b - a * ((oc * oc).sum(-1) - rad * rad)
        ts = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
        t = torch.minimum(t, torch.where((disc > 0.0) & (ts > 1e-6), ts, inf))
    lo = torch.tensor(PILLAR[0], dtype=torch.float64, device=dev)
    hi = torch.tensor(PILLAR[1], dtype=torch.float64, device=dev)
    t0, t1 = (lo - orig) / dirs, (hi - orig) / dirs
    t_near = torch.minimum(t0, t1).max(dim=-1).values
    t_far = torch.maximum(t0, t1).min(dim=-1).values
    t = torch.minimum(t, torch.where((t_near < t_far) & (t_near > 1e-6), t_near, inf))
    color = texture(orig + t[..., None] * dirs) * 255.0
    return color, t  # dirs_cam has z = 1, so the distance along a ray is its z-depth


def sensor_frames(c2w: torch.Tensor, cam: dict, room_half: float):
    """(uint8 colour [V, H, W, 3], clean depth in metres [V, H, W] float64) on
    c2w's device, the colour as a sensor quantizes it."""
    color, depth = raycast(c2w, cam["height"], cam["width"], cam["fx"], cam["fy"], cam["cx"],
                           cam["cy"], room_half)
    return torch.clamp(torch.round(color), 0, 255).to(torch.uint8), depth


def quantize_depth(depth: torch.Tensor, depth_scale: float) -> torch.Tensor:
    """Metres -> the sensor's 16-bit units (0 = no reading), as int32 holding
    uint16 values (torch's uint16 lacks most kernels)."""
    units = torch.round(depth.to(torch.float64) * depth_scale)
    ok = torch.isfinite(units) & (units > 0) & (units <= 65535)
    return torch.where(ok, units, torch.zeros_like(units)).to(torch.int32)
