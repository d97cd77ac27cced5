"""Procedural synthetic RGB-D sequences (no files needed).

A textured axis-aligned box room viewed from a smooth interior camera
trajectory, ray-cast analytically in numpy. Provides ground-truth RGB,
depth, and poses with the same __getitem__ contract as the file-backed
loaders — used by the integration tests and bench.py since benchmark
datasets are not shipped with the repo.
"""
from __future__ import annotations

import numpy as np


def _look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """c2w with +z forward, matching the OpenCV/gradslam convention."""
    fwd = np.asarray(target, np.float64) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float64)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def _texture(p: np.ndarray, octaves: int = 2) -> np.ndarray:
    """Procedural 3D texture -> [N, 3] colors in [0, 1].

    Two octaves by default: the smooth base plus a higher-frequency detail
    band — without the detail band the photometric loss is nearly
    gradient-free over meter scales and camera drift along textureless
    walls is a scene ambiguity rather than a tracker property. octaves=3
    adds a third, finer band (Replica-room-class texture density for the
    full-resolution gauntlet variant; default-2 keeps every previously
    calibrated gauntlet/bench scene bit-identical)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.35 * np.sin(2.1 * x + 0.5) * np.cos(1.7 * z)
    g = 0.5 + 0.35 * np.sin(1.3 * y + 1.1) * np.cos(2.3 * x)
    b = 0.5 + 0.35 * np.sin(1.9 * z + 2.0) * np.cos(1.1 * y)
    d = 0.12 * np.sin(7.9 * x + 1.7) * np.sin(6.3 * y + 0.4) * np.sin(8.7 * z)
    d2 = 0.08 * np.cos(12.1 * x) * np.cos(9.7 * z + 2.2)
    out = np.stack([r + d, g + d2, b + 0.5 * (d + d2)], axis=-1)
    if octaves >= 3:
        f = 0.05 * np.sin(23.3 * x + 0.9) * np.cos(19.1 * y)
        f2 = 0.05 * np.cos(27.7 * z + 1.3) * np.sin(21.9 * x + 2.6)
        out = out + np.stack([f, f2, 0.5 * (f + f2)], axis=-1)
    return np.clip(out, 0.0, 1.0)


def _raycast_box(origins: np.ndarray, dirs: np.ndarray, half: float) -> np.ndarray:
    """Distance along each ray to the inside of the box [-half, half]^3."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t_hi = (half - origins) / dirs
        t_lo = (-half - origins) / dirs
    t_far = np.maximum(t_hi, t_lo)  # exit distance per axis
    return np.min(t_far, axis=-1)


# Interior clutter (world units, inside the default 6 m room, clear of the
# ~0.8 m camera orbit around the origin): an empty box room is geometrically
# degenerate — depth constrains only wall-normal motion, so wall-parallel
# drift is unobservable. Spheres and a pillar give the depth channel
# full-rank pose gradients, like furniture does in Replica rooms.
_SPHERES = np.array(
    [  # cx, cy, cz, radius
        [1.9, 0.7, 1.6, 0.55],
        [-1.8, 0.9, 1.9, 0.45],
        [1.6, -1.0, -1.8, 0.50],
        [-1.7, -0.6, -1.6, 0.40],
        [0.1, 1.1, 2.3, 0.35],
    ],
    dtype=np.float64,
)
_PILLAR = np.array([[-2.45, -3.0, -0.6], [-1.85, 3.0, 0.0]], dtype=np.float64)


def _raycast_spheres(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Nearest positive hit distance over _SPHERES (inf on miss)."""
    t_best = np.full(origins.shape[:-1], np.inf)
    a = np.sum(dirs * dirs, axis=-1)
    for cx, cy, cz, rad in _SPHERES:
        oc = origins - np.array([cx, cy, cz])
        b = np.sum(oc * dirs, axis=-1)
        c0 = np.sum(oc * oc, axis=-1) - rad * rad
        disc = b * b - a * c0
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = (-b - sq) / a
        hit = (disc > 0.0) & (t > 1e-6)
        t_best = np.where(hit, np.minimum(t_best, t), t_best)
    return t_best


def _raycast_pillar(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Entry distance into the interior pillar AABB (inf on miss)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (_PILLAR[0] - origins) / dirs
        t1 = (_PILLAR[1] - origins) / dirs
    t_near = np.max(np.minimum(t0, t1), axis=-1)
    t_far = np.min(np.maximum(t0, t1), axis=-1)
    hit = (t_near < t_far) & (t_near > 1e-6)
    return np.where(hit, t_near, np.inf)


class SyntheticDataset:
    """Drop-in RGB-D sequence: dataset[i] -> (color HWC 0-255, depth HW1,
    intrinsics 4x4, c2w pose 4x4), numpy float32, poses relative to frame 0."""

    def __init__(
        self,
        num_frames: int = 30,
        height: int = 120,
        width: int = 160,
        focal: float | None = None,
        room_half: float = 3.0,
        motion_scale: float = 1.0,
        seed: int = 0,
        relative_pose: bool = True,
        depth_noise_sigma: float = 0.0,
        trajectory: str = "pan",
        texture_octaves: int = 2,
    ):
        """depth_noise_sigma > 0 adds per-pixel gaussian depth noise scaled
        by depth (sigma in meters at 1 m — TUM-like sensor behavior),
        deterministic per (seed, frame).

        trajectory: "pan" (default) is the historical monotone sweep — it
        never revisits a view, so yaw drift integrates for the whole run.
        "loop" sweeps out at the SAME per-frame angular rate for ~55% of
        the frames and then retraces back over already-mapped views
        (Replica-room0-like back-and-forth scanning): the return leg
        re-localizes against map regions built with less accumulated
        drift, which is the revisit/drift-cancellation regime the pan
        by construction cannot probe.
        "scan" is the multi-sweep variant (3 triangular sweeps at the same
        per-frame rate): after the first leg maps the territory, every
        later frame tracks against map regions whose pose anchor was
        frozen early, so drift can only integrate over ~1/3 of the run —
        the regime where revisits should pull ATE toward the per-frame
        noise floor (measured against "loop", where a single out-and-back
        freezes but cannot cancel the outward-leg integral)."""
        self.num_imgs = num_frames
        self.desired_height = height
        self.desired_width = width
        self.fx = self.fy = float(focal if focal is not None else 0.9 * width)
        self.cx = width / 2.0
        self.cy = height / 2.0
        self.room_half = room_half
        self.png_depth_scale = 1.0
        self.depth_noise_sigma = float(depth_noise_sigma)
        self.texture_octaves = int(texture_octaves)
        self._seed = seed

        rng = np.random.default_rng(seed)
        self._phase = rng.uniform(0, 2 * np.pi)
        if trajectory == "loop":
            # Triangular out-and-back at the pan's exact per-frame rate
            # (same tracking difficulty per frame; the apex has a one-frame
            # velocity reversal that the constant-velocity init mispredicts,
            # like a real hand-held turn-around).
            rate = 0.35 * motion_scale / max(num_frames - 1, 1)
            apex = max(int(round(0.55 * (num_frames - 1))), 1)
            steps = np.concatenate(
                [np.arange(apex + 1), apex - np.arange(1, num_frames - apex)]
            ).astype(np.float64)
            angles = steps * rate + self._phase
        elif trajectory == "scan":
            # Three sweeps over the same territory at the pan's per-frame
            # rate: leg length L, steps follow a triangle wave 0..L..0..L.
            rate = 0.35 * motion_scale / max(num_frames - 1, 1)
            legs = 3
            leg_len = max((num_frames - 1 + legs - 1) // legs, 1)
            i = np.arange(num_frames)
            period = 2 * leg_len
            tri = np.abs((i + leg_len) % period - leg_len)
            steps = tri.astype(np.float64)
            angles = steps * rate + self._phase
        elif trajectory == "pan":
            angles = np.linspace(0, 0.35 * motion_scale, num_frames) + self._phase
        else:
            raise ValueError(f"unknown synthetic trajectory {trajectory!r}")
        radius = 0.8
        self.poses = []
        for i, a in enumerate(angles):
            eye = np.array(
                [
                    radius * np.sin(a),
                    0.25 * np.sin(0.5 * a + 0.3),
                    radius * np.cos(a) - 0.5,
                ]
            )
            target = eye + np.array([np.sin(a * 1.5), 0.1 * np.sin(a), np.cos(a * 1.5)])
            self.poses.append(_look_at(eye, target))
        self.poses = np.stack(self.poses)
        if relative_pose:
            inv0 = np.linalg.inv(self.poses[0])
            self.poses = np.einsum("ij,njk->nik", inv0, self.poses)
            self._world_from_frame0 = np.linalg.inv(inv0)
        else:
            self._world_from_frame0 = np.eye(4)

    def __len__(self):
        return self.num_imgs

    def get_cam_K(self):
        k = np.eye(3)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = self.fx, self.fy, self.cx, self.cy
        return k

    def render_frame(self, c2w_rel: np.ndarray):
        """Ray-cast color/depth for a camera given relative-to-frame0 c2w."""
        c2w = self._world_from_frame0 @ c2w_rel
        h, w = self.desired_height, self.desired_width
        ys, xs = np.mgrid[0:h, 0:w]
        dirs_cam = np.stack(
            [
                (xs - self.cx) / self.fx,
                (ys - self.cy) / self.fy,
                np.ones_like(xs, dtype=np.float64),
            ],
            axis=-1,
        )
        dirs_world = dirs_cam @ c2w[:3, :3].T
        origins = np.broadcast_to(c2w[:3, 3], dirs_world.shape)
        t = _raycast_box(origins, dirs_world, self.room_half)
        t = np.minimum(t, _raycast_spheres(origins, dirs_world))
        t = np.minimum(t, _raycast_pillar(origins, dirs_world))
        depth = t  # z-depth: dirs_cam z component is 1, so t*|d| z-proj == t
        pts = origins + t[..., None] * dirs_world
        color = _texture(pts, self.texture_octaves) * 255.0
        return color.astype(np.float32), depth.astype(np.float32)[..., None]

    def __getitem__(self, index):
        pose = self.poses[index]
        color, depth = self.render_frame(pose)
        if self.depth_noise_sigma > 0:
            rng = np.random.default_rng((self._seed + 1) * 100003 + index)
            noise = rng.normal(0.0, self.depth_noise_sigma, depth.shape)
            depth = (depth + (noise * depth).astype(np.float32)).astype(np.float32)
        intrinsics = np.eye(4, dtype=np.float32)
        intrinsics[:3, :3] = self.get_cam_K()
        return color, depth, intrinsics, pose.astype(np.float32)
