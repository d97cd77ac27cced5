"""Keyframe bookkeeping + overlap-based selection (host-side numpy).

Parity: utils/keyframe_selection.py:10-96. Selection samples 1600 valid-depth
pixels, backprojects them, reprojects into every keyframe, scores by the
fraction inside the frustum (20px margin, z>0), sorts descending, and returns
a random permutation of the positively-overlapping keyframes truncated to k.
This is cheap O(1600 x n_keyframes) work that belongs on the host — image
tensors for the mapping window live device-side in the keyframe store.
"""
from __future__ import annotations

import numpy as np


def _backproject_sampled(depth: np.ndarray, intrinsics: np.ndarray, w2c: np.ndarray,
                         sampled: np.ndarray) -> np.ndarray:
    cx, cy = intrinsics[0][2], intrinsics[1][2]
    fx, fy = intrinsics[0][0], intrinsics[1][1]
    xx = (sampled[:, 1] - cx) / fx
    yy = (sampled[:, 0] - cy) / fy
    z = depth[sampled[:, 0], sampled[:, 1]]
    pts_cam = np.stack([xx * z, yy * z, z], axis=-1)
    c2w = np.linalg.inv(w2c)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]

    # Remove duplicate points (incl. camera-origin points) after rounding to
    # 4 decimals — parity with keyframe_selection.py:27-35.
    a = np.abs(np.round(pts, 4))
    rows = np.concatenate([a, np.zeros((1, 3), a.dtype)], axis=0)
    _, inverse, counts = np.unique(rows, axis=0, return_inverse=True, return_counts=True)
    dup = counts[inverse] > 1
    return pts[~dup[: len(a)]]


def keyframe_selection_overlap(
    depth: np.ndarray,  # [H, W] current frame gt depth
    w2c: np.ndarray,  # [4, 4] current estimated pose
    intrinsics: np.ndarray,  # [3, 3]
    keyframe_w2cs: list,  # list of [4, 4] estimated keyframe poses
    k: int,
    pixels: int = 1600,
    rng: np.random.Generator | None = None,
) -> list:
    """Returns indices into keyframe_w2cs of up to k overlapping keyframes."""
    rng = rng if rng is not None else np.random.default_rng()
    height, width = depth.shape
    valid = np.argwhere(depth > 0)
    if len(valid) == 0 or len(keyframe_w2cs) == 0:
        return []
    if hasattr(rng, "integers"):
        idx = rng.integers(0, len(valid), size=pixels)
    else:  # legacy np.random module (global seeded RNG, reference-style)
        idx = rng.randint(0, len(valid), size=pixels)
    sampled = valid[idx]
    pts = _backproject_sampled(depth, intrinsics, w2c, sampled)
    if len(pts) == 0:
        return []

    pts4 = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    scores = []
    for kf_id, est_w2c in enumerate(keyframe_w2cs):
        transformed = (est_w2c @ pts4.T).T[:, :3]
        proj = intrinsics @ transformed.T
        proj = proj.T
        z = proj[:, 2:] + 1e-5
        uv = proj[:, :2] / z
        edge = 20
        mask = (
            (uv[:, 0] < width - edge)
            & (uv[:, 0] > edge)
            & (uv[:, 1] < height - edge)
            & (uv[:, 1] > edge)
            & (z[:, 0] > 0)
        )
        scores.append({"id": kf_id, "percent_inside": mask.sum() / len(uv)})

    scores = sorted(scores, key=lambda s: s["percent_inside"], reverse=True)
    selected = [s["id"] for s in scores if s["percent_inside"] > 0.0]
    return [int(i) for i in rng.permutation(np.array(selected))[:k]]
