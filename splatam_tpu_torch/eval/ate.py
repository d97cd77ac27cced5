"""Absolute trajectory error via Horn's closed-form alignment.

Parity: utils/eval_helpers.py:23-77 (the classic TUM-RGBD evaluate_ate).
A copy of splatam_tpu/eval/ate.py (numpy only).
"""
from __future__ import annotations

import numpy as np


def align(model: np.ndarray, data: np.ndarray):
    """Align two trajectories (3xN each). Returns (rot, trans, per-point
    translational error)."""
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)

    w = np.zeros((3, 3))
    for col in range(model.shape[1]):
        w += np.outer(model_zc[:, col], data_zc[:, col])
    u, _, vh = np.linalg.svd(w.T)
    s = np.identity(3)
    if np.linalg.det(u) * np.linalg.det(vh) < 0:
        s[2, 2] = -1
    rot = u @ s @ vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)

    aligned = rot @ model + trans
    err = aligned - data
    trans_error = np.sqrt(np.sum(err * err, axis=0))
    return rot, trans, trans_error


def evaluate_ate(gt_traj: list, est_traj: list) -> float:
    """Mean translational error after Horn alignment (w2c matrix lists)."""
    gt_pts = np.stack([np.asarray(p)[:3, 3] for p in gt_traj]).T
    est_pts = np.stack([np.asarray(p)[:3, 3] for p in est_traj]).T
    _, _, trans_error = align(gt_pts, est_pts)
    return float(trans_error.mean())
