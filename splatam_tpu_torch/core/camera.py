"""Pinhole camera: intrinsics + reference-frame view matrix.

Counterpart of splatam_tpu/core/camera.py: the same hashable NamedTuple of
Python scalars (numpy-friendly fields); the w2c matrix becomes a tensor on
demand, on the device the caller names.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_IDENTITY4 = ((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))


class Camera(NamedTuple):
    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    w2c: tuple = _IDENTITY4  # nested 4x4 tuple
    near: float = 0.01
    far: float = 100.0

    @property
    def tanfovx(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tanfovy(self) -> float:
        return self.height / (2.0 * self.fy)

    def w2c_tensor(self, device) -> torch.Tensor:
        return torch.tensor(self.w2c, dtype=torch.float32, device=device)


def setup_camera(w: int, h: int, k, w2c=None, near: float = 0.01, far: float = 100.0) -> Camera:
    """Camera from a 3x3 intrinsics matrix and optional 4x4 w2c
    (reference: utils/recon_helpers.py:4-27, same argument order)."""
    k = np.asarray(k)
    if w2c is None:
        w2c_t = _IDENTITY4
    else:
        w2c_t = tuple(tuple(float(v) for v in row) for row in np.asarray(w2c))
    return Camera(
        height=int(h),
        width=int(w),
        fx=float(k[0][0]),
        fy=float(k[1][1]),
        cx=float(k[0][2]),
        cy=float(k[1][2]),
        w2c=w2c_t,
        near=float(near),
        far=float(far),
    )
