"""Fixed-capacity masked Gaussian map.

Counterpart of splatam_tpu/core/gaussians.py. The map lives in [CAP, .]
tensors with a boolean `active` mask: densification writes into the lowest
free slots and pruning clears mask bits, so both packages place every
Gaussian in the same slot and their maps compare slot for slot. Phases run
on the active span (the prefix up to the last active slot).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class GaussianMap(NamedTuple):
    """Per-Gaussian parameters padded to capacity CAP.

      means3d          [CAP, 3]  world-frame centers
      rgb_colors       [CAP, 3]
      unnorm_rotations [CAP, 4]  wxyz, normalized at render time
      logit_opacities  [CAP]     sigmoid at render time
      log_scales       [CAP, S]  S=1 isotropic / S=3 anisotropic
      active           [CAP]     bool validity mask
    """

    means3d: torch.Tensor
    rgb_colors: torch.Tensor
    unnorm_rotations: torch.Tensor
    logit_opacities: torch.Tensor
    log_scales: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.means3d.shape[0]

    @property
    def isotropic(self) -> bool:
        return self.log_scales.shape[1] == 1

    @property
    def device(self) -> torch.device:
        return self.means3d.device

    def num_active(self) -> int:
        return int(self.active.sum())

    def span(self) -> int:
        """One past the last active slot (0 for an empty map)."""
        idx = torch.nonzero(self.active)
        return int(idx[-1, 0]) + 1 if idx.numel() else 0


def empty_map(capacity: int, isotropic: bool, device) -> GaussianMap:
    s = 1 if isotropic else 3
    f32 = dict(dtype=torch.float32, device=device)
    rots = torch.zeros((capacity, 4), **f32)
    rots[:, 0] = 1.0
    return GaussianMap(
        means3d=torch.zeros((capacity, 3), **f32),
        rgb_colors=torch.zeros((capacity, 3), **f32),
        unnorm_rotations=rots,
        logit_opacities=torch.zeros((capacity,), **f32),
        log_scales=torch.zeros((capacity, s), **f32),
        active=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def from_pointcloud(pts, cols, mean3_sq_dist, valid, capacity: int,
                    isotropic: bool = True) -> GaussianMap:
    """Map from a masked point cloud (reference initialize_params,
    scripts/splatam.py:120-157): identity rotations, logit opacity 0,
    log_scales = log(sqrt(mean3_sq_dist)). Invalid rows are parked
    inactive."""
    m = pts.shape[0]
    if m > capacity:
        raise ValueError(f"pointcloud rows {m} exceed capacity {capacity}")
    gm = empty_map(capacity, isotropic, pts.device)
    s = gm.log_scales.shape[1]
    log_scales = (0.5 * torch.log(torch.clamp(mean3_sq_dist, min=1e-12)))[:, None]
    gm.means3d[:m] = pts
    gm.rgb_colors[:m] = cols
    gm.log_scales[:m] = log_scales.expand(m, s)
    gm.active[:m] = valid
    return gm


def _gather(gm: GaussianMap, idx: torch.Tensor) -> GaussianMap:
    return GaussianMap(*(a[idx] for a in gm))


def compact(gm: GaussianMap, timestep: torch.Tensor):
    """Move active rows to the front, keeping their order."""
    order = torch.argsort((~gm.active).to(torch.int8), stable=True)
    return _gather(gm, order), timestep[order]


def slice_prefix(gm: GaussianMap, n: int) -> GaussianMap:
    return GaussianMap(*(a[:n] for a in gm))


def write_prefix(gm: GaussianMap, view: GaussianMap) -> GaussianMap:
    """Full buffers with the first view.capacity slots replaced."""
    n = view.capacity
    return GaussianMap(*(torch.cat([v, a[n:]]) for a, v in zip(gm, view)))


def grow_capacity(gm: GaussianMap, new_capacity: int) -> GaussianMap:
    """Pad with inactive slots."""
    if new_capacity < gm.capacity:
        raise ValueError("capacity can only grow")
    fresh = empty_map(new_capacity - gm.capacity, gm.isotropic, gm.device)
    return GaussianMap(*(torch.cat([a, f]) for a, f in zip(gm, fresh)))


def compact_to_numpy(gm: GaussianMap) -> dict:
    """Active rows in the reference's params-dict schema:
    means3D [N,3], rgb_colors [N,3], unnorm_rotations [N,4],
    logit_opacities [N,1], log_scales [N,S]."""
    idx = torch.nonzero(gm.active)[:, 0]
    np_ = lambda a: a[idx].detach().cpu().numpy()
    return {
        "means3D": np_(gm.means3d),
        "rgb_colors": np_(gm.rgb_colors),
        "unnorm_rotations": np_(gm.unnorm_rotations),
        "logit_opacities": np_(gm.logit_opacities)[:, None],
        "log_scales": np_(gm.log_scales),
    }


def from_params_dict(params: dict, device, capacity: int | None = None) -> GaussianMap:
    """Map from a reference-schema params dict (numpy arrays), rows packed
    as the dense active prefix."""
    means = np.asarray(params["means3D"], np.float32)
    n = means.shape[0]
    cap = capacity or int(2 ** np.ceil(np.log2(max(n, 1) * 1.25)))
    cap = max(cap, n)
    log_scales = np.asarray(params["log_scales"], np.float32)
    if log_scales.ndim == 1:
        log_scales = log_scales[:, None]
    gm = empty_map(cap, log_scales.shape[1] == 1, device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    gm.means3d[:n] = t(means)
    gm.rgb_colors[:n] = t(params["rgb_colors"])
    gm.unnorm_rotations[:n] = t(params["unnorm_rotations"])
    gm.logit_opacities[:n] = t(params["logit_opacities"]).reshape(n)
    gm.log_scales[:n] = t(log_scales)
    gm.active[:n] = True
    return gm


def from_jax_numpy(fields: dict, device) -> GaussianMap:
    """A JAX `GaussianMap`'s fields, as numpy arrays keyed by field name,
    slot for slot (inactive slots included)."""
    return GaussianMap(**{
        k: torch.tensor(np.array(fields[k]), device=device)
        for k in GaussianMap._fields
    })
