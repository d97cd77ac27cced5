"""Pair-space tracking render for anisotropic maps: world rows gathered
once per rebin, projected per sorted PAIR every iteration.

Counterpart of splatam_tpu/render/pairspace.py, expression by expression.
While tracking, the Gaussian parameters are constants and only the pose
moves, so each rebin gathers the world-frame rows of the structure's pairs
once (render.api.PairStructure.world16), every iteration projects those
rows per pair in plain PyTorch, composites them with K1 in per-pair mode,
and the backward stops at per-pair gradients (K2), which autograd of
`project_pairs` contracts into the pose: no per-Gaussian reduction.

World rows ([P, 13] f32, one per sorted pair; the JAX package pads them to
16 for its kernel layout):
  0-2 mean_w xyz   3-8 cov3d (s00, s01, s02, s11, s12, s22)
  9 opacity (sigmoid-activated, active-masked)   10-12 rgb
"""
from __future__ import annotations

import torch

from splatam_tpu_torch.core.transforms import build_rotation, normalize
from splatam_tpu_torch.render.projection import NEAR_CLIP, _cov3d_components


def pack_world_rows(means3d, unnorm_rotations, logit_opacities, log_scales, rgb_colors,
                    active):
    """[N, 13] world-frame rows; log_scales may be [N, 1] or [N, 3]."""
    if log_scales.shape[1] == 1:
        log_scales = log_scales.expand(-1, 3)
    scales = torch.exp(log_scales)
    s00, s01, s02, s11, s12, s22 = _cov3d_components(normalize(unnorm_rotations), scales)
    opacity = torch.where(active, torch.sigmoid(logit_opacities.reshape(-1)), 0.0)
    return torch.stack(
        [means3d[:, 0], means3d[:, 1], means3d[:, 2], s00, s01, s02, s11, s12, s22,
         opacity, rgb_colors[:, 0], rgb_colors[:, 1], rgb_colors[:, 2]],
        dim=1,
    )


def project_pairs(world16, q, t, fx, fy, cx, cy, width: int, height: int,
                  lim_wh: tuple | None = None):
    """EWA-project every row of world16 [P, 13] at pose (q, t) ->
    compositor rows [P, 11]: x, y, conic a, b, c, opacity, r, g, b, z, z^2.
    Differentiable in (q, t); mirrors render.projection.project. lim_wh
    is the (width, height) of the frustum clamp where it differs from the
    image's (a band of a larger image passes the full image's)."""
    rmat = build_rotation(normalize(q)[None])[0]
    mw_x, mw_y, mw_z = world16[:, 0], world16[:, 1], world16[:, 2]
    px = rmat[0, 0] * mw_x + rmat[0, 1] * mw_y + rmat[0, 2] * mw_z + t[0]
    py = rmat[1, 0] * mw_x + rmat[1, 1] * mw_y + rmat[1, 2] * mw_z + t[1]
    tz = rmat[2, 0] * mw_x + rmat[2, 1] * mw_y + rmat[2, 2] * mw_z + t[2]
    in_front = tz > NEAR_CLIP
    safe_tz = torch.where(in_front, tz, 1.0)

    p_w = 1.0 / (safe_tz + 1e-7)
    x_ndc = (2.0 * fx / width * px - (width - 2.0 * cx) / width * safe_tz) * p_w
    y_ndc = (2.0 * fy / height * py - (height - 2.0 * cy) / height * safe_tz) * p_w
    pix_x = ((x_ndc + 1.0) * width - 1.0) * 0.5
    pix_y = ((y_ndc + 1.0) * height - 1.0) * 0.5

    # vrk = R Sigma R^T, componentwise over the six packed cov3d columns.
    c = [world16[:, k] for k in range(3, 9)]
    sigma = [[c[0], c[1], c[2]], [c[1], c[3], c[4]], [c[2], c[4], c[5]]]
    wsig = [
        [sum(rmat[i, k] * sigma[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]

    def _vrk(i, j):
        return sum(wsig[i][k] * rmat[j, k] for k in range(3))

    lim_w, lim_h = lim_wh if lim_wh is not None else (width, height)
    limx = 1.3 * (lim_w / (2.0 * fx))
    limy = 1.3 * (lim_h / (2.0 * fy))
    txtz = torch.clamp(px / safe_tz, -limx, limx)
    tytz = torch.clamp(py / safe_tz, -limy, limy)
    tx = txtz * safe_tz
    ty = tytz * safe_tz

    inv_z = 1.0 / safe_tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    v00, v01, v02 = _vrk(0, 0), _vrk(0, 1), _vrk(0, 2)
    v11, v12, v22 = _vrk(1, 1), _vrk(1, 2), _vrk(2, 2)
    c00 = j00 * (j00 * v00 + j02 * v02) + j02 * (j00 * v02 + j02 * v22) + 0.3
    c01 = j11 * (j00 * v01 + j02 * v12) + j12 * (j00 * v02 + j02 * v22)
    c11 = j11 * (j11 * v11 + j12 * v12) + j12 * (j11 * v12 + j12 * v22) + 0.3

    det = c00 * c11 - c01 * c01
    safe_det = torch.where(det != 0.0, det, 1.0)
    inv_det = 1.0 / safe_det
    return torch.stack(
        [pix_x, pix_y, c11 * inv_det, -c01 * inv_det, c00 * inv_det, world16[:, 9],
         world16[:, 10], world16[:, 11], world16[:, 12], tz, tz * tz],
        dim=1,
    )
