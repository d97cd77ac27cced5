"""Per-Gaussian screen-space preprocessing (EWA splatting).

Counterpart of splatam_tpu/render/projection.py `project`, expression by
expression: the reference's NDC pipeline (utils/recon_helpers.py:9-13 +
ndc2Pix), the EWA Jacobian with the 1.3*tanfov clamp, the +0.3 dilation,
the alpha-cutoff tile rectangle. Used to build pair structures and by the
generic (densify) render.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16  # BLOCK_X = BLOCK_Y = 16 in the reference rasterizer
NEAR_CLIP = 0.2  # in_frustum threshold p_view.z > 0.2


class Projected(NamedTuple):
    xy: torch.Tensor  # [N, 2] pixel-space mean
    depth: torch.Tensor  # [N] camera-frame z
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # [N] sigmoid-activated opacity


class ProjectedAux(NamedTuple):
    radius: torch.Tensor  # [N] int32 pixel radius (0 => culled)
    rect_min: torch.Tensor  # [N, 2] int64 (tx, ty) inclusive tile rect min
    rect_wh: torch.Tensor  # [N, 2] int64 tile rect extent
    visible: torch.Tensor  # [N] bool


def _cov3d_components(quats, scales):
    """Upper-triangular components of R diag(s^2) R^T as six [N] tensors."""
    q = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0, s1, s2 = scales[:, 0] ** 2, scales[:, 1] ** 2, scales[:, 2] ** 2
    v00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    v01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    v02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    v11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    v12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    v22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return v00, v01, v02, v11, v12, v22


def project(means3d, quats, logit_opacities, scales, active, w2c,
            fx, fy, cx, cy, width: int, height: int):
    """EWA-project all Gaussians; means3d in the frame w2c maps from,
    scales [N, 3]. Returns (Projected, ProjectedAux)."""
    rot3 = w2c[:3, :3]
    p_view = means3d @ rot3.T + w2c[:3, 3]
    tz = p_view[:, 2]
    in_front = tz > NEAR_CLIP
    safe_tz = torch.where(in_front, tz, torch.ones_like(tz))

    p_w = 1.0 / (safe_tz + 1e-7)
    x_ndc = (2.0 * fx / width * p_view[:, 0] - (width - 2.0 * cx) / width * safe_tz) * p_w
    y_ndc = (2.0 * fy / height * p_view[:, 1] - (height - 2.0 * cy) / height * safe_tz) * p_w
    pix_x = ((x_ndc + 1.0) * width - 1.0) * 0.5
    pix_y = ((y_ndc + 1.0) * height - 1.0) * 0.5
    xy = torch.stack([pix_x, pix_y], dim=-1)

    s00, s01, s02, s11, s12, s22 = _cov3d_components(quats, scales)
    sigma = [[s00, s01, s02], [s01, s11, s12], [s02, s12, s22]]
    wsig = [
        [sum(rot3[i, k] * sigma[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]

    def _vrk(i, j):
        return sum(wsig[i][k] * rot3[j, k] for k in range(3))

    limx = 1.3 * (width / (2.0 * fx))
    limy = 1.3 * (height / (2.0 * fy))
    txtz = torch.clamp(p_view[:, 0] / safe_tz, -limx, limx)
    tytz = torch.clamp(p_view[:, 1] / safe_tz, -limy, limy)
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
    det_ok = det != 0.0
    safe_det = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=-1)

    mid = 0.5 * (c00 + c11)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc))).to(torch.int32)

    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    # Alpha-cutoff ellipse bbox (see the reference module's note): a pixel
    # with dx^2 > 2*ln(255*op)*cov_xx can never pass the 1/255 cutoff.
    op = torch.sigmoid(logit_opacities)
    cut = torch.clamp(2.0 * torch.log(255.0 * torch.clamp(op, min=1e-12)), max=9.0)
    cut = torch.clamp(cut, min=0.0)
    rx = torch.ceil(torch.sqrt(cut * torch.clamp(c00, min=0.0)))
    ry = torch.ceil(torch.sqrt(cut * torch.clamp(c11, min=0.0)))
    # getRect: float divide then C-style truncation, clamped to the grid.
    rmin_x = torch.clamp(((pix_x - rx) / TILE).to(torch.int64), 0, grid_x)
    rmin_y = torch.clamp(((pix_y - ry) / TILE).to(torch.int64), 0, grid_y)
    rmax_x = torch.clamp(((pix_x + rx + TILE - 1) / TILE).to(torch.int64), 0, grid_x)
    rmax_y = torch.clamp(((pix_y + ry + TILE - 1) / TILE).to(torch.int64), 0, grid_y)
    rect_w = torch.clamp(rmax_x - rmin_x, min=0)
    rect_h = torch.clamp(rmax_y - rmin_y, min=0)

    visible = active & in_front & det_ok & (rect_w * rect_h > 0)
    radius = torch.where(visible, radius, torch.zeros_like(radius))
    proj = Projected(xy=xy, depth=tz, conic=conic, opacity=op)
    aux = ProjectedAux(
        radius=radius,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_wh=torch.stack([rect_w, rect_h], dim=-1),
        visible=visible,
    )
    return proj, aux
