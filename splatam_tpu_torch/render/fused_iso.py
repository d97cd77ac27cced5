"""Fused isotropic-EWA render: projection inside the kernels.

Counterpart of splatam_tpu/render/pallas/fused_iso.py. With an isotropic
map (3D covariance s^2 I) a pair's render state is eight world numbers:
mean xyz, s^2, activated opacity, rgb. The fused forward kernel (K4)
projects each pair from those rows and the pose vector while it loads
the pair, then composites like K1; the fused backward kernel (K5) walks
each pixel back to front and emits per-pair WORLD gradients [P, 8].
Tracking contracts them into the pose with two small matmuls
(`_pose_grads`); mapping sums them per Gaussian with K3
(composite.segment_reduce).

World-8 rows ([P, 8] f32, one row per sorted pair, or [N, 8], one per
Gaussian, read through the sorted pairs' Gaussian indices pair_gauss [P]):
  0-2 mean_w xyz   3 s^2   4 opacity (sigmoid-activated, active-masked)
  5-7 rgb
Pose vector ([24] f32, on the device):
  0-8 row-major R (w2c)  9-11 t  12 fx  13 fy  14 cx  15 cy  16 limx  17 limy
  18-21 the NDC terms ax = 2 fx / W, bx = (W - 2 cx) / W, ay, by
  (computed once on the host, so the kernels and the plain versions read
  the same values instead of dividing each in their own way)
Forward output [7, H, W]: r, g, b, z, z^2, silhouette, n_contrib.
"""
from __future__ import annotations

import torch

from splatam_tpu_torch.core.transforms import build_rotation, normalize
from splatam_tpu_torch.render import _cuda
from splatam_tpu_torch.render.binning import grid_shape
from splatam_tpu_torch.render.composite import (
    CH,
    _ptr,
    _rows,
    composite_pairs_backward_plain,
    composite_pairs_plain,
    segment_reduce,
)
from splatam_tpu_torch.render.projection import NEAR_CLIP
from splatam_tpu_torch.utils import spans

W8 = 8
POSE_LEN = 24


def pack_world8(means3d, logit_opacities, log_scales, rgb_colors, active):
    """[N, 8] isotropic world rows, differentiable in every input;
    log_scales must be [N, 1]."""
    s = torch.exp(log_scales[:, 0])
    op = torch.where(active, torch.sigmoid(logit_opacities.reshape(-1)), 0.0)
    return torch.stack(
        [means3d[:, 0], means3d[:, 1], means3d[:, 2], s * s, op,
         rgb_colors[:, 0], rgb_colors[:, 1], rgb_colors[:, 2]],
        dim=1,
    )


def make_pose_vec(rmat, t, width, height, fx, fy, cx, cy, limx, limy):
    """[POSE_LEN] f32 pose/intrinsics vector on rmat's device (the
    intrinsics a blocking upload)."""
    with spans.waited("render.pose_vec"):
        intr = torch.tensor(
            [fx, fy, cx, cy, limx, limy, 2.0 * fx / width, (width - 2.0 * cx) / width,
             2.0 * fy / height, (height - 2.0 * cy) / height, 0.0, 0.0],
            dtype=torch.float32, device=rmat.device)
    return torch.cat([rmat.reshape(9).float(), t.reshape(3).float(), intr])


def project_pairs_plain(world8, pose, width: int, height: int):
    """Isotropic EWA projection of every row of world8 [P, 8] (the
    reference's `_project_rows`, expression by expression; differentiable).
    Returns (xy [P, 2], conic [P, 3], opacity [P], chans [P, 5])."""
    r = pose[0:9]
    t0, t1, t2 = pose[9], pose[10], pose[11]
    fx, fy, limx, limy = pose[12], pose[13], pose[16], pose[17]
    ax, bx, ay, by = pose[18], pose[19], pose[20], pose[21]
    mwx, mwy, mwz = world8[:, 0], world8[:, 1], world8[:, 2]
    px = r[0] * mwx + r[1] * mwy + r[2] * mwz + t0
    py = r[3] * mwx + r[4] * mwy + r[5] * mwz + t1
    tz = r[6] * mwx + r[7] * mwy + r[8] * mwz + t2
    in_front = tz > NEAR_CLIP
    safe_tz = torch.where(in_front, tz, 1.0)

    p_w = 1.0 / (safe_tz + 1e-7)
    x_ndc = (ax * px - bx * safe_tz) * p_w
    y_ndc = (ay * py - by * safe_tz) * p_w
    pix_x = ((x_ndc + 1.0) * width - 1.0) * 0.5
    pix_y = ((y_ndc + 1.0) * height - 1.0) * 0.5

    inv_z = 1.0 / safe_tz
    vx = px * inv_z
    vy = py * inv_z
    txtz = torch.clamp(vx, -limx, limx)
    tytz = torch.clamp(vy, -limy, limy)
    tx = txtz * safe_tz
    ty = tytz * safe_tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    s2 = world8[:, 3]
    c00 = s2 * (j00 * j00 + j02 * j02) + 0.3
    c01 = s2 * (j02 * j12)
    c11 = s2 * (j11 * j11 + j12 * j12) + 0.3
    det = c00 * c11 - c01 * c01
    safe_det = torch.where(det != 0.0, det, 1.0)
    inv_det = 1.0 / safe_det
    xy = torch.stack([pix_x, pix_y], dim=1)
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=1)
    chans = torch.stack([world8[:, 5], world8[:, 6], world8[:, 7], tz, tz * tz], dim=1)
    return xy, conic, world8[:, 4], chans


# ---------------------------------------------------------------------------
# K4: fused forward
# ---------------------------------------------------------------------------


def fused_forward_plain(world8, pose_vec, tile_start, width: int, height: int,
                        pair_gauss=None, cull: int | None = None):
    """world8 [N, 8] per-Gaussian world rows composited through the sorted
    pairs pair_gauss [P]; with pair_gauss None, world8 holds one row per
    sorted pair. `cull` as in composite_pairs_plain: the kernels' cull on the
    projected pairs, which must change nothing."""
    return composite_pairs_plain(
        *project_pairs_plain(_rows(world8, pair_gauss), pose_vec, width, height), tile_start,
        width, height, cull)


def _check_common(world8, pose_vec, tile_start, width, height, pair_gauss=None):
    """Validate K4/K5 inputs; returns (grid_x, grid_y, pair count)."""
    gx, gy = grid_shape(width, height)
    _cuda.require(world8, "world8", torch.float32, (None, W8))
    _cuda.require(pose_vec, "pose_vec", torch.float32, (POSE_LEN,))
    _cuda.require(tile_start, "tile_start", torch.int32, (gx * gy + 1,))
    if pair_gauss is not None:
        _cuda.require(pair_gauss, "pair_gauss", torch.int32, (None,))
    if world8.data_ptr() % 16:
        raise ValueError("world8: the kernels read rows as float4, need 16-byte alignment")
    return gx, gy, (world8 if pair_gauss is None else pair_gauss).shape[0]


def fused_forward(world8, pose_vec, tile_start, width: int, height: int, pair_gauss=None):
    """K4 wrapper: [7, H, W] (r, g, b, z, z^2, silhouette, n_contrib) from
    per-Gaussian world rows [N, 8] and the sorted pairs' Gaussian indices
    pair_gauss [P] (int32), or, with pair_gauss None, from per-pair world
    rows [P, 8] sorted by tile. tile_start[-1] must not exceed P (the
    binning's structures hold exactly P pairs). CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if not world8.is_cuda:
        return fused_forward_plain(world8, pose_vec, tile_start, width, height, pair_gauss)
    gx, gy, _ = _check_common(world8, pose_vec, tile_start, width, height, pair_gauss)
    out = torch.empty((CH + 2, height, width), dtype=torch.float32, device=world8.device)
    _cuda.launch(world8, "fused_forward", world8.data_ptr(), _ptr(pair_gauss),
                 pose_vec.data_ptr(), tile_start.data_ptr(), gx, gy, width, height,
                 out.data_ptr())
    fused_forward.launches += 1
    return out


fused_forward.launches = 0


# ---------------------------------------------------------------------------
# K5: fused backward
# ---------------------------------------------------------------------------


def fused_backward_plain(world8, pose_vec, tile_start, width: int, height: int, state, g,
                         pair_gauss=None):
    """The reverse walk in screen space (composite_pairs_backward_plain),
    chained to the per-pair world rows (gathered through pair_gauss, if
    given) through autograd of the projection: [P, 8]."""
    with torch.enable_grad():
        w8 = _rows(world8, pair_gauss).detach().requires_grad_(True)
        xy, conic, op, chans = project_pairs_plain(w8, pose_vec.detach(), width, height)
        screen = composite_pairs_backward_plain(
            xy.detach(), conic.detach(), op.detach(), chans.detach(), tile_start,
            width, height, state, g)
        (d_w8,) = torch.autograd.grad(
            (xy, conic, op, chans),
            (w8,),
            (screen[:, 0:2], screen[:, 2:5], screen[:, 5], screen[:, 6:]),
            allow_unused=True,
        )
    return d_w8


def fused_backward(world8, pose_vec, tile_start, width: int, height: int, state, g,
                   pair_gauss=None):
    """K5 wrapper: per-pair world gradients [P, 8] in sorted-pair order given
    the forward's output `state` [7, H, W] and cotangents g [6, H, W] (r, g,
    b, z, z^2, silhouette). world8 and pair_gauss as fused_forward takes
    them. Every slot is written: pairs no pixel reached get 0."""
    if not world8.is_cuda:
        return fused_backward_plain(world8, pose_vec, tile_start, width, height, state, g,
                                    pair_gauss)
    gx, gy, n_pairs = _check_common(world8, pose_vec, tile_start, width, height, pair_gauss)
    _cuda.require(state, "state", torch.float32, (CH + 2, height, width))
    _cuda.require(g, "g", torch.float32, (CH + 1, height, width))
    out = torch.empty((n_pairs, W8), dtype=torch.float32, device=world8.device)
    _cuda.launch(world8, "fused_backward", world8.data_ptr(), _ptr(pair_gauss),
                 pose_vec.data_ptr(), tile_start.data_ptr(), gx, gy, width, height,
                 state.data_ptr(), g.data_ptr(), out.data_ptr())
    fused_backward.launches += 1
    return out


fused_backward.launches = 0


# ---------------------------------------------------------------------------
# autograd around the kernels
# ---------------------------------------------------------------------------


def _pose_grads(rmat, dpair, mw):
    """Per-pair world-mean grads -> (dR, dt): d_mean_cam = R d_mean_w, so
    dt = sum_p R dmw_p and dR = (R dmw) mw^T — two small f32 matmuls."""
    dmc = rmat @ dpair[:, 0:3].T  # [3, P]
    return dmc @ mw, dmc.sum(dim=1)


class FusedPairs(torch.autograd.Function):
    """Tracking render: world8 [P, 8] is a rebin-time constant; gradients
    flow to (rmat, t) only."""

    @staticmethod
    def forward(ctx, world8, rmat, t, tile_start, geom):
        width, height, intr = geom
        pose = make_pose_vec(rmat.detach(), t.detach(), width, height, *intr)
        out = fused_forward(world8, pose, tile_start, width, height)
        ctx.save_for_backward(world8, rmat, pose, tile_start, out)
        ctx.geom = geom
        return out[:CH + 1]

    @staticmethod
    def backward(ctx, g):
        world8, rmat, pose, tile_start, out = ctx.saved_tensors
        width, height, _ = ctx.geom
        dpair = fused_backward(world8, pose, tile_start, width, height, out,
                               g.contiguous())
        d_rmat, d_t = _pose_grads(rmat.detach(), dpair, world8[:, 0:3])
        return None, d_rmat, d_t, None, None


class FusedGauss(torch.autograd.Function):
    """Mapping render: K4 and K5 read the per-Gaussian world rows [N, 8]
    through ps.pair_gauss (no per-pair copy is made); gradients flow to the
    rows through K5 and then K3; the pose is a constant."""

    @staticmethod
    def forward(ctx, world8_rows, rmat, t, ps, geom):
        width, height, intr = geom
        pose = make_pose_vec(rmat, t, width, height, *intr)
        out = fused_forward(world8_rows, pose, ps.tile_start, width, height, ps.pair_gauss)
        ctx.save_for_backward(world8_rows, pose, out)
        ctx.ps, ctx.geom = ps, geom
        return out[:CH + 1]

    @staticmethod
    def backward(ctx, g):
        world8_rows, pose, out = ctx.saved_tensors
        ps = ctx.ps
        width, height, _ = ctx.geom
        dpair = fused_backward(world8_rows, pose, ps.tile_start, width, height, out,
                               g.contiguous(), ps.pair_gauss)
        d_rows = segment_reduce(dpair, ps.dst, ps.offsets, ps.counts)
        return d_rows, None, None, None, None


def _geom_for(cam, intrinsics_override=None, lim_wh=None):
    """(width, height, (fx, fy, cx, cy, limx, limy)) of a render through
    cam; intrinsics_override (fx, fy, cx, cy) and lim_wh (the frustum
    clamp's width, height) as render.api.render_gaussians takes them (one
    band of a larger image: cy shifted by the band's first row, the full
    image's limits; parallel/spatial.py)."""
    fx, fy, cx, cy = (intrinsics_override if intrinsics_override is not None
                      else (cam.fx, cam.fy, cam.cx, cam.cy))
    lim_w, lim_h = lim_wh if lim_wh is not None else (cam.width, cam.height)
    limx = 1.3 * (lim_w / (2.0 * fx))
    limy = 1.3 * (lim_h / (2.0 * fy))
    return (cam.width, cam.height, (fx, fy, cx, cy, limx, limy))


def composite_fused_pairs(world8, ps, cam, q, t, intrinsics_override=None, lim_wh=None):
    """Tracking fused render, differentiable in (q, t). Returns [6, H, W]:
    r, g, b, z, z^2, silhouette. intrinsics_override and lim_wh as
    _geom_for takes them."""
    rmat = build_rotation(normalize(q)[None])[0]
    return FusedPairs.apply(world8, rmat, t, ps.tile_start,
                            _geom_for(cam, intrinsics_override, lim_wh))


def composite_fused_gauss(means3d, logit_opacities, log_scales, rgb_colors, active,
                          ps, cam, q, t, intrinsics_override=None, lim_wh=None):
    """Mapping fused render, differentiable in the Gaussian parameters.
    Returns [6, H, W]: r, g, b, z, z^2, silhouette. intrinsics_override and
    lim_wh as _geom_for takes them."""
    rows = pack_world8(means3d, logit_opacities, log_scales, rgb_colors, active)
    rmat = build_rotation(normalize(q.detach())[None])[0]
    return FusedGauss.apply(rows, rmat, t.detach(), ps,
                            _geom_for(cam, intrinsics_override, lim_wh))
