"""Per-Gaussian screen-space preprocessing (EWA splatting).

Counterpart of splatam_tpu/render/projection.py `project`, expression by
expression: the reference's NDC pipeline (utils/recon_helpers.py:9-13 +
ndc2Pix), the EWA Jacobian with the 1.3*tanfov clamp, the +0.3 dilation,
the alpha-cutoff tile rectangle. Used to build pair structures and by the
generic (densify) render.

`project` is the plain version and the CPU's route. On the card the
projection is two hand-written kernels (csrc/projection.cu), wrapped by
`ProjectGauss`, an autograd Function that starts from the map's leaves
(render/api.py _prep_gaussians folded in) and keeps only its inputs:
`project_forward` returns what `project` returns, `project_backward` the
gradient in closed form, of which `project_backward_plain` is the
specification in PyTorch (any float dtype).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch

from splatam_tpu_torch.render import _cuda

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
            fx, fy, cx, cy, width: int, height: int, lim_wh: tuple | None = None):
    """EWA-project all Gaussians; means3d in the frame w2c maps from,
    scales [N, 3]. Returns (Projected, ProjectedAux).

    lim_wh: the (width, height) of the 1.3 * tan(fov) frustum clamp where
    it differs from the image's (a render of one band of a larger image
    passes the full image's, so the 2D covariances are the full render's
    while the tile grid is the band's)."""
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

    lim_w, lim_h = lim_wh if lim_wh is not None else (width, height)
    limx = 1.3 * (lim_w / (2.0 * fx))
    limy = 1.3 * (lim_h / (2.0 * fy))
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


def project_consts(w2c, fx, fy, cx, cy, width: int, height: int,
                   lim_wh: tuple | None = None) -> tuple[float, ...]:
    """The projection kernels' camera arguments (csrc/projection.cu
    ProjConsts): w2c's rotation (row-major) and translation, fx, fy, the NDC
    terms 2 fx / W, (W - 2 cx) / W, 2 fy / H, (H - 2 cy) / H, the clamp's
    limx, limy, W, H and the tile grid, each formed in double as `project`
    forms it and rounded to float32 by the call, as PyTorch rounds a Python
    scalar against a float32 tensor. w2c: a nested 4x4 sequence."""
    lim_w, lim_h = lim_wh if lim_wh is not None else (width, height)
    return (*(float(w2c[i][j]) for i in range(3) for j in range(3)),
            *(float(w2c[i][3]) for i in range(3)), float(fx), float(fy),
            2.0 * fx / width, (width - 2.0 * cx) / width,
            2.0 * fy / height, (height - 2.0 * cy) / height,
            1.3 * (lim_w / (2.0 * fx)), 1.3 * (lim_h / (2.0 * fy)), float(width),
            float(height), float((width + TILE - 1) // TILE), float((height + TILE - 1) // TILE))


def _consts_arg(consts: tuple[float, ...]):
    return (ctypes.c_float * len(consts))(*consts)


def _leaves(means3d, unnorm_rotations, logit_opacities, log_scales, active):
    """The kernels' views of the leaves, checked: float32 [N, 3], [N, 4],
    [N] (from [N] or [N, 1]), [N, 1] or [N, 3], bool [N], contiguous."""
    n = means3d.shape[0]
    means3d, unnorm_rotations, log_scales = (x.contiguous() for x in (means3d, unnorm_rotations,
                                                                      log_scales))
    logit = logit_opacities.reshape(-1).contiguous()
    _cuda.require(means3d, "means3d", torch.float32, (n, 3))
    _cuda.require(unnorm_rotations, "unnorm_rotations", torch.float32, (n, 4))
    _cuda.require(logit, "logit_opacities", torch.float32, (n,))
    if log_scales.dim() != 2 or log_scales.shape[1] not in (1, 3):
        raise ValueError(f"log_scales: expected shape ({n}, 1) or ({n}, 3), got "
                         f"{tuple(log_scales.shape)}")
    _cuda.require(log_scales, "log_scales", torch.float32, (n, None))
    if active is not None:
        _cuda.require(active, "active", torch.bool, (n,))
    return means3d, unnorm_rotations, logit, log_scales, active


def project_forward(means3d, unnorm_rotations, logit_opacities, log_scales, active,
                    consts: tuple[float, ...]):
    """Kernel wrapper: (Projected, ProjectedAux) as `project` returns them for
    the leaves as the map holds them (unnormalised rotations, logit
    opacities [N] or [N, 1], log scales [N, 1] or [N, 3]); consts from
    project_consts. One launch."""
    means3d, quats, logit, log_scales, active = _leaves(means3d, unnorm_rotations,
                                                        logit_opacities, log_scales, active)
    n, dev = means3d.shape[0], means3d.device
    f32 = dict(dtype=torch.float32, device=dev)
    xy, depth = torch.empty((n, 2), **f32), torch.empty((n,), **f32)
    conic, opacity = torch.empty((n, 3), **f32), torch.empty((n,), **f32)
    radius = torch.empty((n,), dtype=torch.int32, device=dev)
    rect_min = torch.empty((n, 2), dtype=torch.int64, device=dev)
    rect_wh = torch.empty((n, 2), dtype=torch.int64, device=dev)
    visible = torch.empty((n,), dtype=torch.bool, device=dev)
    _cuda.launch(means3d, "project_forward", n, _consts_arg(consts), means3d.data_ptr(),
                 quats.data_ptr(), logit.data_ptr(), log_scales.data_ptr(), log_scales.shape[1],
                 active.data_ptr(), xy.data_ptr(), depth.data_ptr(), conic.data_ptr(),
                 opacity.data_ptr(), radius.data_ptr(), rect_min.data_ptr(), rect_wh.data_ptr(),
                 visible.data_ptr())
    project_forward.launches += 1
    return (Projected(xy=xy, depth=depth, conic=conic, opacity=opacity),
            ProjectedAux(radius=radius, rect_min=rect_min, rect_wh=rect_wh, visible=visible))


project_forward.launches = 0


def _cot_args(g, shape: tuple, device) -> tuple:
    """A cotangent as the backward kernel takes it: a pointer (null for
    none) and its strides in elements, which may be any (autograd hands over
    column slices of K3's output, or expanded tensors)."""
    if g is None:
        return (None, *(0 for _ in shape))
    if g.dtype != torch.float32 or tuple(g.shape) != shape or g.device != device:
        raise ValueError(f"cotangent: expected float32 {shape} on {device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    return (g.data_ptr(), *g.stride())


def project_backward(means3d, unnorm_rotations, logit_opacities, log_scales,
                     consts: tuple[float, ...], cot, needs=(True, True, True, True)):
    """Kernel wrapper: the gradients (means3d, unnorm_rotations,
    logit_opacities, log_scales), each in its input's shape, of the
    projection given the cotangents cot = (xy [N, 2], depth [N], conic
    [N, 3], opacity [N]), each None for zero and read at its own strides;
    None where `needs` asks for none. One launch."""
    means3d, quats, logit, ls, _ = _leaves(means3d, unnorm_rotations, logit_opacities,
                                           log_scales, None)
    n, dev = means3d.shape[0], means3d.device
    outs = [torch.empty(shape, dtype=torch.float32, device=dev) if need else None
            for need, shape in zip(needs, ((n, 3), (n, 4), (n,), tuple(ls.shape)))]
    g_xy, g_depth, g_conic, g_op = cot
    _cuda.launch(means3d, "project_backward", n, _consts_arg(consts), means3d.data_ptr(),
                 quats.data_ptr(), logit.data_ptr(), ls.data_ptr(), ls.shape[1],
                 *_cot_args(g_xy, (n, 2), dev), *_cot_args(g_depth, (n,), dev),
                 *_cot_args(g_conic, (n, 3), dev), *_cot_args(g_op, (n,), dev),
                 *(None if o is None else o.data_ptr() for o in outs))
    project_backward.launches += 1
    if outs[2] is not None:
        outs[2] = outs[2].reshape(logit_opacities.shape)
    return tuple(outs)


project_backward.launches = 0


class ProjectGauss(torch.autograd.Function):
    """The projection of the map's leaves on the card: forward
    project_forward, backward project_backward, which writes only the
    gradients autograd asks for. Keeps its inputs, nothing else."""

    @staticmethod
    def forward(ctx, means3d, unnorm_rotations, logit_opacities, log_scales, active, consts):
        proj, aux = project_forward(means3d, unnorm_rotations, logit_opacities, log_scales,
                                    active, consts)
        ctx.save_for_backward(means3d, unnorm_rotations, logit_opacities, log_scales)
        ctx.consts = consts
        ctx.mark_non_differentiable(*aux)
        ctx.set_materialize_grads(False)
        return (*proj, *aux)

    @staticmethod
    def backward(ctx, g_xy, g_depth, g_conic, g_opacity, *_aux):
        needs = ctx.needs_input_grad[:4]
        grads = project_backward(*ctx.saved_tensors, ctx.consts,
                                 (g_xy, g_depth, g_conic, g_opacity), needs)
        return (*grads, None, None)


def project_gauss(means3d, unnorm_rotations, logit_opacities, log_scales, active,
                  consts: tuple[float, ...]):
    """(Projected, ProjectedAux) through ProjectGauss."""
    out = ProjectGauss.apply(means3d, unnorm_rotations, logit_opacities, log_scales, active,
                             consts)
    return Projected(*out[:4]), ProjectedAux(*out[4:])


def _rotation_of(q):
    """[N, 3, 3]: _cov3d_components' rotation matrix of unit wxyz quaternions."""
    r, x, y, z = q.unbind(-1)
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
                        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
                        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
                       dim=-1).reshape(-1, 3, 3)


def project_state(means3d, unnorm_rotations, log_scales, w2c, fx, fy, cx, cy, width: int,
                  height: int, lim_wh: tuple | None = None) -> SimpleNamespace:
    """What the backward reads of the forward, recomputed from the leaves
    with `project`'s own expressions (csrc/projection.cu ProjState), so
    every branch (in_front, the clamps, det_ok) decides as it decides."""
    s = SimpleNamespace()
    rot3 = w2c[:3, :3]
    s.rot3 = rot3
    p_view = means3d @ rot3.T + w2c[:3, 3]
    s.px, s.py, s.tz = p_view.unbind(-1)
    s.in_front = s.tz > NEAR_CLIP
    s.safe_tz = torch.where(s.in_front, s.tz, torch.ones_like(s.tz))
    s.p_w = 1.0 / (s.safe_tz + 1e-7)
    s.ax, s.bx = 2.0 * fx / width, (width - 2.0 * cx) / width
    s.ay, s.by = 2.0 * fy / height, (height - 2.0 * cy) / height
    s.u = unnorm_rotations
    s.n1 = torch.linalg.vector_norm(s.u, dim=-1, keepdim=True)
    s.c1 = torch.clamp(s.n1, min=1e-12)
    s.q1 = s.u / s.c1
    s.n2 = torch.linalg.vector_norm(s.q1, dim=-1, keepdim=True)
    s.q = s.q1 / s.n2
    s.rq = _rotation_of(s.q)
    s.sc = torch.exp(log_scales.expand(-1, 3) if log_scales.shape[1] == 1 else log_scales)
    s.ss = s.sc * s.sc
    s00, s01, s02, s11, s12, s22 = _cov3d_components(s.q1, s.sc)
    sigma = [[s00, s01, s02], [s01, s11, s12], [s02, s12, s22]]
    wsig = [[sum(rot3[i, k] * sigma[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)]
    s.v = tuple(sum(wsig[i][k] * rot3[j, k] for k in range(3))
                for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)))
    lim_w, lim_h = lim_wh if lim_wh is not None else (width, height)
    s.limx, s.limy = 1.3 * (lim_w / (2.0 * fx)), 1.3 * (lim_h / (2.0 * fy))
    s.vx, s.vy = s.px / s.safe_tz, s.py / s.safe_tz
    s.txtz = torch.clamp(s.vx, -s.limx, s.limx)
    s.tytz = torch.clamp(s.vy, -s.limy, s.limy)
    s.tx, s.ty = s.txtz * s.safe_tz, s.tytz * s.safe_tz
    s.inv_z = 1.0 / s.safe_tz
    s.inv_z2 = s.inv_z * s.inv_z
    s.j00, s.j02 = fx * s.inv_z, -fx * s.tx * s.inv_z2
    s.j11, s.j12 = fy * s.inv_z, -fy * s.ty * s.inv_z2
    v00, v01, v02, v11, v12, v22 = s.v
    j00, j02, j11, j12 = s.j00, s.j02, s.j11, s.j12
    s.c00 = j00 * (j00 * v00 + j02 * v02) + j02 * (j00 * v02 + j02 * v22) + 0.3
    s.c01 = j11 * (j00 * v01 + j02 * v12) + j12 * (j00 * v02 + j02 * v22)
    s.c11 = j11 * (j11 * v11 + j12 * v12) + j12 * (j11 * v12 + j12 * v22) + 0.3
    s.det = s.c00 * s.c11 - s.c01 * s.c01
    s.det_ok = s.det != 0.0
    s.inv_det = 1.0 / torch.where(s.det_ok, s.det, torch.ones_like(s.det))
    return s


def project_backward_plain(cot, means3d, unnorm_rotations, logit_opacities, log_scales, w2c,
                           fx, fy, cx, cy, width: int, height: int, lim_wh: tuple | None = None,
                           needs=(True, True, True, True)):
    """The projection's gradient in closed form: what project_backward's
    kernel computes, in PyTorch (any float dtype). cot = (xy, depth, conic,
    opacity) cotangents, None for zero; returns the gradients of (means3d,
    unnorm_rotations, logit_opacities, log_scales) of _prep_gaussians and
    `project`, each in its input's shape, None where `needs` asks for none.
    PyTorch autograd's conventions at each branch: a clamp passes the
    gradient on its closed interval; safe_tz's and safe_det's replaced
    lanes, and the quaternion norm's clamp below 1e-12, pass none."""
    zero = means3d.new_zeros(means3d.shape[0])
    g_xy, g_depth, g_conic, g_op = cot
    gx, gy = (zero, zero) if g_xy is None else g_xy.unbind(-1)
    gd = zero if g_depth is None else g_depth
    ga, gb, gc = (zero, zero, zero) if g_conic is None else g_conic.unbind(-1)
    d_means = d_quats = d_logit = d_ls = None
    if needs[2]:
        op = torch.sigmoid(logit_opacities.reshape(-1))
        d_logit = ((zero if g_op is None else g_op) * (1 - op) * op).reshape(
            logit_opacities.shape)
    if not (needs[0] or needs[1] or needs[3]):
        return d_means, d_quats, d_logit, d_ls
    s = project_state(means3d, unnorm_rotations, log_scales, w2c, fx, fy, cx, cy, width, height,
                      lim_wh)
    v00, v01, v02, v11, v12, v22 = s.v
    j00, j02, j11, j12 = s.j00, s.j02, s.j11, s.j12

    # conic = (c11, -c01, c00) * inv_det, inv_det = 1 / where(det_ok, det, 1)
    dc11, dc01, dc00 = ga * s.inv_det, -(gb * s.inv_det), gc * s.inv_det
    d_inv = ga * s.c11 + gb * -s.c01 + gc * s.c00
    d_det = torch.where(s.det_ok, -d_inv * s.inv_det * s.inv_det, zero)
    dc00 = dc00 + d_det * s.c11
    dc11 = dc11 + d_det * s.c00
    dc01 = dc01 - 2.0 * d_det * s.c01
    # c00 = j00 A0 + j02 B0, c01 = j11 A1 + j12 B0, c11 = j11 A2 + j12 B2
    a0, b0, a1 = j00 * v00 + j02 * v02, j00 * v02 + j02 * v22, j00 * v01 + j02 * v12
    a2, b2 = j11 * v11 + j12 * v12, j11 * v12 + j12 * v22
    da0, db0, da1 = dc00 * j00, dc00 * j02 + dc01 * j12, dc01 * j11
    da2, db2 = dc11 * j11, dc11 * j12
    dj00 = dc00 * a0 + da0 * v00 + db0 * v02 + da1 * v01
    dj02 = dc00 * b0 + da0 * v02 + db0 * v22 + da1 * v12
    dj11 = dc01 * a1 + dc11 * a2 + da2 * v11 + db2 * v12
    dj12 = dc01 * b0 + dc11 * b2 + da2 * v12 + db2 * v22

    if needs[0]:
        # j00 = fx inv_z, j02 = -fx tx inv_z2 (and y), inv_z2 = inv_z^2, inv_z = 1 / safe_tz
        dtx, dty = dj02 * s.inv_z2 * -fx, dj12 * s.inv_z2 * -fy
        dinv_z2 = dj02 * (-fx * s.tx) + dj12 * (-fy * s.ty)
        dinv_z = dj00 * fx + dj11 * fy + 2.0 * dinv_z2 * s.inv_z
        dsafe = -dinv_z * s.inv_z * s.inv_z + dtx * s.txtz + dty * s.tytz
        # tx = clamp(px / safe_tz) safe_tz: the clamp passes its closed interval
        dvx = torch.where((s.vx >= -s.limx) & (s.vx <= s.limx), dtx * s.safe_tz, zero)
        dvy = torch.where((s.vy >= -s.limy) & (s.vy <= s.limy), dty * s.safe_tz, zero)
        dpx, dpy = dvx / s.safe_tz, dvy / s.safe_tz
        dsafe = dsafe - dvx * s.px / (s.safe_tz * s.safe_tz) - dvy * s.py / (s.safe_tz * s.safe_tz)
        # pix = ((ndc + 1) W - 1) / 2, ndc = (a p - b safe_tz) p_w, p_w = 1 / (safe_tz + 1e-7)
        dxn, dyn = gx * 0.5 * width, gy * 0.5 * height
        dpx = dpx + dxn * s.p_w * s.ax
        dpy = dpy + dyn * s.p_w * s.ay
        dp_w = dxn * (s.ax * s.px - s.bx * s.safe_tz) + dyn * (s.ay * s.py - s.by * s.safe_tz)
        dsafe = dsafe - dxn * s.p_w * s.bx - dyn * s.p_w * s.by - dp_w * s.p_w * s.p_w
        dtz = gd + torch.where(s.in_front, dsafe, zero)
        d_means = torch.stack([dpx, dpy, dtz], dim=-1) @ s.rot3  # p = W m + t
    if not (needs[1] or needs[3]):
        return d_means, d_quats, d_logit, d_ls

    # dv, the upper triangle of W Sigma W^T -> dSigma = W^T D W
    d = torch.stack([da0 * j00, da1 * j00, da0 * j02 + db0 * j00,
                     zero, da2 * j11, da1 * j02 + da2 * j12 + db2 * j11,
                     zero, zero, db0 * j02 + db2 * j12], dim=-1).reshape(-1, 3, 3)
    g = s.rot3.T @ d @ s.rot3
    # Sigma = R diag(S) R^T over its six components, each off-diagonal one read
    # at two places: dR = (G + G^T) R diag(S), dS = diag(R^T G R)
    d_rot = (g + g.transpose(1, 2)) @ s.rq * s.ss[:, None, :]
    d_ss = torch.diagonal(s.rq.transpose(1, 2) @ g @ s.rq, dim1=1, dim2=2)
    if needs[3]:
        dl = 2.0 * s.sc * d_ss * s.sc  # S = exp(l)^2
        d_ls = dl.sum(-1, keepdim=True) if log_scales.shape[1] == 1 else dl
    if needs[1]:
        r, x, y, z = s.q.unbind(-1)
        dr = d_rot.reshape(-1, 9).unbind(-1)
        dq = 2.0 * torch.stack([
            -z * dr[1] + y * dr[2] + z * dr[3] - x * dr[5] - y * dr[6] + x * dr[7],
            y * dr[1] + z * dr[2] + y * dr[3] - 2.0 * x * dr[4] - r * dr[5] + z * dr[6]
            + r * dr[7] - 2.0 * x * dr[8],
            -2.0 * y * dr[0] + x * dr[1] + r * dr[2] + x * dr[3] + z * dr[5] - r * dr[6]
            + z * dr[7] - 2.0 * y * dr[8],
            -2.0 * z * dr[0] - r * dr[1] + x * dr[2] + r * dr[3] - 2.0 * z * dr[4] + y * dr[5]
            + x * dr[6] + y * dr[7]], dim=-1)
        # q = q1 / |q1|; q1 = u / max(|u|, 1e-12); a norm of 0 passes nothing
        dn2 = -(dq * s.q1).sum(-1, keepdim=True) / (s.n2 * s.n2)
        dq1 = dq / s.n2 + torch.where(s.n2 != 0, s.q1 * (dn2 / s.n2), 0.0)
        dc1 = -(dq1 * s.u).sum(-1, keepdim=True) / (s.c1 * s.c1)
        dn1 = torch.where(s.n1 >= 1e-12, dc1, 0.0)
        d_quats = dq1 / s.c1 + torch.where(s.n1 != 0, s.u * (dn1 / s.n1), 0.0)
    return d_means, d_quats, d_logit, d_ls
