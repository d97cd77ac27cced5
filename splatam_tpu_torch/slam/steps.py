"""SLAM phases as eager loops: loss, tracking, mapping, densification.

Counterpart of splatam_tpu/slam/steps.py (reference: scripts/splatam.py
get_loss :214-347, tracking :690-744, mapping :828-891, add_new_gaussians
:378-420). The reference package runs each phase as one jitted program;
here each phase is a Python loop over iterations whose renders launch the
CUDA kernels. Host syncs are kept to what the control flow needs: one per
structure build (the exact pair count), the depth_loss_thres check, and
densification's candidate count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.core.losses import calc_ssim
from splatam_tpu_torch.core.transforms import build_rotation, normalize
from splatam_tpu_torch.render import api
from splatam_tpu_torch.render.fused_iso import pack_world8
from splatam_tpu_torch.slam import optim


@dataclass(frozen=True)
class PhaseConfig:
    """Per-phase loss configuration (fields as the reference package's)."""

    use_sil_for_loss: bool
    sil_thres: float
    use_l1: bool
    ignore_outlier_depth_loss: bool
    w_im: float
    w_depth: float
    depth_unc_thres: float = 0.0
    outlier_floor: float = 0.0


class LossAux(NamedTuple):
    weighted_depth_loss: torch.Tensor
    weighted_im_loss: torch.Tensor
    silhouette: torch.Tensor
    render_depth: torch.Tensor


def transform_to_frame(gm: GaussianMap, q, t, gaussians_grad: bool, camera_grad: bool):
    """World -> camera transform with phase-gated gradients
    (utils/slam_helpers.py:252-304). Isotropic maps keep their rotations."""
    if not gm.isotropic:
        raise NotImplementedError(
            "anisotropic maps need the composite-backward kernel "
            "(ROADMAP, TPU kernel list item 5)"
        )
    cam_rot = normalize(q) if camera_grad else normalize(q).detach()
    cam_tran = t if camera_grad else t.detach()
    pts = gm.means3d if gaussians_grad else gm.means3d.detach()
    rmat = build_rotation(cam_rot[None])[0]
    return pts @ rmat.T + cam_tran, gm.unnorm_rotations


def _median_lower(x: torch.Tensor) -> torch.Tensor:
    """torch.median semantics: lower of the two central order statistics."""
    flat = x.reshape(-1)
    return torch.sort(flat).values[(flat.shape[0] - 1) // 2]


def get_loss(gm: GaussianMap, q, t, color, depth_gt, cam: Camera, pcfg: PhaseConfig,
             tracking: bool, mapping: bool, pair_structure: api.PairStructure):
    """Reference get_loss on the fused renders: tracking differentiates the
    pose through the pair-space render, mapping the Gaussian parameters
    through the fused mapping render."""
    if tracking:
        out = api.render_rgbd_sil_pairspace(cam, pair_structure, q, t)
    elif mapping:
        out = api.render_rgbd_sil_mapping_fused(
            cam, pair_structure, gm.means3d, gm.rgb_colors, gm.logit_opacities,
            gm.log_scales, gm.active, q, t)
    else:
        raise NotImplementedError("get_loss serves the tracking and mapping phases")

    depth = out.depth
    silhouette = out.silhouette
    uncertainty = (out.depth_sq - depth * depth).detach()
    nan_mask = ~torch.isnan(depth) & ~torch.isnan(uncertainty)
    valid = depth_gt > 0
    if pcfg.ignore_outlier_depth_loss:
        depth_error = torch.abs(depth_gt - depth).detach() * valid
        thresh = 10.0 * _median_lower(depth_error)
        if pcfg.outlier_floor > 0.0:
            thresh = torch.clamp(thresh, min=pcfg.outlier_floor)
        mask = (depth_error < thresh) & valid
    else:
        mask = valid
    mask = mask & nan_mask
    if tracking and pcfg.use_sil_for_loss:
        mask = mask & (silhouette > pcfg.sil_thres)
    if pcfg.depth_unc_thres > 0.0:
        s = torch.clamp(silhouette, min=1e-6)
        var_norm = (out.depth_sq / s - (depth / s) ** 2).detach()
        mask = mask & (var_norm < pcfg.depth_unc_thres**2)
    mask = mask.detach()

    if tracking:
        depth_loss = torch.sum(torch.abs(depth_gt - depth) * mask)
    else:
        cnt = torch.clamp(mask.sum(), min=1)
        depth_loss = torch.sum(torch.abs(depth_gt - depth) * mask) / cnt

    if tracking and (pcfg.use_sil_for_loss or pcfg.ignore_outlier_depth_loss):
        im_loss = torch.sum(torch.abs(color - out.im) * mask[None])
    elif tracking:
        im_loss = torch.sum(torch.abs(color - out.im))
    else:
        im_loss = 0.8 * torch.abs(out.im - color).mean() + 0.2 * (
            1.0 - calc_ssim(out.im, color))

    w_depth = pcfg.w_depth * depth_loss
    w_im = pcfg.w_im * im_loss
    aux = LossAux(w_depth.detach(), w_im.detach(), silhouette.detach(), depth.detach())
    return w_depth + w_im, aux


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------


def loss_pair_structure(gm: GaussianMap, q, t, cam: Camera,
                        with_world8: bool = False) -> api.PairStructure:
    """The reusable binning structure for a get_loss render at this pose and
    parameter snapshot; with_world8 also gathers the world-8 rows per sorted
    pair (tracking's rebin sites)."""
    with torch.no_grad():
        means_cam, rots_cam = transform_to_frame(gm, q, t, False, False)
        ps = api.compute_pair_structure(cam, means_cam, rots_cam, gm.logit_opacities,
                                        gm.log_scales, gm.active)
        if with_world8:
            w8 = pack_world8(gm.means3d, gm.logit_opacities, gm.log_scales,
                             gm.rgb_colors, gm.active)
            ps = ps._replace(world8=w8[ps.pair_gauss.long()].contiguous())
    return ps


def tracking_phase(gm: GaussianMap, q0, t0, color, depth_gt, cam: Camera, num_iters: int,
                   use_depth_loss_thres: bool, depth_loss_thres: float, lr_q: float,
                   lr_t: float, pcfg: PhaseConfig, rebin_every: int,
                   lr_decay_frac: float = 1.0):
    """Tracking optimization for one frame: fresh Adam on (q, t); the
    best-loss candidate pairs the post-step pose with the pre-step loss (a
    reference quirk kept); optional one-time doubling of the iteration count
    when the weighted depth loss is above depth_loss_thres; the pair
    structure is rebuilt every rebin_every iterations.

    Returns (best_q, best_t, iterations run, min loss)."""
    if rebin_every <= 1:
        raise NotImplementedError(
            "rebin_every=1 (per-iteration binning) needs the composite-backward "
            "kernel (ROADMAP, TPU kernel list item 5)"
        )
    gm = GaussianMap(*(a.detach() for a in gm))
    qt = (q0.detach().clone(), t0.detach().clone())
    st = optim.adam_init(qt)
    ps = loss_pair_structure(gm, q0, t0, cam, with_world8=True)
    best_q, best_t = q0.detach().clone(), t0.detach().clone()
    min_loss = torch.tensor(1e20, dtype=torch.float32, device=q0.device)
    limit, it = num_iters, 0
    while it < limit:
        if it > 0 and it % rebin_every == 0:
            ps = loss_pair_structure(gm, qt[0], qt[1], cam, with_world8=True)
        q = qt[0].requires_grad_(True)
        t = qt[1].requires_grad_(True)
        loss, aux = get_loss(gm, q, t, color, depth_gt, cam, pcfg, True, False, ps)
        grads = torch.autograd.grad(loss, (q, t))
        decay = 1.0
        if lr_decay_frac < 1.0:
            decay = lr_decay_frac ** (min(it, num_iters - 1) / max(num_iters - 1, 1))
        qt, st = optim.adam_step(st, (q.detach(), t.detach()), grads,
                                 (lr_q * decay, lr_t * decay), eps=1e-8)
        loss = loss.detach()
        better = loss < min_loss
        best_q = torch.where(better, qt[0], best_q)
        best_t = torch.where(better, qt[1], best_t)
        min_loss = torch.minimum(loss, min_loss)
        if use_depth_loss_thres and it + 1 == num_iters and limit == num_iters:
            # Reference checks only here (scripts/splatam.py:727-738).
            if not bool(aux.weighted_depth_loss < depth_loss_thres):
                limit = 2 * num_iters
        it += 1
    return best_q, best_t, it, min_loss


# ---------------------------------------------------------------------------
# Mapping
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PruneConfig:
    """pruning_dict (configs/replica/splatam.py:102-111)."""

    enabled: bool = True
    start_after: int = 0
    remove_big_after: int = 0
    stop_after: int = 20
    prune_every: int = 20
    removal_opacity_threshold: float = 0.005
    final_removal_opacity_threshold: float = 0.005
    reset_opacities: bool = False
    reset_opacities_every: int = 500


def _prune_mask(logit_op, log_scales, active, it: int, scene_radius: float,
                pc: PruneConfig):
    if not (pc.start_after <= it <= pc.stop_after and it % pc.prune_every == 0):
        return active
    thresh = (pc.final_removal_opacity_threshold if it == pc.stop_after
              else pc.removal_opacity_threshold)
    to_remove = torch.sigmoid(logit_op) < thresh
    if it >= pc.remove_big_after:
        to_remove = to_remove | (torch.exp(log_scales).max(dim=1).values > 0.1 * scene_radius)
    return active & ~to_remove


def mapping_phase(gm: GaussianMap, kf_colors_u8, kf_depths, iter_slots, iter_qs, iter_ts,
                  scene_radius: float, cam: Camera, num_iters: int, pcfg: PhaseConfig,
                  prune_cfg: PruneConfig, lrs: tuple, struct_qs, struct_ts,
                  iter_struct_idx) -> GaussianMap:
    """Mapping iterations for one frame over keyframes drawn by the host.

    iter_slots / iter_struct_idx: per-iteration keyframe-store slot and row
    of the distinct-keyframe pose table (struct_qs, struct_ts). The pair
    structure of every distinct keyframe is built once up front from the
    phase-start parameters and reused by its iterations. lrs follows the
    reference's order (means, rgb, rotations, opacities, scales); an
    isotropic map's rotations take no gradient and stay as they are.
    Pruning happens before each optimizer step (utils/slam_external.py:
    167-188)."""
    gm = GaussianMap(*(a.detach() for a in gm))
    structs = [loss_pair_structure(gm, sq, st_, cam) for sq, st_ in zip(struct_qs, struct_ts)]
    params = (gm.means3d, gm.rgb_colors, gm.logit_opacities, gm.log_scales)
    plrs = (lrs[0], lrs[1], lrs[3], lrs[4])
    st = optim.adam_init(params)
    active = gm.active
    for i in range(num_iters):
        slot = int(iter_slots[i])
        color = kf_colors_u8[slot].to(torch.float32).permute(2, 0, 1) / 255.0
        depth_gt = kf_depths[slot]
        p = tuple(x.detach().requires_grad_(True) for x in params)
        gm_i = gm._replace(means3d=p[0], rgb_colors=p[1], logit_opacities=p[2],
                           log_scales=p[3], active=active)
        loss, _ = get_loss(gm_i, iter_qs[i], iter_ts[i], color, depth_gt, cam, pcfg,
                           False, True, structs[int(iter_struct_idx[i])])
        grads = torch.autograd.grad(loss, p)
        if prune_cfg.enabled:
            active = _prune_mask(params[2], params[3], active, i, scene_radius, prune_cfg)
            if (prune_cfg.reset_opacities and i > 0
                    and i % prune_cfg.reset_opacities_every == 0
                    and i <= prune_cfg.stop_after):
                inv_sig = torch.log(torch.tensor(0.01 / 0.99))
                params = params[:2] + (torch.full_like(params[2], float(inv_sig)),) + params[3:]
                st = optim.AdamState(m=tuple(torch.zeros_like(x) for x in st.m),
                                     v=tuple(torch.zeros_like(x) for x in st.v),
                                     step=st.step)
        params, st = optim.adam_step(st, params, grads, plrs, eps=1e-15)
    return gm._replace(means3d=params[0], rgb_colors=params[1], logit_opacities=params[2],
                       log_scales=params[3], active=active)


# ---------------------------------------------------------------------------
# Densification (silhouette-guided unprojection into free slots)
# ---------------------------------------------------------------------------


def backproject_pointcloud(color, depth, fx, fy, cx, cy, c2w):
    """Dense pixel backprojection (get_pointcloud, scripts/splatam.py:67-117):
    color [3,H,W], depth [H,W] -> world pts [H*W,3], cols [H*W,3],
    mean3_sq_dist [H*W]."""
    h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device),
                            torch.arange(w, device=depth.device), indexing="ij")
    xx = (xs.to(torch.float32) - cx) / fx
    yy = (ys.to(torch.float32) - cy) / fy
    z = depth.reshape(-1)
    pts_cam = torch.stack([xx.reshape(-1) * z, yy.reshape(-1) * z, z], dim=-1)
    pts = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    cols = color.reshape(3, -1).T
    scale_gaussian = z / ((fx + fy) / 2.0)
    return pts, cols, scale_gaussian * scale_gaussian


@torch.no_grad()
def densify_step(gm: GaussianMap, timestep, color, depth_gt, q, t, time_idx: int,
                 cam: Camera, sil_thres: float):
    """add_new_gaussians (scripts/splatam.py:378-420): backproject every
    pixel the map does not explain into the lowest free slots.

    Returns (gm, timestep, n_added, n_dropped); with n_dropped > 0 nothing
    is written and the caller grows the capacity and retries."""
    span = gm.span()
    view = GaussianMap(*(a[:span] for a in gm))
    means_cam, rots_cam = transform_to_frame(view, q, t, False, False)
    out = api.render_rgbd_sil(cam, means_cam, view.rgb_colors, rots_cam,
                              view.logit_opacities, view.log_scales, view.active)
    valid = depth_gt > 0
    depth_error = torch.abs(depth_gt - out.depth) * valid
    non_presence = (out.silhouette < sil_thres) | (
        (out.depth > depth_gt) & (depth_error > 50.0 * _median_lower(depth_error)))
    cand = torch.nonzero((non_presence & valid).reshape(-1))[:, 0]
    free = torch.nonzero(~gm.active)[:, 0]
    n_cand, n_free = cand.shape[0], free.shape[0]
    if n_cand > n_free:
        return gm, timestep, 0, n_cand - n_free

    w2c = torch.eye(4, dtype=torch.float32, device=q.device)
    w2c[:3, :3] = build_rotation(normalize(q)[None])[0]
    w2c[:3, 3] = t
    pts, cols, mean_sq = backproject_pointcloud(
        color, depth_gt, cam.fx, cam.fy, cam.cx, cam.cy, torch.linalg.inv(w2c))
    dest = free[:n_cand]
    means3d, rgb = gm.means3d.clone(), gm.rgb_colors.clone()
    rots, logit = gm.unnorm_rotations.clone(), gm.logit_opacities.clone()
    log_scales, active = gm.log_scales.clone(), gm.active.clone()
    means3d[dest] = pts[cand]
    rgb[dest] = cols[cand]
    rots[dest] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=q.device)
    logit[dest] = 0.0
    log_scales[dest] = 0.5 * torch.log(torch.clamp(mean_sq[cand], min=1e-12))[:, None]
    active[dest] = True
    timestep = timestep.clone()
    timestep[dest] = float(time_idx)
    return GaussianMap(means3d, rgb, rots, logit, log_scales, active), timestep, n_cand, 0


@torch.no_grad()
def first_frame_pointcloud(color, depth_gt, cam: Camera):
    """Dense init cloud for frame 0: every valid-depth pixel becomes a
    Gaussian (initialize_first_timestep, scripts/splatam.py:169-211)."""
    c2w = torch.eye(4, dtype=torch.float32, device=color.device)
    pts, cols, mean_sq = backproject_pointcloud(
        color, depth_gt, cam.fx, cam.fy, cam.cx, cam.cy, c2w)
    return pts, cols, mean_sq, (depth_gt > 0).reshape(-1)
