"""SLAM phases as eager loops: loss, tracking, mapping, densification.

Counterpart of splatam_tpu/slam/steps.py (reference: scripts/splatam.py
get_loss :214-347, tracking :690-744, mapping :828-891, add_new_gaussians
:378-420). The reference package runs each phase as one jitted program;
here each phase is a Python loop over iterations whose renders launch the
CUDA kernels. Host syncs are kept to what the control flow needs: one per
structure build (the exact pair count), the depth_loss_thres check, and
densification's candidate count; besides, every blocking upload from host
memory (a render's intrinsics) waits for the card.

Each iteration is a span `iter` (utils/spans.py) holding the spans
`build` (a structure build, render/api.py), `render`, `loss`, `backward`
and `adam`, and in mapping `draw` (the keyframe's conversion) and
`prune`; densification's are `render`, `select` and `write`. Every point
where the host waits for the card is a `waited` site.

Every phase takes `bands` (parallel.spatial.make_bands; None = one image):
its renders then run per band of rows and the loss on the gathered image,
as the JAX package's phases do with a mesh. Every phase also takes
`bin_opts` (render.binning.BinOptions, the config's tpu.tile_cull and
tpu.direct_j), which reaches each of its structure builds and each render
that bins, as the JAX package's phases pass their RenderConfig.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from splatam_tpu_torch.core import fused_loss
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap, grow_with_timestep
from splatam_tpu_torch.core.transforms import build_rotation, normalize, quat_mult
from splatam_tpu_torch.parallel import spatial
from splatam_tpu_torch.render import api, pairspace
from splatam_tpu_torch.render.binning import BinOptions
from splatam_tpu_torch.render.fused_iso import pack_world8
from splatam_tpu_torch.slam import optim
from splatam_tpu_torch.utils import spans


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
    radii: torch.Tensor  # [N] int32 screen radii of the render (all 0 off the generic render)


def transform_to_frame(gm: GaussianMap, q, t, gaussians_grad: bool, camera_grad: bool):
    """World -> camera transform with phase-gated gradients
    (utils/slam_helpers.py:252-304). Isotropic maps keep their rotations
    (a spherical covariance is rotation invariant); anisotropic ones are
    rotated by the camera."""
    cam_rot = normalize(q) if camera_grad else normalize(q).detach()
    cam_tran = t if camera_grad else t.detach()
    pts = gm.means3d if gaussians_grad else gm.means3d.detach()
    rots = gm.unnorm_rotations if gaussians_grad else gm.unnorm_rotations.detach()
    rmat = build_rotation(cam_rot[None])[0]
    means_cam = pts @ rmat.T + cam_tran
    if gm.isotropic:
        return means_cam, rots
    return means_cam, quat_mult(cam_rot[None], normalize(rots))


def _median_lower(x: torch.Tensor) -> torch.Tensor:
    """torch.median semantics: lower of the two central order statistics."""
    flat = x.reshape(-1)
    return torch.sort(flat).values[(flat.shape[0] - 1) // 2]


def loss_render(gm: GaussianMap, q, t, cam: Camera, tracking: bool, mapping: bool,
                pair_structure: api.PairStructure | None = None, means2d_dummy=None,
                bands: list | None = None, bin_opts: BinOptions = api.CLASSIC
                ) -> api.RenderOutput:
    """get_loss's render, routed as the JAX package routes it: tracking
    with a world-8/16 structure renders in pair space (gradients to the
    pose), mapping an isotropic map with a structure and no means2d_dummy
    takes the fused mapping render, and everything else the generic render
    of transform_to_frame's camera-frame Gaussians, with the phase-gated
    detaches (tracking: camera only; otherwise the Gaussians only).
    means2d_dummy (the 3DGS statistics harvest, api.render_rgbd_sil) keeps
    mapping on the generic render: the fused render's world-space backward
    forms no per-Gaussian screen gradient and its radii are all zero
    (splatam_tpu/slam/steps.py:140-150).

    With `bands`, each render runs per band (parallel.spatial) and
    pair_structure is loss_pair_structure's per-band list."""
    ps = head = pair_structure
    if bands is not None and ps is not None:
        spatial.check_structs(bands, ps)
        head = ps[0]
    if tracking and head is not None and (head.world8 is not None or head.world16 is not None):
        return (api.render_rgbd_sil_pairspace(cam, ps, q, t) if bands is None else
                spatial.render_rgbd_sil_pairspace_sharded(bands, cam, ps, q, t))
    if mapping and ps is not None and gm.isotropic and means2d_dummy is None:
        args = (gm.means3d, gm.rgb_colors, gm.logit_opacities, gm.log_scales, gm.active, q, t)
        return (api.render_rgbd_sil_mapping_fused(cam, ps, *args) if bands is None else
                spatial.render_rgbd_sil_mapping_fused_sharded(bands, cam, ps, *args))
    means_cam, rots_cam = transform_to_frame(gm, q, t, not tracking, tracking)
    params_grad = mapping or not tracking
    keep = (lambda x: x) if params_grad else (lambda x: x.detach())
    args = (means_cam, keep(gm.rgb_colors), rots_cam, keep(gm.logit_opacities),
            keep(gm.log_scales), gm.active)
    if bands is None:
        return api.render_rgbd_sil(cam, *args, pair_structure=ps, means2d_dummy=means2d_dummy,
                                   bin_opts=bin_opts)
    return spatial.render_rgbd_sil_sharded(bands, cam, *args, means2d_dummy=means2d_dummy,
                                           pair_structure=ps, bin_opts=bin_opts)


def get_loss(gm: GaussianMap, q, t, color, depth_gt, cam: Camera, pcfg: PhaseConfig,
             tracking: bool, mapping: bool, pair_structure: api.PairStructure | None = None,
             means2d_dummy=None, bands: list | None = None,
             bin_opts: BinOptions = api.CLASSIC):
    """Reference get_loss on loss_render's image (with `bands`, the loss
    below runs once, on the gathered image): the spans `render` and `loss`.
    On the card the loss is one kernel with its gradient in closed form
    (core/fused_loss.py fused_loss); on the CPU, PyTorch ops through
    autograd (fused_loss.loss_composition)."""
    with spans.span("render"):
        out = loss_render(gm, q, t, cam, tracking, mapping, pair_structure, means2d_dummy,
                          bands, bin_opts)
    with spans.span("loss"):
        thresh = (_outlier_thresh(out.depth.detach(), depth_gt, pcfg)
                  if pcfg.ignore_outlier_depth_loss else None)
        loss_fn = fused_loss.fused_loss if out.depth.is_cuda else fused_loss.loss_composition
        loss, w_depth, w_im = loss_fn(out.im, out.depth, out.depth_sq, out.silhouette, color,
                                      depth_gt, fused_loss.route(pcfg, tracking), thresh)
        aux = LossAux(w_depth.detach(), w_im.detach(), out.silhouette.detach(),
                      out.depth.detach(), out.radii)
        return loss, aux


def _outlier_thresh(depth, depth_gt, pcfg: PhaseConfig) -> torch.Tensor:
    """ignore_outlier_depth_loss's threshold: 10 x the lower median of the
    depth error |depth_gt - depth| (0 where depth_gt is not), at least
    pcfg.outlier_floor where that is set."""
    thresh = 10.0 * _median_lower(torch.abs(depth_gt - depth) * (depth_gt > 0))
    if pcfg.outlier_floor > 0.0:
        thresh = torch.clamp(thresh, min=pcfg.outlier_floor)
    return thresh


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------


def loss_pair_structure(gm: GaussianMap, q, t, cam: Camera, with_world16: bool = False,
                        bands: list | None = None, bin_opts: BinOptions = api.CLASSIC):
    """The reusable binning structure for a get_loss render at this pose and
    parameter snapshot; with_world16 also gathers the world rows per sorted
    pair for the pair-space tracking render (tracking's rebin sites):
    world-8 rows for an isotropic map, world-16 rows otherwise. With
    `bands`, the list of the bands' structures, each gathering its own
    rows (parallel.spatial.compute_pair_structure_sharded)."""
    with torch.no_grad():
        means_cam, rots_cam = transform_to_frame(gm, q, t, False, False)
        rows8 = rows16 = None
        if with_world16 and gm.isotropic:
            rows8 = pack_world8(gm.means3d, gm.logit_opacities, gm.log_scales, gm.rgb_colors,
                                gm.active)
        elif with_world16:
            rows16 = pairspace.pack_world_rows(gm.means3d, gm.unnorm_rotations,
                                               gm.logit_opacities, gm.log_scales,
                                               gm.rgb_colors, gm.active)
        args = (cam, means_cam, rots_cam, gm.logit_opacities, gm.log_scales, gm.active)
        if bands is not None:
            return spatial.compute_pair_structure_sharded(bands, *args, world_rows=rows16,
                                                          world_rows8=rows8, bin_opts=bin_opts)
        return api.compute_pair_structure(*args, world_rows=rows16, world_rows8=rows8,
                                          bin_opts=bin_opts)


def tracking_phase(gm: GaussianMap, q0, t0, color, depth_gt, cam: Camera, num_iters: int,
                   use_depth_loss_thres: bool, depth_loss_thres: float, lr_q: float,
                   lr_t: float, pcfg: PhaseConfig, rebin_every: int,
                   lr_decay_frac: float = 1.0, record_hist: bool = False,
                   bands: list | None = None, bin_opts: BinOptions = api.CLASSIC):
    """Tracking optimization for one frame: fresh Adam on (q, t); the
    best-loss candidate pairs the post-step pose with the pre-step loss (a
    reference quirk kept); optional one-time doubling of the iteration count
    when the weighted depth loss is above depth_loss_thres. With
    rebin_every > 1 the pair structure is rebuilt every rebin_every
    iterations and the render runs in pair space; with 1 every iteration
    bins anew through the generic render (reference semantics).

    Returns (best_q, best_t, iterations run, min loss, hist): with
    record_hist, hist is a device tensor [iterations run, 3] of (loss,
    weighted depth loss, weighted im loss) per iteration, written into a
    preallocated buffer (no host sync); else None."""
    use_rebin = rebin_every > 1
    gm = GaussianMap(*(a.detach() for a in gm))
    qt = (q0.detach().clone(), t0.detach().clone())
    st = optim.adam_init(qt)
    ps = (loss_pair_structure(gm, q0, t0, cam, with_world16=True, bands=bands,
                              bin_opts=bin_opts)
          if use_rebin else None)
    best_q, best_t = q0.detach().clone(), t0.detach().clone()
    with spans.waited("track.min_loss"):
        min_loss = torch.tensor(1e20, dtype=torch.float32, device=q0.device)
    hist = torch.zeros((2 * num_iters, 3), device=q0.device) if record_hist else None
    limit, it = num_iters, 0
    while it < limit:
        with spans.span("iter"):
            if use_rebin and it > 0 and it % rebin_every == 0:
                ps = loss_pair_structure(gm, qt[0], qt[1], cam, with_world16=True,
                                         bands=bands, bin_opts=bin_opts)
            q = qt[0].requires_grad_(True)
            t = qt[1].requires_grad_(True)
            loss, aux = get_loss(gm, q, t, color, depth_gt, cam, pcfg, True, False, ps,
                                 bands=bands, bin_opts=bin_opts)
            with spans.span("backward"):
                grads = torch.autograd.grad(loss, (q, t))
            decay = 1.0
            if lr_decay_frac < 1.0:
                decay = lr_decay_frac ** (min(it, num_iters - 1) / max(num_iters - 1, 1))
            with spans.span("adam"):
                qt, st = optim.adam_step(st, (q.detach(), t.detach()), grads,
                                         (lr_q * decay, lr_t * decay), eps=1e-8)
            loss = loss.detach()
            if hist is not None:
                hist[it] = torch.stack([loss, aux.weighted_depth_loss, aux.weighted_im_loss])
            better = loss < min_loss
            best_q = torch.where(better, qt[0], best_q)
            best_t = torch.where(better, qt[1], best_t)
            min_loss = torch.minimum(loss, min_loss)
            if use_depth_loss_thres and it + 1 == num_iters and limit == num_iters:
                # Reference checks only here (scripts/splatam.py:727-738).
                with spans.waited("track.depth_thres"):
                    below = bool(aux.weighted_depth_loss < depth_loss_thres)
                if not below:
                    limit = 2 * num_iters
        it += 1
    return best_q, best_t, it, min_loss, None if hist is None else hist[:it]


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


MAP_PARAMS = ("means3d", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")


def mapping_phase(gm: GaussianMap, kf_colors_u8, kf_depths, iter_slots, iter_qs, iter_ts,
                  scene_radius: float, cam: Camera, num_iters: int, pcfg: PhaseConfig,
                  prune_cfg: PruneConfig, lrs: tuple, struct_qs=None, struct_ts=None,
                  iter_struct_idx=None, record_hist: bool = False, opt_state=None,
                  gsvars=None, start_iter: int = 0, track_stats: bool = False,
                  bands: list | None = None, bin_opts: BinOptions = api.CLASSIC):
    """Mapping iterations for one frame over keyframes drawn by the host.

    iter_slots: per-iteration keyframe-store slot. With a distinct-keyframe
    pose table (struct_qs, struct_ts) and each iteration's row of it
    (iter_struct_idx), the pair structure of every distinct keyframe is
    built once up front from the phase-start parameters and reused by its
    iterations; without one, every iteration bins anew. lrs follows the
    reference's order (MAP_PARAMS); an isotropic map's rotations never
    enter a render, so they take no step, stay as they are and carry no
    Adam moments. Pruning happens before each optimizer step
    (utils/slam_external.py:167-188).

    Resumable (splatam_tpu/slam/steps.py:539-720), so a caller can run the
    phase in chunks with 3DGS clone/split between them: opt_state (Adam over
    the parameters that step, in MAP_PARAMS order; fresh when None) and
    gsvars (means2d_grad_accum, denom, max_2d_radius, [N] each; zeros when
    None and track_stats) come in and go out, and the prune and opacity-reset schedules count the
    absolute iteration start_iter + i. With track_stats each iteration
    harvests the screen-space gradient through a means2d_dummy (which keeps
    the generic render, see get_loss): where radii > 0 it adds the
    gradient's norm to means2d_grad_accum and one to denom, and keeps the
    running max of the radii.

    Returns (map, opt_state, gsvars, hist): with record_hist, hist is a
    device tensor [num_iters, 3] of (loss, weighted depth loss, weighted im
    loss) per iteration (as tracking_phase's); else None."""
    gm = GaussianMap(*(a.detach() for a in gm))
    structs = None
    if struct_qs is not None:
        structs = [loss_pair_structure(gm, sq, st_, cam, bands=bands, bin_opts=bin_opts)
                   for sq, st_ in zip(struct_qs, struct_ts)]
    keys = tuple(k for k in MAP_PARAMS if not (gm.isotropic and k == "unnorm_rotations"))
    plrs = tuple(lrs[MAP_PARAMS.index(k)] for k in keys)
    params = {k: getattr(gm, k) for k in keys}
    st = optim.adam_init(tuple(params.values())) if opt_state is None else opt_state
    active = gm.active
    dev = active.device
    if track_stats and gsvars is None:
        zeros = torch.zeros((gm.capacity,), dtype=torch.float32, device=dev)
        gsvars = (zeros, zeros, zeros)
    hist = torch.zeros((num_iters, 3), device=dev) if record_hist else None
    for i in range(num_iters):
        with spans.span("iter"):
            it = start_iter + i
            with spans.span("draw"):
                slot = int(iter_slots[i])
                color = kf_colors_u8[slot].to(torch.float32).permute(2, 0, 1) / 255.0
                depth_gt = kf_depths[slot]
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            gm_i = gm._replace(**p, active=active)
            ps = None if structs is None else structs[int(iter_struct_idx[i])]
            dummy = (torch.zeros((gm.capacity, 2), device=dev, requires_grad=True)
                     if track_stats else None)
            loss, aux = get_loss(gm_i, iter_qs[i], iter_ts[i], color, depth_gt, cam, pcfg,
                                 False, True, ps, means2d_dummy=dummy, bands=bands,
                                 bin_opts=bin_opts)
            wrt = tuple(p.values()) + ((dummy,) if track_stats else ())
            with spans.span("backward"):
                grads = torch.autograd.grad(loss, wrt)
            if track_stats:
                # 3DGS densification statistics (utils/slam_external.py:100-104).
                grads, d_dummy = grads[:-1], grads[-1]
                gsvars = accumulate_stats(gsvars, d_dummy, aux.radii)
            if hist is not None:
                hist[i] = torch.stack([loss.detach(), aux.weighted_depth_loss,
                                       aux.weighted_im_loss])
            if prune_cfg.enabled:
                with spans.span("prune"):
                    active = _prune_mask(params["logit_opacities"], params["log_scales"],
                                         active, it, scene_radius, prune_cfg)
                    if (prune_cfg.reset_opacities and it > 0
                            and it % prune_cfg.reset_opacities_every == 0
                            and it <= prune_cfg.stop_after):
                        inv_sig = torch.log(torch.tensor(0.01 / 0.99))
                        params["logit_opacities"] = torch.full_like(
                            params["logit_opacities"], float(inv_sig))
                        st = optim.AdamState(m=tuple(torch.zeros_like(x) for x in st.m),
                                             v=tuple(torch.zeros_like(x) for x in st.v),
                                             step=st.step)
            with spans.span("adam"):
                new, st = optim.adam_step(st, tuple(params.values()), grads, plrs,
                                          eps=1e-15)
            params = dict(zip(keys, new))
    return gm._replace(**params, active=active), st, gsvars, hist


def accumulate_stats(gsvars: tuple, d_dummy, radii) -> tuple:
    """One iteration's 3DGS statistics (splatam_tpu/slam/steps.py:669-678):
    where radii > 0, add |d means2d_dummy| to the gradient accumulator and 1
    to denom, and keep the running max of the radii."""
    accum, denom, max_rad = gsvars
    seen = radii > 0
    return (accum + torch.where(seen, torch.linalg.vector_norm(d_dummy, dim=-1), 0.0),
            denom + seen.to(torch.float32),
            torch.maximum(max_rad, torch.where(seen, radii.to(torch.float32), 0.0)))


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
def densify_render(gm: GaussianMap, q, t, cam: Camera, bands: list | None = None,
                   bin_opts: BinOptions = api.CLASSIC) -> api.RenderOutput:
    """densify_step's render of the map's live span at pose (q, t); with
    `bands`, per band."""
    span = gm.span()
    view = GaussianMap(*(a[:span] for a in gm))
    means_cam, rots_cam = transform_to_frame(view, q, t, False, False)
    args = (means_cam, view.rgb_colors, rots_cam, view.logit_opacities, view.log_scales,
            view.active)
    return (api.render_rgbd_sil(cam, *args, bin_opts=bin_opts) if bands is None else
            spatial.render_rgbd_sil_sharded(bands, cam, *args, bin_opts=bin_opts))


def densify_candidates(out: api.RenderOutput, depth_gt, sil_thres: float) -> torch.Tensor:
    """[H, W] the pixels densification backprojects: valid depth where
    the render's silhouette is below sil_thres, or where it lies in front
    of the observed depth by more than 50 x the lower median depth error."""
    valid = depth_gt > 0
    depth_error = torch.abs(depth_gt - out.depth) * valid
    non_presence = (out.silhouette < sil_thres) | (
        (out.depth > depth_gt) & (depth_error > 50.0 * _median_lower(depth_error)))
    return non_presence & valid


@torch.no_grad()
def densify_step(gm: GaussianMap, timestep, color, depth_gt, q, t, time_idx: int,
                 cam: Camera, sil_thres: float, bands: list | None = None,
                 bin_opts: BinOptions = api.CLASSIC):
    """add_new_gaussians (scripts/splatam.py:378-420): backproject every
    pixel the map does not explain (densify_candidates of densify_render)
    into the lowest free slots; with `bands`, its render runs per band.

    Returns (gm, timestep, n_added, n_dropped); with n_dropped > 0 nothing
    is written and the caller grows the capacity and retries. Spans:
    `render`, `select` (the candidates and the free slots) and `write`."""
    with spans.span("render"):
        out = densify_render(gm, q, t, cam, bands, bin_opts)
    with spans.span("select"):
        chosen = densify_candidates(out, depth_gt, sil_thres).reshape(-1)
        with spans.waited("densify.candidates"):
            cand = torch.nonzero(chosen)[:, 0]
        with spans.waited("densify.free"):
            free = torch.nonzero(~gm.active)[:, 0]
    n_cand, n_free = cand.shape[0], free.shape[0]
    if n_cand > n_free:
        return gm, timestep, 0, n_cand - n_free

    with spans.span("write"):
        w2c = torch.eye(4, dtype=torch.float32, device=q.device)
        w2c[:3, :3] = build_rotation(normalize(q)[None])[0]
        w2c[:3, 3] = t
        with spans.waited("densify.inverse"):  # linalg.inv reads its error flag back
            c2w = torch.linalg.inv(w2c)
        pts, cols, mean_sq = backproject_pointcloud(
            color, depth_gt, cam.fx, cam.fy, cam.cx, cam.cy, c2w)
        dest = free[:n_cand]
        means3d, rgb = gm.means3d.clone(), gm.rgb_colors.clone()
        rots, logit = gm.unnorm_rotations.clone(), gm.logit_opacities.clone()
        log_scales, active = gm.log_scales.clone(), gm.active.clone()
        means3d[dest] = pts[cand]
        rgb[dest] = cols[cand]
        with spans.waited("densify.unit_quat"):
            rots[dest] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=q.device)
        logit[dest] = 0.0
        log_scales[dest] = 0.5 * torch.log(torch.clamp(mean_sq[cand], min=1e-12))[:, None]
        active[dest] = True
        timestep = timestep.clone()
        timestep[dest] = float(time_idx)
    return GaussianMap(means3d, rgb, rots, logit, log_scales, active), timestep, n_cand, 0


def densify_growing(gm: GaussianMap, timestep, color, depth_gt, q, t, time_idx: int,
                    cam: Camera, sil_thres: float, bands: list | None = None,
                    bin_opts: BinOptions = api.CLASSIC):
    """densify_step, the capacity doubled (grow_with_timestep) and the step
    retried until every candidate finds a free slot. Returns (gm,
    timestep)."""
    while True:
        gm2, ts2, _, n_dropped = densify_step(gm, timestep, color, depth_gt, q, t, time_idx,
                                              cam, sil_thres, bands, bin_opts)
        if n_dropped == 0:
            return gm2, ts2
        cap = gm.capacity
        while cap < gm.capacity + n_dropped:
            cap *= 2
        gm, timestep = grow_with_timestep(gm, timestep, cap)


@torch.no_grad()
def first_frame_pointcloud(color, depth_gt, cam: Camera):
    """Dense init cloud for frame 0: every valid-depth pixel becomes a
    Gaussian (initialize_first_timestep, scripts/splatam.py:169-211)."""
    c2w = torch.eye(4, dtype=torch.float32, device=color.device)
    pts, cols, mean_sq = backproject_pointcloud(
        color, depth_gt, cam.fx, cam.fy, cam.cx, cam.cy, c2w)
    return pts, cols, mean_sq, (depth_gt > 0).reshape(-1)
