"""Public render API: RGB + depth + silhouette + depth^2 in one pass.

Counterpart of splatam_tpu/render/api.py for the slice the SLAM loop
runs: one fused pass composites r, g, b, z, z^2 and emits the silhouette
from the transmittance (silhouette = 1 - T_final). The reference's
RenderConfig has no counterpart: each of its fields sizes a pair buffer
or picks a backend, and the port sizes buffers exactly and has one
backend per device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.transforms import normalize
from splatam_tpu_torch.render import binning as binning_mod
from splatam_tpu_torch.render import composite, fused_iso
from splatam_tpu_torch.render import projection as projection_mod


class RenderOutput(NamedTuple):
    im: torch.Tensor  # [3, H, W] rgb
    depth: torch.Tensor  # [H, W] composited z
    silhouette: torch.Tensor  # [H, W] accumulated opacity
    depth_sq: torch.Tensor  # [H, W] composited z^2
    n_pairs: int  # (gaussian, tile) pairs binned


class PairStructure(NamedTuple):
    """The geometry-only binning of one render, reusable across iterations
    whose geometry drifts slowly (render.binning.Bins plus, for tracking,
    the world-8 rows gathered per sorted pair). Per-pair alpha is always
    evaluated from the current iteration's projection; a stale structure
    only misses pairs the 1/255 cutoff would mostly skip anyway."""

    pair_gauss: torch.Tensor
    tile_start: torch.Tensor
    offsets: torch.Tensor
    counts: torch.Tensor
    dst: torch.Tensor
    n_pairs: int
    world8: torch.Tensor | None = None  # [P, 8] tracking only


def _prep_gaussians(unnorm_rotations, logit_opacities, log_scales):
    if log_scales.shape[1] == 1:
        log_scales = log_scales.expand(-1, 3)
    return normalize(unnorm_rotations), logit_opacities.reshape(-1), torch.exp(log_scales)


def project_gaussians(cam: Camera, means3d, unnorm_rotations, logit_opacities, log_scales,
                      active):
    """EWA-project a map's Gaussians through cam (render.projection.project)."""
    quats, logit_op, scales = _prep_gaussians(unnorm_rotations, logit_opacities, log_scales)
    return projection_mod.project(
        means3d, quats, logit_op, scales, active, cam.w2c_tensor(means3d.device),
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
    )


@torch.no_grad()
def compute_pair_structure(cam: Camera, means3d, unnorm_rotations, logit_opacities,
                           log_scales, active) -> PairStructure:
    """Binning structure for a render at this geometry (inputs are
    constants)."""
    proj, aux = project_gaussians(cam, means3d, unnorm_rotations, logit_opacities,
                                  log_scales, active)
    b = binning_mod.build_bins(proj, aux, cam.width, cam.height, far=cam.far)
    return PairStructure(b.pair_gauss, b.tile_start, b.offsets, b.counts, b.dst, b.n_pairs)


def _public(img, n_pairs) -> RenderOutput:
    """Rows [r, g, b, z, z^2, sil, ...] -> RenderOutput."""
    return RenderOutput(im=img[:3], depth=img[3], silhouette=img[5], depth_sq=img[4],
                        n_pairs=n_pairs)


def render_rgbd_sil(cam: Camera, means3d, rgb_colors, unnorm_rotations, logit_opacities,
                    log_scales, active) -> RenderOutput:
    """Generic render (forward only): project, bin, composite with K1.

    A gradient through this render needs the composite-backward kernel,
    which is not ported yet (ROADMAP, TPU kernel list item 5)."""
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (means3d, rgb_colors, unnorm_rotations,
                                  logit_opacities, log_scales)
    ):
        raise NotImplementedError(
            "gradients through the generic render need the composite-backward "
            "kernel (ROADMAP, TPU kernel list item 5)"
        )
    with torch.no_grad():
        proj, aux = project_gaussians(cam, means3d, unnorm_rotations, logit_opacities,
                                      log_scales, active)
        b = binning_mod.build_bins(proj, aux, cam.width, cam.height, far=cam.far)
        depth = proj.depth[:, None]
        attrs = torch.cat(
            [proj.xy, proj.conic, proj.opacity[:, None], rgb_colors, depth, depth * depth],
            dim=1,
        ).contiguous()
        img = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, cam.width,
                                          cam.height)
    return _public(img, b.n_pairs)


def render_rgbd_sil_pairspace(cam: Camera, ps: PairStructure, q, t) -> RenderOutput:
    """Tracking render: the fused kernels project ps.world8 at pose (q, t);
    gradients flow to (q, t)."""
    if ps.world8 is None:
        raise NotImplementedError(
            "pair-space tracking of an anisotropic map (world16 rows) needs the "
            "composite-backward kernel (ROADMAP, TPU kernel list item 5)"
        )
    return _public(fused_iso.composite_fused_pairs(ps.world8, ps, cam, q, t), ps.n_pairs)


def render_rgbd_sil_mapping_fused(cam: Camera, ps: PairStructure, means3d, rgb_colors,
                                  logit_opacities, log_scales, active, q, t) -> RenderOutput:
    """Mapping render (isotropic map): gradients flow to every Gaussian
    parameter through K5 and K3; the pose is a constant."""
    img = fused_iso.composite_fused_gauss(
        means3d, logit_opacities, log_scales, rgb_colors, active, ps, cam, q, t)
    return _public(img, ps.n_pairs)
