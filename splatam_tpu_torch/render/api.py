"""Public render API: RGB + depth + silhouette + depth^2 in one pass, and
the generic render of any channels.

Counterpart of splatam_tpu/render/api.py: one pass composites r, g, b, z,
z^2 and emits the silhouette from the transmittance (silhouette =
1 - T_final). Four renders: the generic differentiable one of any
channels (render_gaussians; render_rgbd_sil is its r, g, b case:
the projection kernels, K1 -> K2 -> K3), the pair-space tracking render
(per-pair rows, gradients to the pose) and the fused isotropic mapping
render. The reference's RenderConfig has no counterpart: its pair-buffer
sizes have none (the port sizes buffers exactly, so nothing overflows),
its backend is the `backend` argument of the generic render, and its
binning variants (tile_cull, direct_j) the `bin_opts` argument
(binning.BinOptions) of every render that bins and of
compute_pair_structure.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.transforms import normalize
from splatam_tpu_torch.render import binning as binning_mod
from splatam_tpu_torch.render import composite, composite_tiles, fused_iso, naive, pairspace
from splatam_tpu_torch.render import projection as projection_mod
from splatam_tpu_torch.render.binning import BinOptions
from splatam_tpu_torch.utils import spans

CLASSIC = BinOptions()

# The generic render's backends: the kernels (K1 -> K2 -> K3 on the card,
# their plain versions on the CPU; "pallas" is the JAX package's name for
# them, as a config may say) and the two references, on either device.
KERNEL_BACKENDS = ("auto", "pallas")
BACKENDS = (*KERNEL_BACKENDS, "naive", "tiles")


class RenderOutput(NamedTuple):
    im: torch.Tensor  # [3, H, W] rgb
    depth: torch.Tensor  # [H, W] composited z
    silhouette: torch.Tensor  # [H, W] accumulated opacity
    depth_sq: torch.Tensor  # [H, W] composited z^2
    radii: torch.Tensor  # [N] int32 screen radius of this call's projection (0 = culled)
    n_pairs: int  # (gaussian, tile) pairs binned


class PairStructure(NamedTuple):
    """The geometry-only binning of one render, reusable across iterations
    whose geometry drifts slowly (render.binning.Bins plus, for tracking,
    the world rows gathered per sorted pair: world-8 for an isotropic map,
    world-16 otherwise). Per-pair alpha is always evaluated from the
    current iteration's projection; a stale structure only misses pairs
    the 1/255 cutoff would mostly skip anyway."""

    pair_gauss: torch.Tensor
    tile_start: torch.Tensor
    offsets: torch.Tensor
    counts: torch.Tensor
    dst: torch.Tensor
    n_pairs: int
    world8: torch.Tensor | None = None  # [P, 8] tracking an isotropic map
    world16: torch.Tensor | None = None  # [P, 13] tracking an anisotropic map
    n_culled: int = 0  # pairs the tile cull dropped (binning.Bins)


def _prep_gaussians(unnorm_rotations, logit_opacities, log_scales):
    if log_scales.shape[1] == 1:
        log_scales = log_scales.expand(-1, 3)
    return normalize(unnorm_rotations), logit_opacities.reshape(-1), torch.exp(log_scales)


def project_gaussians(cam: Camera, means3d, unnorm_rotations, logit_opacities, log_scales,
                      active, intrinsics_override=None, lim_wh=None):
    """EWA-project a map's Gaussians through cam (render.projection.project).
    intrinsics_override (fx, fy, cx, cy) replaces cam's intrinsics (the
    image size stays cam's), and lim_wh the (width, height) of the
    frustum clamp: the projection of one band of a larger image (its
    binning also takes the depth key of that image's tile grid).

    CUDA tensors take the projection kernels (projection.ProjectGauss: the
    camera passed by value, gradients in closed form to whichever leaves
    ask for them), CPU tensors `project` through autograd."""
    fx, fy, cx, cy = (intrinsics_override if intrinsics_override is not None
                      else (cam.fx, cam.fy, cam.cx, cam.cy))
    if means3d.is_cuda:
        consts = projection_mod.project_consts(cam.w2c, fx, fy, cx, cy, cam.width, cam.height,
                                               lim_wh)
        return projection_mod.project_gauss(means3d, unnorm_rotations, logit_opacities,
                                            log_scales, active, consts)
    quats, logit_op, scales = _prep_gaussians(unnorm_rotations, logit_opacities, log_scales)
    return projection_mod.project(
        means3d, quats, logit_op, scales, active, cam.w2c_tensor(means3d.device),
        fx, fy, cx, cy, cam.width, cam.height, lim_wh=lim_wh,
    )


@torch.no_grad()
def compute_pair_structure(cam: Camera, means3d, unnorm_rotations, logit_opacities,
                           log_scales, active, intrinsics_override=None, lim_wh=None,
                           world_rows=None, world_rows8=None,
                           bin_opts: BinOptions = CLASSIC) -> PairStructure:
    """Binning structure for a render at this geometry (inputs are
    constants); intrinsics_override and lim_wh as project_gaussians takes
    them (one band's structure, parallel/spatial.py), bin_opts the binning
    variants.

    world_rows [N, 13] (pairspace.pack_world_rows) also gathers the
    structure's world16 per sorted pair for the pair-space tracking render
    of an anisotropic map, world_rows8 [N, 8] (fused_iso.pack_world8) its
    world8 for the fused one of an isotropic map; at most one of the two.
    The span `build` (utils/spans.py)."""
    if world_rows is not None and world_rows8 is not None:
        raise ValueError("world_rows and world_rows8 exclude each other: a structure carries "
                         "world-16 rows (anisotropic map) or world-8 rows (isotropic map)")
    with spans.span("build"):
        proj, aux = project_gaussians(cam, means3d, unnorm_rotations, logit_opacities,
                                      log_scales, active, intrinsics_override, lim_wh)
        ps = _bins(proj, aux, cam, lim_wh, bin_opts)
        if world_rows8 is not None:
            ps = ps._replace(world8=torch.index_select(world_rows8, 0, ps.pair_gauss))
        elif world_rows is not None:
            ps = ps._replace(world16=torch.index_select(world_rows, 0, ps.pair_gauss))
    return ps


def _public(img, radii, n_pairs) -> RenderOutput:
    """Rows [r, g, b, z, z^2, sil, ...] -> RenderOutput."""
    return RenderOutput(im=img[:3], depth=img[3], silhouette=img[5], depth_sq=img[4],
                        radii=radii, n_pairs=n_pairs)


def _no_radii(ps: PairStructure) -> torch.Tensor:
    """All-zero radii, one per Gaussian of the structure: the renders that
    project per pair never form per-Gaussian screen radii, so they return
    none, as the reference package's do by contract (a densification
    statistic fed from them would see every Gaussian as unseen; get_loss
    routes a statistics harvest to the generic render)."""
    return torch.zeros(ps.counts.shape, dtype=torch.int32, device=ps.counts.device)


def _bins(proj, aux, cam: Camera, lim_wh=None, bin_opts: BinOptions = CLASSIC
          ) -> PairStructure:
    """The binning of a projection through cam; lim_wh (a band's full
    image) also sets the depth key's bits (binning.build_bins full_wh)."""
    with torch.no_grad():
        b = binning_mod.build_bins(proj, aux, cam.width, cam.height, far=cam.far,
                                   full_wh=lim_wh, tile_cull=bin_opts.tile_cull,
                                   direct_j=bin_opts.direct_j)
    return PairStructure(b.pair_gauss, b.tile_start, b.offsets, b.counts, b.dst, b.n_pairs,
                         n_culled=b.n_culled)


def _build(proj, aux, cam: Camera, lim_wh, bin_opts: BinOptions) -> PairStructure:
    """The generic render's own binning, as the span `build`."""
    with spans.span("build"):
        return _bins(proj, aux, cam, lim_wh, bin_opts)


def _render(cam: Camera, means3d, colors, unnorm_rotations, logit_opacities, log_scales, active,
            backend, means2d_dummy, append_depth, intrinsics_override, lim_wh, pair_structure,
            bin_opts):
    """The backend's own rows, radii and pair count. The kernels' rows are
    [colors..., (z, z^2,) sil] (the silhouette from the transmittance), the
    references' [colors..., (z, 1, z^2)] (the silhouette a composited
    constant 1). The projection is the span `project`, the binning `build`."""
    if backend not in BACKENDS:
        raise ValueError(f"backend: one of {BACKENDS}, got {backend!r}")
    with spans.span("project"):
        proj, aux = project_gaussians(cam, means3d, unnorm_rotations, logit_opacities,
                                      log_scales, active, intrinsics_override, lim_wh)
    opacity = proj.opacity
    if pair_structure is not None:
        opacity = torch.where(active, opacity, 0.0)
    xy = proj.xy
    if means2d_dummy is not None:
        xy = xy + torch.stack((means2d_dummy[:, 0] * (cam.width * 0.5),
                               means2d_dummy[:, 1] * (cam.height * 0.5)), dim=-1)
    kernels = backend in KERNEL_BACKENDS
    chans = colors
    if append_depth:
        depth = proj.depth[:, None]
        extra = [depth, depth * depth] if kernels else [depth, torch.ones_like(depth),
                                                        depth * depth]
        chans = torch.cat([colors, *extra], dim=1)
    if kernels:
        composite.check_channels(chans.shape[1])
        ps = pair_structure or _build(proj, aux, cam, lim_wh, bin_opts)
        img = composite.CompositeGauss.apply(xy, proj.conic, opacity, chans, ps,
                                             cam.width, cam.height)
        return img, aux.radius, ps.n_pairs
    if backend == "naive":
        img = naive.composite_naive(proj._replace(xy=xy, opacity=opacity), aux, chans,
                                    cam.width, cam.height)
        return img, aux.radius, 0
    ps = pair_structure or _build(proj, aux, cam, lim_wh, bin_opts)
    lists, lens = composite_tiles.tile_lists(ps.pair_gauss, ps.tile_start)
    px, py = (torch.from_numpy(a).to(xy.device)
              for a in composite_tiles.tile_pixel_coords(cam.width, cam.height))
    acc = composite_tiles.composite_tiles(xy, proj.conic, opacity, chans, lists, lens, px, py)
    return composite.assemble_image(acc, cam.width, cam.height), aux.radius, ps.n_pairs


def render_gaussians(cam: Camera, means3d, colors, unnorm_rotations, logit_opacities,
                     log_scales, active, backend: str = "auto", means2d_dummy=None,
                     append_depth_channels: bool = True, intrinsics_override=None,
                     lim_wh=None, pair_structure: PairStructure | None = None,
                     bin_opts: BinOptions = CLASSIC):
    """Differentiable render of any per-Gaussian channels colors [N, C].

    Returns (img, radii [N] int32, n_pairs). img is [C + 3, H, W], the rows
    [colors..., z, sil, z^2], with `append_depth_channels`; [C, H, W]
    without. Every pair buffer is sized exactly, so nothing overflows and
    there is no overflow scalar (the JAX function's third output).

    backend: "auto" (or "pallas") composites with the kernels K1 -> K2 ->
    K3 on the card and their plain versions on the CPU; they take 1 to 10
    channels (C + 2 with depth appended, C without), as the TPU kernels do,
    and raise a ValueError past that. "naive" (render/naive.py, n_pairs 0)
    and "tiles" (render/composite_tiles.py) are the references, on either
    device and at any C.

    means3d are in the frame cam.w2c maps from. intrinsics_override (fx,
    fy, cx, cy) replaces cam's intrinsics (the image size stays cam's), and
    lim_wh the (width, height) of the projection's frustum clamp
    (render.projection.project) and of the tile grid that sets the depth
    key (binning.build_bins full_wh): a render of one band of a larger
    image.
    pair_structure reuses an earlier binning as render_rgbd_sil does;
    means2d_dummy harvests the screen-space gradient as there. bin_opts
    selects the binning variants of a render that bins."""
    img, radii, n_pairs = _render(cam, means3d, colors, unnorm_rotations, logit_opacities,
                                  log_scales, active, backend, means2d_dummy,
                                  append_depth_channels, intrinsics_override, lim_wh,
                                  pair_structure, bin_opts)
    nu = colors.shape[1]
    if backend in KERNEL_BACKENDS:
        # kernel rows [colors..., z, z^2, sil] -> [colors..., z, sil, z^2];
        # without depth the silhouette row is dropped
        img = (torch.cat([img[:nu + 1], img[nu + 2:nu + 3], img[nu + 1:nu + 2]])
               if append_depth_channels else img[:nu])
    return img, radii, n_pairs


def render_rgbd_sil(cam: Camera, means3d, rgb_colors, unnorm_rotations, logit_opacities,
                    log_scales, active, pair_structure: PairStructure | None = None,
                    means2d_dummy=None, backend: str = "auto", intrinsics_override=None,
                    lim_wh=None, bin_opts: BinOptions = CLASSIC) -> RenderOutput:
    """Generic differentiable render of r, g, b, z, z^2 and the
    silhouette: project (project_gaussians: the projection kernels on the
    card, plain PyTorch on the CPU; gradients to every input), bin under
    no_grad, composite with K1 forward and K2 -> K3 backward
    (composite.CompositeGauss); `backend` as render_gaussians takes it.

    means3d are in the frame cam.w2c maps from. `pair_structure` reuses an
    earlier binning; per-pair alpha still comes from this call's
    projection, and Gaussians inactive since the structure was built
    composite with opacity 0 (so every pair keeps its list position).

    means2d_dummy [N, 2] (zeros that require grad) is added to the projected
    centres scaled by [W/2, H/2], so its gradient is K3's per-Gaussian sum
    of K2's xy gradients in the reference's NDC half-extents: the 3DGS
    densification statistic (splatam_tpu/render/api.py:313-319;
    utils/slam_external.py:100-104). radii come from this call's
    projection. intrinsics_override, lim_wh and bin_opts as render_gaussians
    takes them."""
    img, radii, n_pairs = _render(cam, means3d, rgb_colors, unnorm_rotations, logit_opacities,
                                  log_scales, active, backend, means2d_dummy, True,
                                  intrinsics_override, lim_wh, pair_structure, bin_opts)
    if backend in KERNEL_BACKENDS:
        return _public(img, radii, n_pairs)
    return RenderOutput(im=img[:3], depth=img[3], silhouette=img[4], depth_sq=img[5],
                        radii=radii, n_pairs=n_pairs)


def render_rgbd_sil_pairspace(cam: Camera, ps: PairStructure, q, t, intrinsics_override=None,
                              lim_wh=None) -> RenderOutput:
    """Tracking render at pose (q, t) from the structure's per-pair world
    rows; gradients flow to (q, t) only. World-8 rows (isotropic map): the
    fused kernels project in-kernel. World-16 rows: project_pairs in
    PyTorch, K1 and K2 on per-pair rows (composite.CompositePairs).
    intrinsics_override and lim_wh as render_gaussians takes them."""
    fx, fy, cx, cy = (intrinsics_override if intrinsics_override is not None
                      else (cam.fx, cam.fy, cam.cx, cam.cy))
    if ps.world8 is not None:
        img = fused_iso.composite_fused_pairs(ps.world8, ps, cam, q, t, intrinsics_override,
                                              lim_wh)
    else:
        rows = pairspace.project_pairs(ps.world16, q, t, fx, fy, cx, cy, cam.width, cam.height,
                                       lim_wh=lim_wh)
        img = composite.CompositePairs.apply(rows, ps.tile_start, cam.width, cam.height)
    return _public(img, _no_radii(ps), ps.n_pairs)


def render_rgbd_sil_mapping_fused(cam: Camera, ps: PairStructure, means3d, rgb_colors,
                                  logit_opacities, log_scales, active, q, t,
                                  intrinsics_override=None, lim_wh=None) -> RenderOutput:
    """Mapping render (isotropic map): gradients flow to every Gaussian
    parameter through K5 and K3; the pose is a constant. Its radii are all
    zero (see _no_radii). intrinsics_override and lim_wh as
    render_gaussians takes them."""
    img = fused_iso.composite_fused_gauss(
        means3d, logit_opacities, log_scales, rgb_colors, active, ps, cam, q, t,
        intrinsics_override, lim_wh)
    return _public(img, _no_radii(ps), ps.n_pairs)
