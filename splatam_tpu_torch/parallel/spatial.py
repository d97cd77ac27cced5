"""Row-band rendering: the image split into bands of rows, one render per band.

Counterpart of splatam_tpu/parallel/spatial.py (`tpu.spatial_shards`). The
map is replicated; band k renders rows [k * h_local, (k + 1) * h_local) of
the image on its own device, with the camera's cy shifted by -k * h_local
and the frustum clamp of the full image. The band images come back to the
first band's device and are stacked along rows, so the loss math (masks,
the outlier median, SSIM's windows) runs once, on the full image, exactly
as without bands.

One process drives every band, as the JAX package's single controller
drives its mesh: there are no collectives. A replicated input reaches a
band's device through `.to(dev)`, and autograd does what shard_map's
transpose does there: each band's image cotangent is its own rows, and the
gradients of a replicated input are summed over the bands. (A
torch.distributed all_gather would not: every rank would compute the same
loss, and that gather's backward sums the cotangents over the ranks, so
every gradient would come out n times too large.)

On CUDA the bands go round-robin over the visible cards, starting at the
caller's; with one card they all run on it, one after another. Every
kernel wrapper launches on the card its inputs lie on (render/_cuda.py
launch), so a band's kernels run on the band's card. On the CPU all bands
run there (the kernels' plain versions).

What differs from the JAX module, which renders every shard at h_local rows
of an image padded to h_local * n and crops after the gather:
  * the last band stops at the image's last row, and a band that starts
    past it renders nothing (its structure is empty): a Gaussian that
    reaches only the padding rows gets no pairs and no radius there, so the
    radii and the 3DGS statistics are the full image's;
  * each band's binning keys depth on the full image's tile count
    (binning.build_bins full_wh), so its tiles list their pairs in the full
    image's order; the JAX shards key on their own, smaller grid, which
    keeps one or two more depth bits at 1200x680 and reorders pairs that
    the full key ties;
  * the port's pair buffers are exact, so there is no per-shard pair
    budget and no overflow to combine; a structure is a list of per-band
    PairStructures instead of one with a leading device axis.
"""
from __future__ import annotations

import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.render import api


def make_bands(n: int, device, cards: int | None = None) -> list:
    """The device of each of n bands: round-robin over `cards` of the
    visible cards (default: all of them) from `device`'s (the current card
    for a bare "cuda"), or `device` for every band on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    first = device.index if device.index is not None else torch.cuda.current_device()
    count = torch.cuda.device_count()
    cards = count if cards is None else max(1, min(cards, count))
    return [torch.device("cuda", (first + k % cards) % count) for k in range(n)]


def shard_heights(height: int, n_shards: int) -> tuple[int, int]:
    """(h_local, h_padded): rows per band (16-row tile aligned) and the
    padded render height h_local * n_shards >= height."""
    h_local = -(-height // n_shards)
    h_local = -(-h_local // 16) * 16
    return h_local, h_local * n_shards


def band_rows(height: int, n_bands: int) -> list:
    """The image rows each band renders: h_local, the last band cut at the
    image's last row, 0 for a band that would start past it."""
    h_local, _ = shard_heights(height, n_bands)
    return [max(0, min(h_local, height - k * h_local)) for k in range(n_bands)]


def _band_setup(bands: list, cam: Camera) -> list:
    """[(k, device, first row, band camera)] of the bands of a render
    through cam that hold rows of the image (band_rows)."""
    h_local, _ = shard_heights(cam.height, len(bands))
    return [(k, dev, k * h_local, cam._replace(height=rows))
            for k, (dev, rows) in enumerate(zip(bands, band_rows(cam.height, len(bands))))
            if rows > 0]


def _empty_structure(n: int, dev, world_rows=None, world_rows8=None) -> api.PairStructure:
    """The structure of a band with no rows: no pair, no tile."""
    i32 = dict(dtype=torch.int32, device=dev)
    empty = torch.zeros((0,), **i32)
    ps = api.PairStructure(empty, torch.zeros((1,), **i32), torch.zeros((n,), **i32),
                           torch.zeros((n,), **i32), empty, 0)
    if world_rows8 is not None:
        ps = ps._replace(world8=torch.zeros((0, world_rows8.shape[1]), device=dev))
    elif world_rows is not None:
        ps = ps._replace(world16=torch.zeros((0, world_rows.shape[1]), device=dev))
    return ps


def check_structs(bands: list, structs) -> None:
    """A banded render takes the per-band structures that
    compute_pair_structure_sharded built for as many bands, never one
    full-image structure."""
    if not isinstance(structs, (list, tuple)) or len(structs) != len(bands):
        raise ValueError(f"expected {len(bands)} per-band pair structures "
                         "(compute_pair_structure_sharded), got "
                         f"{type(structs).__name__}")


def _band_geometry(cam: Camera, row0: int) -> dict:
    """The render API's band arguments: cy shifted by the band's first row,
    the full image's frustum clamp."""
    return dict(intrinsics_override=(cam.fx, cam.fy, cam.cx, cam.cy - row0),
                lim_wh=(cam.width, cam.height))


def _gathered(outs: list, bands: list, radii=None) -> api.RenderOutput:
    """The bands' RenderOutputs [.., h_band, W] as one [.., H, W] on the
    first band's device, pair counts summed; radii as given (None: the
    first band's, all zero for the structure-reusing renders)."""
    def rows(field: str, dim: int) -> torch.Tensor:
        return torch.cat([getattr(o, field).to(bands[0]) for o in outs], dim=dim)

    return api.RenderOutput(im=rows("im", 1), depth=rows("depth", 0),
                            silhouette=rows("silhouette", 0), depth_sq=rows("depth_sq", 0),
                            radii=outs[0].radii.to(bands[0]) if radii is None else radii,
                            n_pairs=sum(o.n_pairs for o in outs))


def compute_pair_structure_sharded(bands: list, cam: Camera, means_cam, rots_cam,
                                   logit_opacities, log_scales, active, world_rows=None,
                                   world_rows8=None, bin_opts=api.CLASSIC) -> list:
    """render.api.compute_pair_structure per band: each band expands, sorts
    and lays out only the (Gaussian, tile) pairs of its own rows (its
    shifted camera culls the rest at the tile rectangles), so binning work
    splits over the bands; a Gaussian across a band boundary has pairs in
    both bands. world_rows / world_rows8 and bin_opts as
    compute_pair_structure takes them (each band gathers its own pairs'
    rows). Returns the list of the bands' PairStructures."""
    n = means_cam.shape[0]
    structs = [_empty_structure(n, dev, world_rows, world_rows8) for dev in bands]
    for k, dev, row0, cam_k in _band_setup(bands, cam):
        structs[k] = api.compute_pair_structure(
            cam_k, means_cam.to(dev), rots_cam.to(dev), logit_opacities.to(dev),
            log_scales.to(dev), active.to(dev), **_band_geometry(cam, row0),
            world_rows=None if world_rows is None else world_rows.to(dev),
            world_rows8=None if world_rows8 is None else world_rows8.to(dev),
            bin_opts=bin_opts)
    return structs


def render_rgbd_sil_pairspace_sharded(bands: list, cam: Camera, structs, q, t
                                      ) -> api.RenderOutput:
    """render.api.render_rgbd_sil_pairspace per band, each projecting its
    own world8 (the fused kernels, the shift riding their pose vector) or
    world16 rows at pose (q, t) against its rows; gradients reach (q, t)
    summed over the bands. Radii are all zero, as on one device."""
    check_structs(bands, structs)
    return _gathered([api.render_rgbd_sil_pairspace(cam_k, structs[k], q.to(dev), t.to(dev),
                                                    **_band_geometry(cam, row0))
                      for k, dev, row0, cam_k in _band_setup(bands, cam)], bands)


def render_rgbd_sil_mapping_fused_sharded(bands: list, cam: Camera, structs, means3d,
                                          rgb_colors, logit_opacities, log_scales, active, q,
                                          t) -> api.RenderOutput:
    """render.api.render_rgbd_sil_mapping_fused per band: the fused kernels
    on each band's structure; the Gaussian parameters are replicated, so
    their world-space gradients are summed over the bands. Radii are all
    zero, as on one device."""
    check_structs(bands, structs)
    return _gathered([api.render_rgbd_sil_mapping_fused(
        cam_k, structs[k], means3d.to(dev), rgb_colors.to(dev), logit_opacities.to(dev),
        log_scales.to(dev), active.to(dev), q.to(dev), t.to(dev), **_band_geometry(cam, row0))
        for k, dev, row0, cam_k in _band_setup(bands, cam)], bands)


def render_rgbd_sil_sharded(bands: list, cam: Camera, means_cam, colors, rots_cam,
                            logit_opacities, log_scales, active, means2d_dummy=None,
                            pair_structure=None, bin_opts=api.CLASSIC) -> api.RenderOutput:
    """Banded drop-in for render.api.render_rgbd_sil (the generic render,
    K1 -> K2 -> K3 per band): the image is the full render's up to the
    rounding of each band's NDC terms (pixel math never crosses a band
    boundary; a Gaussian across one composites in both bands onto disjoint
    pixels). radii are the elementwise max over the bands (each culls
    against its own tiles), n_pairs the sum.

    means2d_dummy's y column is scaled by h_full / h_band before the
    render adds it at the band's [W/2, h_band/2], so its gradient keeps
    the reference's full-image NDC scale (the 3DGS statistics).
    pair_structure reuses compute_pair_structure_sharded's list; bin_opts
    as render_rgbd_sil takes it."""
    if pair_structure is not None:
        check_structs(bands, pair_structure)
    outs = []
    for k, dev, row0, cam_k in _band_setup(bands, cam):
        dummy = None
        if means2d_dummy is not None:
            dummy = means2d_dummy.to(dev) * torch.tensor(
                [1.0, cam.height / cam_k.height], dtype=torch.float32, device=dev)
        outs.append(api.render_rgbd_sil(
            cam_k, means_cam.to(dev), colors.to(dev), rots_cam.to(dev),
            logit_opacities.to(dev), log_scales.to(dev), active.to(dev),
            pair_structure=None if pair_structure is None else pair_structure[k],
            means2d_dummy=dummy, bin_opts=bin_opts, **_band_geometry(cam, row0)))
    radii = torch.stack([o.radii.to(bands[0]) for o in outs]).amax(0)
    return _gathered(outs, bands, radii)
