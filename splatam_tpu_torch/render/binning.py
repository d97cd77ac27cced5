"""Tile binning: (gaussian, tile) pair expansion and one stable key sort.

Counterpart of splatam_tpu/render/binning.py `build_bins`. Each visible
Gaussian expands into one pair per tile of its rectangle; the pairs are
sorted by a (tile, log-quantized depth) key, and ties keep the expansion
order (Gaussian index, then row-major tile), so the pair order inside
every tile is the reference package's.

What differs from the reference, because this runs on a GPU:
  * the key is int64 with the tile id in the high bits, so no offset has
    to be packed into 23 bits and there is no pair_cap limit;
  * pair buffers are sized to the exact pair count, read back with one
    host sync per structure build (renderCUDA does the same; the `waited`
    site bins.total), so nothing overflows and nothing is retried;
  * the per-tile layout is the sorted stream itself (tile t owns pairs
    tile_start[t] .. tile_start[t+1]); no padding to 128-lane chunks.

Both of the reference's binning variants (tpu.tile_cull, tpu.direct_j) are
here, with exact buffers (build_bins). With the cull, the culled slots
leave the expansion before the sort: offsets, counts and dst then describe
the kept slots, and n_pairs counts them.

On the card (without the cull) the per-pair work is two hand-written
kernels over 32-bit keys (csrc/binning.cu): bins_expand writes each slot's
key, a stable torch.sort orders them, bins_scatter writes pair_gauss, dst
and tile_start (build_bins_keyed). build_bins_plain is the same function in
PyTorch's ops over int64 keys, which the CPU and the cull take. Both give
the same Bins bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from splatam_tpu_torch.render import _cuda
from splatam_tpu_torch.render.projection import NEAR_CLIP, TILE, Projected, ProjectedAux
from splatam_tpu_torch.utils import spans

# The 32-bit key is stored as an int32 with its top bit flipped (key - 2**31),
# so the int32 order is the key's unsigned order (csrc/binning.cu KEY_FLIP).
KEY_FLIP = 1 << 31


class Bins(NamedTuple):
    pair_gauss: torch.Tensor  # [P] int32 gaussian index per sorted pair
    tile_start: torch.Tensor  # [T + 1] int32 segment starts in the sorted stream
    offsets: torch.Tensor  # [N] int32 first expansion slot of each gaussian
    counts: torch.Tensor  # [N] int32 pairs per gaussian (0 = invisible)
    dst: torch.Tensor  # [P] int32 sorted position of each expansion slot
    n_pairs: int  # pairs in the stream (kept pairs under the cull)
    n_culled: int = 0  # pairs the tile cull dropped


class BinOptions(NamedTuple):
    """The binning variants a config selects (the reference's
    RenderConfig.tile_cull and .direct_j; config keys tpu.tile_cull and
    tpu.direct_j)."""

    tile_cull: bool = False
    direct_j: int = 0

    @classmethod
    def from_config(cls, tpu: dict, banded: bool = False) -> "BinOptions":
        """The config's tpu section; direct_j is 0 with bands, as in the
        reference runtime (splatam_tpu/slam/pipeline.py:600)."""
        return cls(tile_cull=bool(tpu.get("tile_cull", False)),
                   direct_j=0 if banded else int(tpu.get("direct_j", 0)))


def grid_shape(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def depth_bits_for(num_tiles: int) -> int:
    """Depth-quantization bits; the same as the reference's, so that the
    quantized depth, and with it the tie order, is the same."""
    tile_bits = max(1, math.ceil(math.log2(num_tiles + 2)))
    bits = 31 - tile_bits
    if bits < 12:
        raise ValueError(f"image too large: {num_tiles} tiles leaves {bits} depth bits")
    return min(bits, 22)


def quantized_depth(depth: torch.Tensor, bits: int, far: float = 100.0) -> torch.Tensor:
    """The depth key of a pair within its tile: log(z) between NEAR_CLIP and
    far on `bits` bits (int64). Pairs of one tile composite in this key's
    order, ties in Gaussian index order."""
    qmax = (1 << bits) - 1
    z = torch.clamp(depth, NEAR_CLIP, far)
    log_span = math.log(far / NEAR_CLIP)
    return torch.clamp((torch.log(z / NEAR_CLIP) / log_span * qmax).to(torch.int64), 0, qmax)


def _box_min_quad(xlo, xhi, ylo, yhi, a, b, c):
    """min over the box [xlo, xhi] x [ylo, yhi] of q(d) = a dx^2 + 2b dx dy +
    c dy^2 (splatam_tpu/render/binning.py:75-98): 0 when the box holds the
    origin, else the least of the four edges' clamped 1D minima."""
    c_s = torch.clamp(c, min=1e-12)
    a_s = torch.clamp(a, min=1e-12)

    def edge_x(x0):
        ys = torch.minimum(torch.maximum(-b * x0 / c_s, ylo), yhi)
        return a * x0 * x0 + 2.0 * b * x0 * ys + c * ys * ys

    def edge_y(y0):
        xs = torch.minimum(torch.maximum(-b * y0 / a_s, xlo), xhi)
        return a * xs * xs + 2.0 * b * xs * y0 + c * y0 * y0

    m = torch.minimum(torch.minimum(edge_x(xlo), edge_x(xhi)),
                      torch.minimum(edge_y(ylo), edge_y(yhi)))
    inside = (xlo <= 0.0) & (xhi >= 0.0) & (ylo <= 0.0) & (yhi >= 0.0)
    return torch.where(inside, torch.zeros_like(m), m)


def cull_cut(opacity: torch.Tensor) -> torch.Tensor:
    """The Mahalanobis-squared cutoff (splatam_tpu/render/binning.py:101-105):
    alpha = op exp(-q / 2) < 1/255 iff q > 2 ln(255 op)."""
    return torch.clamp(2.0 * torch.log(255.0 * torch.clamp(opacity, min=1e-12)), min=0.0)


def tile_culled(tx, ty, px, py, a, b, c, cut):
    """True for the (gaussian, tile) pairs whose least alpha over the tile's
    16x16 pixel box is below 1/255 (splatam_tpu/render/binning.py:108-116):
    every pixel of such a pair is skipped in-kernel. The 1e-4 slack keeps
    borderline pairs."""
    xlo = tx.to(torch.float32) * TILE - px
    ylo = ty.to(torch.float32) * TILE - py
    m = _box_min_quad(xlo, xlo + (TILE - 1.0), ylo, ylo + (TILE - 1.0), a, b, c)
    return m > cut + 1e-4


def _key_grid(width: int, height: int, full_wh: tuple | None) -> tuple[int, int, int]:
    """(grid_x, num_tiles, depth bits) of a build: the image's tile grid,
    and the depth key's bits from the full image's (full_wh) tile count."""
    grid_x, grid_y = grid_shape(width, height)
    key_x, key_y = grid_shape(*full_wh) if full_wh is not None else (grid_x, grid_y)
    return grid_x, grid_x * grid_y, depth_bits_for(key_x * key_y)


def _pair_counts(aux: ProjectedAux) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(counts, offsets, total): each Gaussian's pairs (its rectangle's area
    where visible, else 0), its first expansion slot (int64) and the pair
    count, read back to size the pair buffers exactly."""
    rect_w = aux.rect_wh[:, 0]
    counts = torch.where(aux.visible, rect_w * aux.rect_wh[:, 1], torch.zeros_like(rect_w))
    offsets = torch.cumsum(counts, 0) - counts
    with spans.waited("bins.total"):  # the pair count that sizes the buffers
        total = int(counts.sum())
    return counts, offsets, total


def build_bins(proj: Projected, aux: ProjectedAux, width: int, height: int,
               far: float = 100.0, full_wh: tuple | None = None, tile_cull: bool = False,
               direct_j: int = 0) -> Bins:
    """Expand (gaussian, tile) pairs and sort them by (tile, depth) key
    (build_bins_plain says how). On CUDA tensors without tile_cull through
    the kernels of build_bins_keyed, else build_bins_plain: the same Bins
    bit for bit. Counts the build in build_bins.totals."""
    if proj.depth.is_cuda and not tile_cull:
        b = build_bins_keyed(proj, aux, width, height, far, full_wh, direct_j)
    else:
        b = build_bins_plain(proj, aux, width, height, far, full_wh, tile_cull, direct_j)
    totals = build_bins.totals
    totals["builds"] += 1
    totals["pairs"] += b.n_pairs
    totals["culled"] += b.n_culled
    return b


def build_bins_plain(proj: Projected, aux: ProjectedAux, width: int, height: int,
                     far: float = 100.0, full_wh: tuple | None = None, tile_cull: bool = False,
                     direct_j: int = 0) -> Bins:
    """Expand (gaussian, tile) pairs and sort them by (tile, depth) key, in
    PyTorch's ops over int64 keys.

    full_wh: the (width, height) of the image this one is a band of. Its
    tile count, not the band's, sets the depth key's bits, so a band's
    pairs composite in the full image's order: with the band's own (fewer)
    tiles the key would keep one more depth bit and could part pairs that
    the full image's key ties (and then orders by Gaussian index).

    tile_cull drops the pairs tile_culled names, except each Gaussian's
    first (j == 0), so counts > 0 exactly where it is without the cull.
    The kept slots, in expansion order, are the stream: offsets, counts
    and dst describe them (the reference keeps counts as the rect area and
    sentinel keys for the culled slots; nothing here reads the area). The
    kept count takes a second host sync.

    direct_j = J > 0 is the reference's J-slot expansion
    (splatam_tpu/render/binning.py:242-373) with exact buffers, where all
    that is left of it is its pair order: among pairs of equal (tile,
    quantized depth) key, every Gaussian's slots j < J come first, in
    Gaussian order, then the slots j >= J. Its fallback to the classic
    path when pair_cap < J * N + 4096, its tail-only overflow and its
    in_stream change have no counterpart: there is no pair cap."""
    device = proj.depth.device
    grid_x, num_tiles, bits = _key_grid(width, height, full_wh)
    n = proj.depth.shape[0]
    rect_w = aux.rect_wh[:, 0]
    counts, offsets, total = _pair_counts(aux)

    qdepth = quantized_depth(proj.depth, bits, far)

    g = torch.repeat_interleave(torch.arange(n, device=device), counts, output_size=total)
    j = torch.arange(total, device=device) - offsets[g]
    w = torch.clamp(rect_w[g], min=1)
    tdy = torch.div(j, w, rounding_mode="floor")
    tx = aux.rect_min[g, 0] + j - tdy * w
    ty = aux.rect_min[g, 1] + tdy
    n_culled = 0
    if tile_cull:
        rows = torch.cat([proj.xy, proj.conic, cull_cut(proj.opacity)[:, None]], 1)[g]
        culled = tile_culled(tx, ty, *rows.unbind(1))
        with spans.waited("bins.cull"):  # the kept count
            keep = torch.nonzero((j == 0) | ~culled)[:, 0]
        g, j, tx, ty = g[keep], j[keep], tx[keep], ty[keep]
        n_culled = total - g.shape[0]
        total = g.shape[0]
        with spans.waited("bins.cull"):  # bincount reads its largest index back
            counts = torch.bincount(g, minlength=n)
        offsets = torch.cumsum(counts, 0) - counts
    key = ((ty * grid_x + tx) << bits) | qdepth[g]
    key_bits = bits
    if direct_j > 0:
        # one more key bit below the depth: a tail slot sorts after every
        # direct slot of its key, and the stable sort keeps Gaussian order
        key = (key << 1) | (j >= direct_j).to(key.dtype)
        key_bits += 1
    sorted_key, order = torch.sort(key, stable=True)

    targets = torch.arange(num_tiles + 1, device=device, dtype=torch.int64) << key_bits
    tile_start = torch.searchsorted(sorted_key, targets, side="left")
    dst = torch.empty(total, dtype=torch.int32, device=device)
    dst[order] = torch.arange(total, dtype=torch.int32, device=device)
    return Bins(
        pair_gauss=g[order].to(torch.int32),
        tile_start=tile_start.to(torch.int32),
        offsets=offsets.to(torch.int32),
        counts=counts.to(torch.int32),
        dst=dst,
        n_pairs=total,
        n_culled=n_culled,
    )


def build_bins_keyed(proj: Projected, aux: ProjectedAux, width: int, height: int,
                     far: float = 100.0, full_wh: tuple | None = None,
                     direct_j: int = 0) -> Bins:
    """build_bins_plain without the cull, over 32-bit keys: bins_expand
    writes each expansion slot's key, a stable sort orders them (ties in
    slot order, as the int64 sort keeps them), bins_scatter writes the
    outputs. On the card the two are kernels and a pair holds its key into
    the sort; on the CPU their plain versions run (the kernels' twin)."""
    device = proj.depth.device
    grid_x, num_tiles, bits = _key_grid(width, height, full_wh)
    counts, offsets, total = _pair_counts(aux)
    counts, offsets = counts.to(torch.int32), offsets.to(torch.int32)
    if total == 0:  # nothing to launch
        empty = torch.empty(0, dtype=torch.int32, device=device)
        return Bins(empty, torch.zeros(num_tiles + 1, dtype=torch.int32, device=device), offsets,
                    counts, empty, 0)
    qdepth = quantized_depth(proj.depth, bits, far)
    key = bins_expand(offsets, aux.rect_min, aux.rect_wh, qdepth, total, grid_x, bits, direct_j)
    sorted_key, order = torch.sort(key, stable=True)
    del key
    pair_gauss, dst, tile_start = bins_scatter(sorted_key, order, offsets,
                                               bits + (direct_j > 0), num_tiles)
    return Bins(pair_gauss, tile_start, offsets, counts, dst, total)


def bins_expand(offsets, rect_min, rect_wh, qdepth, total: int, grid_x: int, bits: int,
                direct_j: int) -> torch.Tensor:
    """[total] int32: the stored 32-bit key (KEY_FLIP) of every expansion
    slot, from offsets [N] int32, the rectangles [N, 2] and quantized depths
    [N] as the projection and quantized_depth give them (int64). Kernel
    wrapper on the card (one launch, total > 0), bins_expand_plain on the CPU."""
    if not offsets.is_cuda:
        return bins_expand_plain(offsets, rect_min, rect_wh, qdepth, total, grid_x, bits,
                                 direct_j)
    n = offsets.shape[0]
    _cuda.require(offsets, "offsets", torch.int32, (n,))
    _cuda.require(rect_min, "rect_min", torch.int64, (n, 2))
    _cuda.require(rect_wh, "rect_wh", torch.int64, (n, 2))
    _cuda.require(qdepth, "qdepth", torch.int64, (n,))
    key = torch.empty(total, dtype=torch.int32, device=offsets.device)
    _cuda.launch(offsets, "bins_expand", total, n, offsets.data_ptr(), rect_min.data_ptr(),
                 rect_wh.data_ptr(), qdepth.data_ptr(), grid_x, bits, direct_j, key.data_ptr())
    bins_expand.launches += 1
    return key


bins_expand.launches = 0


def bins_expand_plain(offsets, rect_min, rect_wh, qdepth, total: int, grid_x: int, bits: int,
                      direct_j: int) -> torch.Tensor:
    """bins_expand in PyTorch: each slot's Gaussian by a binary search of
    offsets, then build_bins_plain's key, stored as int32."""
    s = torch.arange(total, dtype=torch.int32, device=offsets.device)
    g = torch.searchsorted(offsets, s, right=True) - 1
    j = (s - offsets[g]).to(torch.int64)
    w = torch.clamp(rect_wh[g, 0], min=1)
    tdy = torch.div(j, w, rounding_mode="floor")
    key = ((rect_min[g, 1] + tdy) * grid_x + rect_min[g, 0] + j - tdy * w) << bits | qdepth[g]
    if direct_j > 0:
        key = (key << 1) | (j >= direct_j).to(key.dtype)
    return (key - KEY_FLIP).to(torch.int32)


def bins_scatter(sorted_key, order, offsets, key_bits: int, num_tiles: int) -> tuple:
    """(pair_gauss, dst, tile_start), int32, from the sorted stored keys
    [P] int32 and the sort's order [P] int64 (slot of each sorted position):
    each position's Gaussian by a binary search of offsets, each slot's
    position, and tile t's first position (P past the last pair's tile).
    Kernel wrapper on the card (one launch, P > 0), bins_scatter_plain on the CPU."""
    if not sorted_key.is_cuda:
        return bins_scatter_plain(sorted_key, order, offsets, key_bits, num_tiles)
    total, n = sorted_key.shape[0], offsets.shape[0]
    _cuda.require(sorted_key, "sorted_key", torch.int32, (total,))
    _cuda.require(order, "order", torch.int64, (total,))
    _cuda.require(offsets, "offsets", torch.int32, (n,))
    i32 = dict(dtype=torch.int32, device=sorted_key.device)
    pair_gauss, dst = torch.empty(total, **i32), torch.empty(total, **i32)
    tile_start = torch.empty(num_tiles + 1, **i32)
    _cuda.launch(sorted_key, "bins_scatter", total, n, sorted_key.data_ptr(), order.data_ptr(),
                 offsets.data_ptr(), key_bits, num_tiles, pair_gauss.data_ptr(), dst.data_ptr(),
                 tile_start.data_ptr())
    bins_scatter.launches += 1
    return pair_gauss, dst, tile_start


bins_scatter.launches = 0


def bins_scatter_plain(sorted_key, order, offsets, key_bits: int, num_tiles: int) -> tuple:
    """bins_scatter in PyTorch."""
    total, device = sorted_key.shape[0], sorted_key.device
    pair_gauss = (torch.searchsorted(offsets, order.to(torch.int32), right=True) - 1).to(torch.int32)
    dst = torch.empty(total, dtype=torch.int32, device=device)
    dst[order] = torch.arange(total, dtype=torch.int32, device=device)
    tile = (sorted_key.to(torch.int64) + KEY_FLIP) >> key_bits
    tile_start = torch.searchsorted(tile, torch.arange(num_tiles + 1, device=device))
    return pair_gauss, dst, tile_start.to(torch.int32)


def reset_pair_totals() -> None:
    """Zero build_bins.totals: the structure builds since, the pairs they
    put in their streams, and the pairs their tile cull dropped."""
    build_bins.totals = dict(builds=0, pairs=0, culled=0)


reset_pair_totals()
