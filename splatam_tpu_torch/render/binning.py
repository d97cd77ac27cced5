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
    host sync per structure build (renderCUDA does the same), so nothing
    overflows and nothing is retried;
  * the per-tile layout is the sorted stream itself (tile t owns pairs
    tile_start[t] .. tile_start[t+1]); no padding to 128-lane chunks.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from splatam_tpu_torch.render.projection import NEAR_CLIP, TILE, Projected, ProjectedAux


class Bins(NamedTuple):
    pair_gauss: torch.Tensor  # [P] int32 gaussian index per sorted pair
    tile_start: torch.Tensor  # [T + 1] int32 segment starts in the sorted stream
    offsets: torch.Tensor  # [N] int32 first expansion slot of each gaussian
    counts: torch.Tensor  # [N] int32 pairs per gaussian (0 = invisible)
    dst: torch.Tensor  # [P] int32 sorted position of each expansion slot
    n_pairs: int


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


def build_bins(proj: Projected, aux: ProjectedAux, width: int, height: int,
               far: float = 100.0, full_wh: tuple | None = None) -> Bins:
    """Expand (gaussian, tile) pairs and sort them by (tile, depth) key.

    full_wh: the (width, height) of the image this one is a band of. Its
    tile count, not the band's, sets the depth key's bits, so a band's
    pairs composite in the full image's order: with the band's own (fewer)
    tiles the key would keep one more depth bit and could part pairs that
    the full image's key ties (and then orders by Gaussian index)."""
    device = proj.depth.device
    grid_x, grid_y = grid_shape(width, height)
    num_tiles = grid_x * grid_y
    key_x, key_y = grid_shape(*full_wh) if full_wh is not None else (grid_x, grid_y)
    bits = depth_bits_for(key_x * key_y)
    n = proj.depth.shape[0]

    rect_w = aux.rect_wh[:, 0]
    counts = torch.where(aux.visible, rect_w * aux.rect_wh[:, 1], torch.zeros_like(rect_w))
    offsets = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())  # the one host sync of a structure build

    qdepth = quantized_depth(proj.depth, bits, far)

    g = torch.repeat_interleave(torch.arange(n, device=device), counts, output_size=total)
    j = torch.arange(total, device=device) - offsets[g]
    w = torch.clamp(rect_w[g], min=1)
    tdy = torch.div(j, w, rounding_mode="floor")
    tdx = j - tdy * w
    tile = (aux.rect_min[g, 1] + tdy) * grid_x + aux.rect_min[g, 0] + tdx
    key = (tile << bits) | qdepth[g]
    sorted_key, order = torch.sort(key, stable=True)

    targets = torch.arange(num_tiles + 1, device=device, dtype=torch.int64) << bits
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
    )
