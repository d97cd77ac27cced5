"""Tile compositing: the composite-forward kernel (K1) and the segment
reduce kernel (K3), each with its plain PyTorch version.

Counterpart of splatam_tpu/render/pallas/composite_pallas.py. The plain
versions here are the specification the kernels are held to, and what
runs for CPU tensors. Compositing follows renderCUDA's per-pixel rules
(the reference rasterizer; splatam_tpu/render/naive.py is the oracle):
pairs in the tile's depth order, skip a pair when power > 0 or
alpha < 1/255, clamp alpha at 0.99, stop BEFORE the pair for which
T*(1-alpha) < 1e-4, silhouette = 1 - T_final.

Per-pair attribute rows of the generic compositor: x, y, conic a, b, c,
opacity, then the channels. Output rows of every forward: the channels,
then the silhouette, then n_contrib (1-based index, within the tile, of
the last pair applied at the pixel), as an image [ch + 2, H, W].
"""
from __future__ import annotations

import torch

from splatam_tpu_torch.render import _cuda
from splatam_tpu_torch.render.binning import grid_shape
from splatam_tpu_torch.render.projection import TILE

PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
CH = 5  # channels of the slice's renders: r, g, b, z, z^2


def to_tiles(img: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> [C, T, 256] (tile-major, row-major pixels in a tile;
    the ragged edge is zero-padded)."""
    c, h, w = img.shape
    gx, gy = grid_shape(w, h)
    pad = torch.zeros((c, gy * TILE, gx * TILE), dtype=img.dtype, device=img.device)
    pad[:, :h, :w] = img
    return pad.reshape(c, gy, TILE, gx, TILE).permute(0, 1, 3, 2, 4).reshape(c, gx * gy, PIX)


def assemble_image(tiles: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """[C, T, 256] -> [C, H, W], cropping the ragged edge."""
    c = tiles.shape[0]
    gx, gy = grid_shape(width, height)
    img = tiles.reshape(c, gy, gx, TILE, TILE).permute(0, 1, 3, 2, 4)
    return img.reshape(c, gy * TILE, gx * TILE)[:, :height, :width]


def _tile_frame(tile_start: torch.Tensor, width: int):
    """Per-tile origin [T, 1] and per-pixel local coordinates [1, 256]."""
    gx, _ = grid_shape(width, 1)
    device = tile_start.device
    t = torch.arange(tile_start.shape[0] - 1, device=device)
    ox = ((t % gx) * TILE).to(torch.float32)[:, None]
    oy = ((t // gx) * TILE).to(torch.float32)[:, None]
    p = torch.arange(PIX, device=device)
    lx = (p % TILE).to(torch.float32)[None]
    ly = (p // TILE).to(torch.float32)[None]
    return ox, oy, lx, ly


def _pair_alpha(xy, conic, opacity, idx, ox, oy, lx, ly):
    """Per-(tile, pixel) alpha quantities of each tile's idx-th pair."""
    dx = (xy[idx, 0:1] - ox) - lx
    dy = (xy[idx, 1:2] - oy) - ly
    a, b, c = conic[idx, 0:1], conic[idx, 1:2], conic[idx, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    gval = torch.exp(power)
    alpha_un = opacity[idx, None] * gval
    alpha = torch.clamp(alpha_un, max=ALPHA_MAX)
    skip = (power > 0.0) | (alpha < ALPHA_MIN)
    return dx, dy, power, gval, alpha_un, alpha, skip


def composite_pairs_plain(xy, conic, opacity, chans, tile_start, width: int,
                          height: int) -> torch.Tensor:
    """Composite per-pair attributes (pairs sorted by tile, then depth):
    xy [P, 2], conic [P, 3], opacity [P], chans [P, ch] -> [ch + 2, H, W].

    Walks every tile's list in lockstep, one pair index per step."""
    ch = chans.shape[1]
    n_tiles = tile_start.shape[0] - 1
    ox, oy, lx, ly = _tile_frame(tile_start, width)
    starts = tile_start[:-1].long()
    lens = (tile_start[1:] - tile_start[:-1]).long()
    kmax = int(lens.max()) if n_tiles else 0
    f32 = dict(dtype=torch.float32, device=xy.device)
    t_cur = torch.ones((n_tiles, PIX), **f32)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=xy.device)
    acc = torch.zeros((ch, n_tiles, PIX), **f32)
    ncon = torch.zeros((n_tiles, PIX), **f32)
    p_last = max(xy.shape[0] - 1, 0)
    for k in range(kmax):
        valid = (k < lens)[:, None]
        idx = torch.clamp(starts + k, max=p_last)
        _, _, _, _, _, alpha, skip = _pair_alpha(xy, conic, opacity, idx, ox, oy, lx, ly)
        live = ~done & ~skip & valid
        test_t = t_cur * (1.0 - alpha)
        term = live & (test_t < T_EPS)
        apply = live & ~term
        wgt = torch.where(apply, alpha * t_cur, 0.0)
        acc += chans[idx].T[:, :, None] * wgt[None]
        t_cur = torch.where(apply, test_t, t_cur)
        ncon = torch.where(apply, float(k + 1), ncon)
        done = done | term
    out = torch.cat([acc, (1.0 - t_cur)[None], ncon[None]])
    return assemble_image(out, width, height).contiguous()


def composite_pairs_backward_plain(xy, conic, opacity, chans, tile_start, width: int,
                                   height: int, state, g) -> torch.Tensor:
    """Per-pair screen-space gradients of composite_pairs_plain, by the
    reverse walk renderCUDA's backward runs (each pixel from its n_contrib
    back to the front).

    state: the forward's [ch + 2, H, W] (silhouette and n_contrib rows are
    read); g: cotangents [ch + 1, H, W] of the channels and the silhouette.
    Returns [P, 6 + ch]: d x, d y, d conic a, b, c, d opacity, d channels.
    Pairs past every pixel's n_contrib get zero."""
    ch = chans.shape[1]
    n_pairs = xy.shape[0]
    n_tiles = tile_start.shape[0] - 1
    ox, oy, lx, ly = _tile_frame(tile_start, width)
    starts = tile_start[:-1].long()
    lens = (tile_start[1:] - tile_start[:-1]).long()
    st = to_tiles(state)
    t_cur = 1.0 - st[ch]
    ncon = st[ch + 1]
    gt = to_tiles(g)  # [ch + 1, T, PIX]; the silhouette is a constant-1 channel
    kmax = int(ncon.max()) if n_tiles else 0
    f32 = dict(dtype=torch.float32, device=xy.device)
    accum = torch.zeros((ch + 1, n_tiles, PIX), **f32)
    last_c = torch.zeros((ch + 1, n_tiles, PIX), **f32)
    last_alpha = torch.zeros((n_tiles, PIX), **f32)
    out = torch.zeros((n_pairs, 6 + ch), **f32)
    ones = torch.ones((1, n_tiles), **f32)
    p_last = max(n_pairs - 1, 0)
    for k in range(kmax - 1, -1, -1):
        valid = k < lens
        idx = torch.clamp(starts + k, max=p_last)
        dx, dy, _, gval, alpha_un, alpha, skip = _pair_alpha(
            xy, conic, opacity, idx, ox, oy, lx, ly)
        act = ~skip & valid[:, None] & (float(k) < ncon)
        t_cur = torch.where(act, t_cur / (1.0 - alpha), t_cur)
        cval = torch.cat([chans[idx].T, ones])[:, :, None]  # [ch + 1, T, 1]
        accum = torch.where(act, last_alpha * last_c + (1.0 - last_alpha) * accum, accum)
        last_c = torch.where(act, cval.expand_as(last_c), last_c)
        dalpha = torch.where(act, ((cval - accum) * gt).sum(0) * t_cur, 0.0)
        last_alpha = torch.where(act, alpha, last_alpha)
        dchan = torch.where(act, alpha * t_cur, 0.0)[None] * gt[:ch]
        not_clamped = act & (alpha_un <= ALPHA_MAX)
        dpower = torch.where(not_clamped, opacity[idx, None] * dalpha, 0.0) * gval
        a, b, c = conic[idx, 0:1], conic[idx, 1:2], conic[idx, 2:3]
        rows = torch.stack([
            (dpower * -(a * dx + b * dy)).sum(1),
            (dpower * -(c * dy + b * dx)).sum(1),
            (dpower * (-0.5 * dx * dx)).sum(1),
            (dpower * (-dx * dy)).sum(1),
            (dpower * (-0.5 * dy * dy)).sum(1),
            torch.where(not_clamped, dalpha * gval, 0.0).sum(1),
        ], dim=1)
        rows = torch.cat([rows, dchan.sum(2).T], dim=1)
        out[idx[valid]] = rows[valid]
    return out


# ---------------------------------------------------------------------------
# K1: composite forward
# ---------------------------------------------------------------------------


def composite_forward_plain(attrs, pair_gauss, tile_start, width: int, height: int):
    """attrs [N, 6 + ch] per-Gaussian rows (x, y, conic a, b, c, opacity,
    channels) composited through the sorted pairs pair_gauss [P]."""
    a = attrs[pair_gauss.long()]
    return composite_pairs_plain(a[:, 0:2], a[:, 2:5], a[:, 5], a[:, 6:], tile_start,
                                 width, height)


def composite_forward(attrs, pair_gauss, tile_start, width: int, height: int):
    """K1 wrapper (forward only): [ch + 2, H, W] from per-Gaussian attrs,
    see composite_forward_plain. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if not attrs.is_cuda:
        return composite_forward_plain(attrs, pair_gauss, tile_start, width, height)
    gx, gy = grid_shape(width, height)
    _cuda.require(attrs, "attrs", torch.float32, (None, 6 + CH))
    _cuda.require(pair_gauss, "pair_gauss", torch.int32, (None,))
    _cuda.require(tile_start, "tile_start", torch.int32, (gx * gy + 1,))
    out = torch.empty((CH + 2, height, width), dtype=torch.float32, device=attrs.device)
    err = _cuda.lib().composite_forward_ch5(
        attrs.data_ptr(), pair_gauss.data_ptr(), tile_start.data_ptr(),
        gx, gy, width, height, out.data_ptr(), _cuda.stream_ptr(attrs))
    _cuda.check(err, "composite_forward_ch5")
    composite_forward.launches += 1
    return out


composite_forward.launches = 0


# ---------------------------------------------------------------------------
# K3: segment reduce (per-pair -> per-Gaussian gradient sums)
# ---------------------------------------------------------------------------


def segment_reduce_plain(dpair, dst, offsets, counts):
    """Per-Gaussian sums of per-pair rows: out[g] = sum of dpair[dst[j]]
    over g's expansion slots j in [offsets[g], offsets[g] + counts[g])."""
    n = counts.shape[0]
    gid = torch.repeat_interleave(
        torch.arange(n, device=dpair.device), counts.long(), output_size=dst.shape[0])
    out = torch.zeros((n, dpair.shape[1]), dtype=dpair.dtype, device=dpair.device)
    return out.index_add_(0, gid, dpair[dst.long()])


def segment_reduce(dpair, dst, offsets, counts):
    """K3 wrapper: [N, 8] per-Gaussian sums of dpair [P, 8], see
    segment_reduce_plain. Deterministic on the card (fixed summation
    order per Gaussian)."""
    if not dpair.is_cuda:
        return segment_reduce_plain(dpair, dst, offsets, counts)
    n = counts.shape[0]
    _cuda.require(dpair, "dpair", torch.float32, (None, 8))
    _cuda.require(dst, "dst", torch.int32, (dpair.shape[0],))
    _cuda.require(offsets, "offsets", torch.int32, (n,))
    _cuda.require(counts, "counts", torch.int32, (n,))
    out = torch.empty((n, 8), dtype=torch.float32, device=dpair.device)
    err = _cuda.lib().segment_reduce8(
        dpair.data_ptr(), dst.data_ptr(), offsets.data_ptr(), counts.data_ptr(), n,
        out.data_ptr(), _cuda.stream_ptr(dpair))
    _cuda.check(err, "segment_reduce8")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
