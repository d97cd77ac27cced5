"""Tile compositing: the composite-forward kernel (K1), the
composite-backward kernel (K2) and the segment reduce kernel (K3), each with
its plain PyTorch version, and the two autograd Functions of the generic
differentiable render built on them.

Counterpart of splatam_tpu/render/pallas/composite_pallas.py. The plain
versions here are the specification the kernels are held to, and what
runs for CPU tensors. Compositing follows renderCUDA's per-pixel rules
(the reference rasterizer; splatam_tpu/render/naive.py is the oracle):
pairs in the tile's depth order, skip a pair when power > 0 or
alpha < 1/255, clamp alpha at 0.99, stop BEFORE the pair for which
T*(1-alpha) < 1e-4, silhouette = 1 - T_final.

Attribute rows of the compositor: x, y, conic a, b, c, opacity, then the
channels. K1 and K2 take them per Gaussian ([N, 6 + ch], gathered through
the sorted pairs' Gaussian indices) or per sorted pair ([P, 6 + ch], with
no index). Output rows of every forward: the channels, then the
silhouette, then n_contrib (1-based index, within the tile, of the last
pair applied at the pixel), as an image [ch + 2, H, W]. The kernels take
1 to MAX_CH channels, as the TPU kernels do (their attribute block holds
16 rows: 6 + ch <= 16); the plain versions take any count.
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
CH = 5  # channels of the SLAM loop's renders: r, g, b, z, z^2
MAX_CH = 10  # the most channels K1 and K2 take (composite_pallas.py:51, ATTR_W = 16 rows)
CHANNELS = tuple(range(1, MAX_CH + 1))


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


def _tile_frame(tile_start: torch.Tensor, width: int, dtype=torch.float32):
    """Per-tile origin [T, 1] and per-pixel local coordinates [1, 256]."""
    gx, _ = grid_shape(width, 1)
    device = tile_start.device
    t = torch.arange(tile_start.shape[0] - 1, device=device)
    ox = ((t % gx) * TILE).to(dtype)[:, None]
    oy = ((t // gx) * TILE).to(dtype)[:, None]
    p = torch.arange(PIX, device=device)
    lx = (p % TILE).to(dtype)[None]
    ly = (p // TILE).to(dtype)[None]
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


# ---------------------------------------------------------------------------
# The warp-granular cull of K1 and K2 (pair_reach and reach_warp_mask in
# csrc/common.cuh), in plain PyTorch
# ---------------------------------------------------------------------------

WARPS = PIX // 32
WARP_W = 8  # pixels across one warp of K1 and K2 (WARP_W in csrc/common.cuh): four rows of 8
CULL_MAX_COND = 1e4  # the rule holds while (a + c)^2 <= CULL_MAX_COND * det
CULL_REL = 1.01  # L and each half width are widened by this factor ...
CULL_ABS = 0.01  # ... and this much (in L's units, in pixels)
CULL_MAX_COORD = 1e6  # a tame pair: |centre - tile origin| at most this many pixels ...
CULL_MAX_TERM = 1e18  # ... and |a|, |b|, |c|, |opacity| at most this (no overflow in power)


def cull_rows_plain(xy, conic, opacity, tile_start, width: int) -> torch.Tensor:
    """The box of its tile each sorted pair can reach: [P, 4] float32, x_lo,
    x_hi, y_lo, y_hi in pixels from the tile's origin.

    A pair contributes at a pixel only where power <= 0 and opacity *
    exp(power) >= 1/255: where 0.5 (a dx^2 + c dy^2) + b dx dy <= L =
    ln(255 opacity). For a positive definite conic that ellipse lies within
    |dx| <= sqrt(2 L c / det), |dy| <= sqrt(2 L a / det). L and the half
    widths are widened (CULL_REL, CULL_ABS) far past the float32 rounding of
    the walk's own power, which the condition bound CULL_MAX_COND keeps
    within 0.3% of the exact one. An opacity below 1/255 reaches nothing
    (lo = inf, hi = -inf); a pair the rule cannot bound (det <= 0, a or
    c <= 0, ill conditioned, or not tame: a term that is not finite or so
    large that the walk's power could overflow to NaN, which no test of
    the walk skips) reaches everything (-inf, inf): the cull may only skip
    what the walk skips anyway."""
    gx, _ = grid_shape(width, 1)
    lens = (tile_start[1:] - tile_start[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(lens.numel(), device=xy.device), lens,
                                   output_size=xy.shape[0])
    rx = xy[:, 0] - ((tile % gx) * TILE).to(torch.float32)
    ry = xy[:, 1] - ((tile // gx) * TILE).to(torch.float32)
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    det, tr = a * c - b * b, a + c
    tame = ((rx.abs() <= CULL_MAX_COORD) & (ry.abs() <= CULL_MAX_COORD)
            & (a.abs() <= CULL_MAX_TERM) & (b.abs() <= CULL_MAX_TERM)
            & (c.abs() <= CULL_MAX_TERM) & (opacity.abs() <= CULL_MAX_TERM))
    bounded = (tame & (a > 0.0) & (c > 0.0) & (det > 0.0)
               & (tr * tr <= CULL_MAX_COND * det))
    log_l = torch.log(255.0 * opacity) * CULL_REL + CULL_ABS
    hx = torch.sqrt(2.0 * log_l * c / det) * CULL_REL + CULL_ABS
    hy = torch.sqrt(2.0 * log_l * a / det) * CULL_REL + CULL_ABS
    inf = torch.full_like(rx, float("inf"))
    box = torch.stack([torch.where(bounded, rx - hx, -inf), torch.where(bounded, rx + hx, inf),
                       torch.where(bounded, ry - hy, -inf), torch.where(bounded, ry + hy, inf)], 1)
    nowhere = (tame & (opacity < ALPHA_MIN))[:, None]
    return torch.where(nowhere, torch.stack([inf, -inf, inf, -inf], 1), box)


def warp_pixels(warp_w: int = WARP_W, device=None) -> torch.Tensor:
    """[8, 32] tile-pixel indices (row-major in the 16x16 tile) of each warp:
    warp_w = 16 two rows of 16, warp_w = 8 four rows of 8."""
    warp_h = 32 // warp_w
    across = TILE // warp_w
    w = torch.arange(WARPS, device=device)[:, None]
    lane = torch.arange(32, device=device)[None]
    lx = (w % across) * warp_w + lane % warp_w
    ly = (w // across) * warp_h + lane // warp_w
    return ly * TILE + lx


def cull_warp_mask(box: torch.Tensor, warp_w: int = WARP_W) -> torch.Tensor:
    """[*, 8] bool from box rows [*, 4]: warp w of the pair's tile must visit
    the pair (its pixels' rectangle meets the box). A NaN bound excludes
    nothing."""
    pix = warp_pixels(warp_w, box.device)
    x0 = (pix[:, 0] % TILE).to(torch.float32)[None]
    y0 = (pix[:, 0] // TILE).to(torch.float32)[None]
    x1, y1 = x0 + (warp_w - 1), y0 + (32 // warp_w - 1)
    x_lo, x_hi, y_lo, y_hi = (box[:, i:i + 1] for i in range(4))
    return ~((x_lo > x1) | (x_hi < x0) | (y_lo > y1) | (y_hi < y0))


def cull_visit(box: torch.Tensor, warp_w: int = WARP_W) -> torch.Tensor:
    """[*, 256] bool: the pixel's warp visits the pair (cull_warp_mask spread
    over each warp's pixels)."""
    warp_of = torch.empty(PIX, dtype=torch.long, device=box.device)
    warp_of[warp_pixels(warp_w, box.device).reshape(-1)] = torch.arange(
        WARPS, device=box.device).repeat_interleave(32)
    return cull_warp_mask(box, warp_w)[:, warp_of]


def composite_pairs_plain(xy, conic, opacity, chans, tile_start, width: int,
                          height: int, cull: int | None = None,
                          t_out: torch.Tensor | None = None) -> torch.Tensor:
    """Composite per-pair attributes (pairs sorted by tile, then depth):
    xy [P, 2], conic [P, 3], opacity [P], chans [P, ch] -> [ch + 2, H, W].

    Walks every tile's list in lockstep, one pair index per step. With
    `cull` (a warp width, 16 or 8) a pixel skips every pair its warp does
    not visit under the kernels' cull, which must change nothing. The walk
    runs in the rows' dtype: float32 as the kernels, float64 for a truth.
    t_out [H, W], where given, receives T_final itself."""
    ch = chans.shape[1]
    n_tiles = tile_start.shape[0] - 1
    ox, oy, lx, ly = _tile_frame(tile_start, width, xy.dtype)
    starts = tile_start[:-1].long()
    lens = (tile_start[1:] - tile_start[:-1]).long()
    kmax = int(lens.max()) if n_tiles else 0
    fp = dict(dtype=xy.dtype, device=xy.device)
    t_cur = torch.ones((n_tiles, PIX), **fp)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=xy.device)
    acc = torch.zeros((ch, n_tiles, PIX), **fp)
    ncon = torch.zeros((n_tiles, PIX), **fp)
    p_last = max(xy.shape[0] - 1, 0)
    box = None if cull is None else cull_rows_plain(xy, conic, opacity, tile_start, width)
    for k in range(kmax):
        valid = (k < lens)[:, None]
        idx = torch.clamp(starts + k, max=p_last)
        _, _, _, _, _, alpha, skip = _pair_alpha(xy, conic, opacity, idx, ox, oy, lx, ly)
        if box is not None:
            skip = skip | ~cull_visit(box[idx], cull)
        live = ~done & ~skip & valid
        test_t = t_cur * (1.0 - alpha)
        term = live & (test_t < T_EPS)
        apply = live & ~term
        wgt = torch.where(apply, alpha * t_cur, 0.0)
        acc += chans[idx].T[:, :, None] * wgt[None]
        t_cur = torch.where(apply, test_t, t_cur)
        ncon = torch.where(apply, float(k + 1), ncon)
        done = done | term
    if t_out is not None:
        t_out.copy_(assemble_image(t_cur[None], width, height)[0])
    out = torch.cat([acc, (1.0 - t_cur)[None], ncon[None]])
    return assemble_image(out, width, height).contiguous()


def composite_pairs_backward_plain(xy, conic, opacity, chans, tile_start, width: int,
                                   height: int, state, g,
                                   cull: int | None = None,
                                   t_final: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pair screen-space gradients of composite_pairs_plain, by the
    reverse walk renderCUDA's backward runs (each pixel from its n_contrib
    back to the front).

    state: the forward's [ch + 2, H, W] (silhouette and n_contrib rows are
    read); g: cotangents [ch + 1, H, W] of the channels and the silhouette.
    Returns [P, 6 + ch]: d x, d y, d conic a, b, c, d opacity, d channels.
    Pairs past every pixel's n_contrib get zero. `cull` as in
    composite_pairs_plain. t_final [H, W]: T_final itself where the caller
    kept it (composite_pairs_plain's t_out); else 1 - the silhouette row."""
    ch = chans.shape[1]
    n_pairs = xy.shape[0]
    n_tiles = tile_start.shape[0] - 1
    ox, oy, lx, ly = _tile_frame(tile_start, width, xy.dtype)
    starts = tile_start[:-1].long()
    lens = (tile_start[1:] - tile_start[:-1]).long()
    st = to_tiles(state)
    t_cur = 1.0 - st[ch] if t_final is None else to_tiles(t_final[None])[0]
    ncon = st[ch + 1]
    gt = to_tiles(g)  # [ch + 1, T, PIX]; the silhouette is a constant-1 channel
    kmax = int(ncon.max()) if n_tiles else 0
    fp = dict(dtype=xy.dtype, device=xy.device)
    accum = torch.zeros((ch + 1, n_tiles, PIX), **fp)
    last_c = torch.zeros((ch + 1, n_tiles, PIX), **fp)
    last_alpha = torch.zeros((n_tiles, PIX), **fp)
    out = torch.zeros((n_pairs, 6 + ch), **fp)
    ones = torch.ones((1, n_tiles), **fp)
    p_last = max(n_pairs - 1, 0)
    box = None if cull is None else cull_rows_plain(xy, conic, opacity, tile_start, width)
    for k in range(kmax - 1, -1, -1):
        valid = k < lens
        idx = torch.clamp(starts + k, max=p_last)
        dx, dy, _, gval, alpha_un, alpha, skip = _pair_alpha(
            xy, conic, opacity, idx, ox, oy, lx, ly)
        if box is not None:
            skip = skip | ~cull_visit(box[idx], cull)
        act = ~skip & valid[:, None] & (float(k) < ncon)
        t_cur = torch.where(act, t_cur / (1.0 - alpha), t_cur)
        cval = torch.cat([chans[idx].T, ones])[:, :, None]  # [ch + 1, T, 1]
        accum = torch.where(act, last_alpha * last_c + (1.0 - last_alpha) * accum, accum)
        last_c = torch.where(act, cval.expand_as(last_c), last_c)
        dalpha = torch.where(act, ((cval - accum) * gt).sum(0) * t_cur, 0.0)
        last_alpha = torch.where(act, alpha, last_alpha)
        dchan = torch.where(act, alpha * t_cur, 0.0)[None] * gt[:ch]
        not_clamped = act & (alpha_un <= ALPHA_MAX)
        # inside the where: a skipped pixel's exp(power) may be inf, and 0 * inf is NaN
        dpower = torch.where(not_clamped, opacity[idx, None] * dalpha * gval, 0.0)
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


def _rows(attrs, pair_gauss):
    """Per-pair attribute rows: gathered through pair_gauss, or attrs
    itself when it already holds one row per sorted pair."""
    return attrs if pair_gauss is None else attrs[pair_gauss.long()]


def composite_forward_plain(attrs, pair_gauss, tile_start, width: int, height: int,
                            cull: int | None = None, t_out: torch.Tensor | None = None):
    """attrs [N, 6 + ch] per-Gaussian rows (x, y, conic a, b, c, opacity,
    channels) composited through the sorted pairs pair_gauss [P]; with
    pair_gauss None, attrs holds one row per sorted pair. `cull` and t_out
    as in composite_pairs_plain."""
    a = _rows(attrs, pair_gauss)
    return composite_pairs_plain(a[:, 0:2], a[:, 2:5], a[:, 5], a[:, 6:], tile_start,
                                 width, height, cull, t_out)


def check_channels(ch: int, name: str = "channels") -> None:
    """Raise a ValueError unless K1 and K2 take ch channels (1 to MAX_CH)."""
    if not 1 <= ch <= MAX_CH:
        raise ValueError(f"{name}: the compositing kernels take 1 to {MAX_CH} channels "
                         f"(6 + ch <= 16 attribute rows, as the TPU kernels), got {ch}")


def _check_rows(attrs, pair_gauss, tile_start, width, height):
    """Validate K1/K2 inputs; returns (channels, grid_x, grid_y, pair
    count). The channel count is attrs' width less the six geometry
    columns."""
    gx, gy = grid_shape(width, height)
    ch = attrs.shape[-1] - 6 if attrs.dim() == 2 else 0
    check_channels(ch, "attrs")
    _cuda.require(attrs, "attrs", torch.float32, (None, 6 + ch))
    if pair_gauss is not None:
        _cuda.require(pair_gauss, "pair_gauss", torch.int32, (None,))
    _cuda.require(tile_start, "tile_start", torch.int32, (gx * gy + 1,))
    n_pairs = attrs.shape[0] if pair_gauss is None else pair_gauss.shape[0]
    return ch, gx, gy, n_pairs


def _ptr(t):
    return None if t is None else t.data_ptr()


def composite_forward(attrs, pair_gauss, tile_start, width: int, height: int):
    """K1 wrapper (forward only): [ch + 2, H, W] from per-Gaussian attrs
    and pair_gauss, or from per-pair rows with pair_gauss None; see
    composite_forward_plain. CUDA tensors launch the kernel's instance at
    ch = attrs' width - 6 channels (1 to MAX_CH, else ValueError); CPU
    tensors take the plain version. `launches` counts each instance's
    launches, by channel count."""
    if not attrs.is_cuda:
        return composite_forward_plain(attrs, pair_gauss, tile_start, width, height)
    ch, gx, gy, _ = _check_rows(attrs, pair_gauss, tile_start, width, height)
    out = torch.empty((ch + 2, height, width), dtype=torch.float32, device=attrs.device)
    _cuda.launch(attrs, "composite_forward", ch, attrs.data_ptr(), _ptr(pair_gauss),
                 tile_start.data_ptr(), gx, gy, width, height, out.data_ptr(),
                 label=f"composite_forward (ch {ch})")
    composite_forward.launches[ch] += 1
    return out


composite_forward.launches = dict.fromkeys(CHANNELS, 0)


# ---------------------------------------------------------------------------
# K2: composite backward
# ---------------------------------------------------------------------------


def composite_backward_plain(attrs, pair_gauss, tile_start, width: int, height: int,
                             state, g, cull: int | None = None,
                             t_final: torch.Tensor | None = None):
    """Per-pair screen-space gradients [P, 6 + ch] of composite_forward_plain
    (composite_pairs_backward_plain on the gathered rows)."""
    a = _rows(attrs, pair_gauss)
    return composite_pairs_backward_plain(a[:, 0:2], a[:, 2:5], a[:, 5], a[:, 6:], tile_start,
                                          width, height, state, g, cull, t_final)


def composite_backward(attrs, pair_gauss, tile_start, width: int, height: int, state, g):
    """K2 wrapper: per-pair gradients [P, 6 + ch] in sorted-pair order
    (d x, d y, d conic a, b, c, d opacity, d channels) given K1's output
    `state` [ch + 2, H, W] and cotangents g [ch + 1, H, W] of the channels
    and the silhouette. Inputs as composite_forward takes them, and so is
    the instance chosen and counted. Every slot is written: pairs no pixel
    reached get 0."""
    if not attrs.is_cuda:
        return composite_backward_plain(attrs, pair_gauss, tile_start, width, height, state, g)
    ch, gx, gy, n_pairs = _check_rows(attrs, pair_gauss, tile_start, width, height)
    _cuda.require(state, "state", torch.float32, (ch + 2, height, width))
    _cuda.require(g, "g", torch.float32, (ch + 1, height, width))
    out = torch.empty((n_pairs, 6 + ch), dtype=torch.float32, device=attrs.device)
    _cuda.launch(attrs, "composite_backward", ch, attrs.data_ptr(), _ptr(pair_gauss),
                 tile_start.data_ptr(), gx, gy, width, height, state.data_ptr(), g.data_ptr(),
                 out.data_ptr(), label=f"composite_backward (ch {ch})")
    composite_backward.launches[ch] += 1
    return out


composite_backward.launches = dict.fromkeys(CHANNELS, 0)


# ---------------------------------------------------------------------------
# K3: segment reduce (per-pair -> per-Gaussian gradient sums)
# ---------------------------------------------------------------------------

# The fused path's world rows (8) and the generic path's 6 + ch (7 to 16)
SEGMENT_WIDTHS = tuple(range(7, 6 + MAX_CH + 1))


def segment_reduce_plain(dpair, dst, offsets, counts):
    """Per-Gaussian sums of per-pair rows: out[g] = sum of dpair[dst[j]]
    over g's expansion slots j in [offsets[g], offsets[g] + counts[g])."""
    n = counts.shape[0]
    gid = torch.repeat_interleave(
        torch.arange(n, device=dpair.device), counts.long(), output_size=dst.shape[0])
    out = torch.zeros((n, dpair.shape[1]), dtype=dpair.dtype, device=dpair.device)
    return out.index_add_(0, gid, dpair[dst.long()])


def segment_reduce(dpair, dst, offsets, counts):
    """K3 wrapper: [N, k] per-Gaussian sums of dpair [P, k], k in
    SEGMENT_WIDTHS; see segment_reduce_plain. Deterministic on the card
    (fixed summation order per Gaussian). `launches` counts the launches
    of each width's kernel."""
    if not dpair.is_cuda:
        return segment_reduce_plain(dpair, dst, offsets, counts)
    n, k = counts.shape[0], dpair.shape[1]
    if k not in SEGMENT_WIDTHS:
        raise ValueError(f"dpair: expected {SEGMENT_WIDTHS} columns, got {k}")
    _cuda.require(dpair, "dpair", torch.float32, (None, k))
    _cuda.require(dst, "dst", torch.int32, (dpair.shape[0],))
    _cuda.require(offsets, "offsets", torch.int32, (n,))
    _cuda.require(counts, "counts", torch.int32, (n,))
    out = torch.empty((n, k), dtype=torch.float32, device=dpair.device)
    _cuda.launch(dpair, "segment_reduce", k, dpair.data_ptr(), dst.data_ptr(),
                 offsets.data_ptr(), counts.data_ptr(), n, out.data_ptr(),
                 label=f"segment_reduce ({k} columns)")
    segment_reduce.launches[k] += 1
    return out


segment_reduce.launches = dict.fromkeys(SEGMENT_WIDTHS, 0)


# ---------------------------------------------------------------------------
# autograd around the kernels (the generic differentiable render)
# ---------------------------------------------------------------------------


class CompositeGauss(torch.autograd.Function):
    """Per-Gaussian compositing (_composite_core in the JAX package):
    forward K1, backward K2 -> K3, returning d(xy, conic, opacity,
    channels) per Gaussian. ps is a render.api.PairStructure. The image
    is [ch + 1, H, W]: the channels, then the silhouette."""

    @staticmethod
    def forward(ctx, xy, conic, opacity, chans, ps, width, height):
        attrs = torch.cat([xy, conic, opacity[:, None], chans], dim=1).contiguous()
        out = composite_forward(attrs, ps.pair_gauss, ps.tile_start, width, height)
        ctx.save_for_backward(attrs, out)
        ctx.ps, ctx.wh = ps, (width, height)
        return out[:chans.shape[1] + 1]

    @staticmethod
    def backward(ctx, g):
        attrs, out = ctx.saved_tensors
        ps = ctx.ps
        dpair = composite_backward(attrs, ps.pair_gauss, ps.tile_start, *ctx.wh, out,
                                   g.contiguous())
        d = segment_reduce(dpair, ps.dst, ps.offsets, ps.counts)
        return d[:, 0:2], d[:, 2:5], d[:, 5], d[:, 6:], None, None, None


class CompositePairs(torch.autograd.Function):
    """Per-pair compositing (_composite_pairs_core in the JAX package):
    forward K1 on per-pair rows [P, 6 + ch], backward K2 only, returning
    the per-pair gradients with no reduction."""

    @staticmethod
    def forward(ctx, rows, tile_start, width, height):
        rows = rows.contiguous()
        out = composite_forward(rows, None, tile_start, width, height)
        ctx.save_for_backward(rows, tile_start, out)
        ctx.wh = (width, height)
        return out[:rows.shape[1] - 5]

    @staticmethod
    def backward(ctx, g):
        rows, tile_start, out = ctx.saved_tensors
        return (composite_backward(rows, None, tile_start, *ctx.wh, out, g.contiguous()),
                None, None, None)
