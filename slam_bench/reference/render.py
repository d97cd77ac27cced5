"""Plain PyTorch splatting of an isotropic Gaussian map: projection, tile
binning and front-to-back compositing, differentiable by autograd.

Written from the reference rasterizer's rules (SplaTAM's
diff-gaussian-rasterization, renderCUDA) and the binding semantics the
port's ROADMAP states, not from the port's code, and importing nothing of
it:
  * EWA projection through the NDC pipeline (ndc2Pix), the 1.3 tan(fov)
    clamp of the Jacobian, the +0.3 dilation of the 2D covariance;
  * each Gaussian's tile rectangle from its alpha-cutoff ellipse, and one
    pair per tile of it;
  * within a tile, pairs in (log-quantized depth, Gaussian index) order;
  * per pixel: skip a pair when power > 0 or alpha < 1/255, clamp alpha at
    0.99, stop before the pair for which T (1 - alpha) < 1e-4;
    silhouette = 1 - T_final.

Compositing runs tile by tile over chunks of tiles, each a dense
[tiles, 256 pixels, K pairs] block, so it fits at 1200x680 with a million
Gaussians. `composite` gives the image without gradients; `backprop`
recomputes each chunk with autograd and pushes the image's cotangent
through it, so the map or the pose gets its gradient chunk by chunk.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

TILE = 16
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
NEAR = 0.2  # the in-frustum test: camera-frame z > 0.2
FAR = 100.0  # far end of the depth key
CHUNK_ELEMENTS = 1 << 25  # tiles x 256 x K per compositing chunk


class Intrinsics(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class Screen(NamedTuple):
    """Per-Gaussian (or per-pair) screen-space quantities."""

    xy: torch.Tensor  # [..., 2] pixel-space mean
    conic: torch.Tensor  # [..., 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # [...]
    depth: torch.Tensor  # [...] camera-frame z
    cov_diag: torch.Tensor  # [..., 2] 2D covariance diagonal (for the tile rectangle)
    ok: torch.Tensor  # [...] bool: in front of the near plane, invertible covariance


class Bins(NamedTuple):
    pair_gauss: torch.Tensor  # [P] int64 Gaussian of each sorted pair
    tile_start: torch.Tensor  # [T + 1] int64 first pair of each tile


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[3, 3] rotation of a wxyz quaternion (normalized first)."""
    w, x, y, z = (q / torch.linalg.vector_norm(q)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def project(means_w: torch.Tensor, s2: torch.Tensor, opacity: torch.Tensor,
            rot: torch.Tensor, trans: torch.Tensor, k: Intrinsics) -> Screen:
    """EWA projection of isotropic Gaussians (3D covariance s2 I) seen from
    the world-to-camera pose (rot, trans); any leading shape."""
    p = means_w @ rot.T + trans
    px, py, tz = p.unbind(-1)
    ok_z = tz > NEAR
    z = torch.where(ok_z, tz, torch.ones_like(tz))
    w, h = k.width, k.height
    p_w = 1.0 / (z + 1e-7)
    x_ndc = (2.0 * k.fx / w * px - (w - 2.0 * k.cx) / w * z) * p_w
    y_ndc = (2.0 * k.fy / h * py - (h - 2.0 * k.cy) / h * z) * p_w
    xy = torch.stack([((x_ndc + 1.0) * w - 1.0) * 0.5, ((y_ndc + 1.0) * h - 1.0) * 0.5], -1)
    lim_x, lim_y = 1.3 * w / (2.0 * k.fx), 1.3 * h / (2.0 * k.fy)
    tx = torch.clamp(px / z, -lim_x, lim_x) * z
    ty = torch.clamp(py / z, -lim_y, lim_y) * z
    j00, j11 = k.fx / z, k.fy / z
    j02, j12 = -k.fx * tx / (z * z), -k.fy * ty / (z * z)
    # J (s2 I) J^T + 0.3 I: the rotation of the view leaves s2 I unchanged
    c00 = s2 * (j00 * j00 + j02 * j02) + 0.3
    c01 = s2 * (j02 * j12)
    c11 = s2 * (j11 * j11 + j12 * j12) + 0.3
    det = c00 * c11 - c01 * c01
    ok_det = det != 0.0
    inv = 1.0 / torch.where(ok_det, det, torch.ones_like(det))
    conic = torch.stack([c11 * inv, -c01 * inv, c00 * inv], -1)
    return Screen(xy, conic, opacity, tz, torch.stack([c00, c11], -1), ok_z & ok_det)


def grid(k: Intrinsics) -> tuple[int, int]:
    return (k.width + TILE - 1) // TILE, (k.height + TILE - 1) // TILE


def depth_key_bits(num_tiles: int) -> int:
    """Bits of the depth key under the tile id in a 31-bit key, at most 22."""
    return min(31 - max(1, math.ceil(math.log2(num_tiles + 2))), 22)


def build_bins(s: Screen, active: torch.Tensor, k: Intrinsics) -> Bins:
    """One pair per tile of each visible Gaussian's rectangle, sorted by
    (tile, quantized depth); ties keep Gaussian order, then row-major tile
    order within the rectangle."""
    gx, gy = grid(k)
    with torch.no_grad():
        cut = torch.clamp(2.0 * torch.log(255.0 * torch.clamp(s.opacity, min=1e-12)), 0.0, 9.0)
        r = torch.ceil(torch.sqrt(cut[:, None] * torch.clamp(s.cov_diag, min=0.0)))
        lo = ((s.xy - r) / TILE).to(torch.int64)  # C-style truncation
        hi = ((s.xy + r + TILE - 1) / TILE).to(torch.int64)
        lim = torch.tensor([gx, gy], device=lo.device)
        lo = torch.minimum(torch.clamp(lo, min=0), lim)
        hi = torch.minimum(torch.clamp(hi, min=0), lim)
        wh = torch.clamp(hi - lo, min=0)
        n_tiles = wh[:, 0] * wh[:, 1]
        visible = active & s.ok & (n_tiles > 0)
        counts = torch.where(visible, n_tiles, torch.zeros_like(n_tiles))
        total = int(counts.sum())
        g = torch.repeat_interleave(torch.arange(counts.shape[0], device=lo.device), counts,
                                    output_size=total)
        j = torch.arange(total, device=lo.device) - (torch.cumsum(counts, 0) - counts)[g]
        rw = torch.clamp(wh[g, 0], min=1)
        tile = (lo[g, 1] + j // rw) * gx + lo[g, 0] + j % rw
        bits = depth_key_bits(gx * gy)
        qmax = (1 << bits) - 1
        z = torch.clamp(s.depth, NEAR, FAR)
        q = torch.clamp((torch.log(z / NEAR) / math.log(FAR / NEAR) * qmax).to(torch.int64),
                        0, qmax)
        key = (tile << bits) | q[g]
        order = torch.sort(key, stable=True).indices
        starts = torch.searchsorted(key[order], torch.arange(gx * gy + 1, device=lo.device)
                                    << bits)
    return Bins(g[order], starts)


def _chunks(bins: Bins):
    """Groups of non-empty tiles of similar length: (tile ids, K) each, each
    at most CHUNK_ELEMENTS (or one tile) large."""
    budget = CHUNK_ELEMENTS
    lens = bins.tile_start[1:] - bins.tile_start[:-1]
    order = torch.argsort(lens, descending=True, stable=True)
    sorted_lens = lens[order].tolist()
    out, i = [], 0
    while i < len(sorted_lens) and sorted_lens[i] > 0:
        kmax = sorted_lens[i]
        n = max(1, min(budget // (PIX * kmax), len(sorted_lens) - i))
        while n > 1 and sorted_lens[i + n - 1] == 0:
            n -= 1
        out.append((order[i:i + n], kmax))
        i += n
    return out


RowsFn = Callable[[torch.Tensor], tuple]


def _chunk(bins: Bins, rows: RowsFn, k: Intrinsics, tiles: torch.Tensor, kmax: int):
    """Composite one chunk of tiles: (channels [n, 256, C], silhouette
    [n, 256], contributing evaluations, pixel index [n, 256] into H*W, pixel
    inside the image [n, 256]). rows(pair indices [n, K]) gives the pairs'
    (xy, conic, opacity, channels), differentiable where the caller wants it."""
    dev = bins.tile_start.device
    gx, _ = grid(k)
    start = bins.tile_start[tiles]
    length = bins.tile_start[tiles + 1] - start
    kk = torch.arange(kmax, device=dev)
    in_list = kk[None] < length[:, None]
    pidx = torch.where(in_list, start[:, None] + kk[None], torch.zeros_like(kk[None]))
    xy, conic, opacity, chans = rows(pidx)
    lane = torch.arange(PIX, device=dev)
    px = (tiles[:, None] % gx) * TILE + lane[None] % TILE
    py = (tiles[:, None] // gx) * TILE + lane[None] // TILE
    dx = xy[:, None, :, 0] - px[:, :, None].to(xy.dtype)
    dy = xy[:, None, :, 1] - py[:, :, None].to(xy.dtype)
    a, b, c = (conic[:, None, :, i] for i in range(3))
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    # a positive definite conic keeps power <= 0; the clamp only keeps a
    # skipped pair's exp finite, so its zero gradient stays zero
    alpha = torch.clamp(opacity[:, None, :] * torch.exp(torch.clamp(power, max=0.0)),
                        max=ALPHA_MAX)
    with torch.no_grad():
        considered = in_list[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        t_run = torch.cumprod(torch.where(considered, 1.0 - alpha, 1.0), dim=-1)
        contrib = considered & (t_run >= T_EPS)
    a_c = torch.where(contrib, alpha, torch.zeros_like(alpha))
    t_incl = torch.cumprod(1.0 - a_c, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], dim=-1)
    out = torch.bmm(a_c * t_excl, chans)
    sil = 1.0 - t_incl[..., -1]
    inside = (px < k.width) & (py < k.height)
    return out, sil, int(contrib.sum()), py * k.width + px, inside


def composite(bins: Bins, rows: RowsFn, k: Intrinsics, channels: int):
    """Image [channels + 1, H, W] (the channels, then the silhouette) and the
    number of contributing (pixel, pair) evaluations; no gradients."""
    dev = bins.tile_start.device
    img = torch.zeros((channels + 1, k.height * k.width), device=dev)
    n_contrib = 0
    with torch.no_grad():
        for tiles, kmax in _chunks(bins):
            out, sil, n, pix, inside = _chunk(bins, rows, k, tiles, kmax)
            n_contrib += n
            vals = torch.cat([out, sil[..., None]], dim=-1)[inside]
            img[:, pix[inside]] = vals.T
    return img.reshape(channels + 1, k.height, k.width), n_contrib


def contributing(bins: Bins, rows: RowsFn, k: Intrinsics) -> int:
    """The contributing (pixel, pair) evaluations of a render, counted
    without forming its image."""
    n_contrib = 0
    with torch.no_grad():
        for tiles, kmax in _chunks(bins):
            n_contrib += _chunk(bins, rows, k, tiles, kmax)[2]
    return n_contrib


def backprop(bins: Bins, rows: RowsFn, k: Intrinsics, grad_img: torch.Tensor) -> None:
    """Push grad_img [C + 1, H, W] (the cotangent of composite's image)
    through the render, chunk by chunk: the leaves behind `rows` accumulate
    their .grad."""
    g = grad_img.reshape(grad_img.shape[0], -1)
    for tiles, kmax in _chunks(bins):
        out, sil, _, pix, inside = _chunk(bins, rows, k, tiles, kmax)
        vals = torch.cat([out, sil[..., None]], dim=-1)
        gv = torch.where(inside[..., None], g[:, pix.clamp(max=g.shape[1] - 1)].permute(1, 2, 0),
                         torch.zeros((), device=g.device))
        # the chunks share the caller's graph above the rows (the pose's
        # rotation, the scales' squares), so it is kept until the last chunk
        torch.autograd.backward(vals, gv, retain_graph=True)
