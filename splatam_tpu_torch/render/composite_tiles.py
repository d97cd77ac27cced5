"""The tiles compositor: a chunked forward and an analytic backward in plain
PyTorch, the second reference of the kernels.

Counterpart of splatam_tpu/render/composite_jax.py (`composite_tiles`).
Compositing is sequential per pixel, but within a chunk of CHUNK
depth-ordered pairs of a tile the recurrences vectorise:

  * transmittance: T_c = T_in * cumprod(1 - alpha) (exclusive), so one
    cumprod gives the chunk's transmittances;
  * early termination: the "stop before T * (1 - alpha) < 1e-4" latch is a
    prefix OR (a cumsum of the terminate flags);
  * the backward's suffix accumulator S_c = a_c chan_c + (1 - a_c) S_{c+1},
    contracted with the cotangent first, becomes a scalar affine
    recurrence per pixel, run over the chunk's lanes back to front.

Every tile's list is its run of the sorted pairs (tile_start), padded to a
multiple of CHUNK: the lists are exact, so nothing is dropped and there is
no tile_k_max. The accumulators are [C, T, 256], the layout
composite.assemble_image crops to the image.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_tpu_torch.render.composite import ALPHA_MAX, ALPHA_MIN, PIX, T_EPS
from splatam_tpu_torch.render.projection import TILE

CHUNK = 32  # pairs per vectorised chunk


def tile_pixel_coords(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile pixel coordinates [T, 256] (x, y) as float32 numpy."""
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    ty, tx = np.mgrid[0:grid_y, 0:grid_x]
    ly, lx = np.mgrid[0:TILE, 0:TILE]
    px = tx[:, :, None, None] * TILE + lx[None, None]
    py = ty[:, :, None, None] * TILE + ly[None, None]
    t = grid_x * grid_y
    return px.reshape(t, PIX).astype(np.float32), py.reshape(t, PIX).astype(np.float32)


def tile_lists(pair_gauss: torch.Tensor, tile_start: torch.Tensor):
    """Per-tile Gaussian lists from the sorted pairs: (lists [T, K] int64,
    K the longest list rounded up to a multiple of CHUNK; entries past a
    tile's length repeat a valid index and are masked; lens [T])."""
    starts = tile_start[:-1].long()
    lens = tile_start[1:].long() - starts
    k = -(-int(lens.max()) // CHUNK) * CHUNK if lens.numel() else 0
    if pair_gauss.numel() == 0:
        return torch.zeros((lens.shape[0], k), dtype=torch.long, device=lens.device), lens
    idx = (starts[:, None] + torch.arange(k, device=lens.device)[None]).clamp(
        0, pair_gauss.shape[0] - 1)
    return pair_gauss.long()[idx], lens


def _chunk_alpha(xy, conic, opacity, g, m_k, ox, oy, px_loc, py_loc):
    """Per-(tile, lane, pixel) quantities of a chunk; g [T, C] Gaussian ids,
    m_k [T, C] the lanes inside their tile's list."""
    g_xy, g_con = xy[g], conic[g]
    g_opa = opacity[g][..., None]
    # tile-local coordinates keep the quadratic well conditioned in float32
    dx = (g_xy[..., 0:1] - ox[:, None]) - px_loc[:, None, :]
    dy = (g_xy[..., 1:2] - oy[:, None]) - py_loc[:, None, :]
    a, b, c = g_con[..., 0:1], g_con[..., 1:2], g_con[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    gval = torch.exp(power)
    alpha_un = g_opa * gval
    alpha = torch.clamp(alpha_un, max=ALPHA_MAX)
    skip = (power > 0.0) | (alpha < ALPHA_MIN) | ~m_k[..., None]
    return alpha, alpha_un, skip, gval, g_opa, dx, dy, a, b, c


def _frame(pixf_x, pixf_y):
    ox, oy = pixf_x[:, 0:1], pixf_y[:, 0:1]
    return ox, oy, pixf_x - ox, pixf_y - oy


def _forward(xy, conic, opacity, channels, lists, lens, pixf_x, pixf_y):
    """(acc [C, T, 256], T_final [T, 256], n_contrib [T, 256] int64)."""
    n_tiles, k_max = lists.shape
    device = xy.device
    ox, oy, px_loc, py_loc = _frame(pixf_x, pixf_y)
    col = torch.arange(CHUNK, device=device)
    t_cur = torch.ones((n_tiles, PIX), dtype=torch.float32, device=device)
    done = torch.zeros((n_tiles, PIX), dtype=torch.bool, device=device)
    n_contrib = torch.zeros((n_tiles, PIX), dtype=torch.long, device=device)
    acc = torch.zeros((channels.shape[1], n_tiles, PIX), dtype=torch.float32, device=device)
    for k0 in range(0, k_max, CHUNK):
        g = lists[:, k0:k0 + CHUNK]
        m_k = (k0 + col)[None, :] < lens[:, None]
        alpha, _, skip, *_ = _chunk_alpha(xy, conic, opacity, g, m_k, ox, oy, px_loc, py_loc)
        om = 1.0 - torch.where(skip, 0.0, alpha)
        cp = torch.cumprod(om, dim=1)
        cpe = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
        t_before = t_cur[:, None] * cpe  # [T, C, P]
        live = ~done[:, None]  # not terminated before this chunk
        term = ~skip & (t_before * om < T_EPS) & live
        term_before = (torch.cumsum(term.int(), dim=1) - term.int()) > 0
        applied = ~skip & live & ~term_before & ~term
        weight = torch.where(applied, alpha * t_before, 0.0)
        acc = acc + torch.einsum("tcp,tch->htp", weight, channels[g])
        t_cur = t_cur * torch.prod(torch.where(applied, om, 1.0), dim=1)
        done = done | term.any(1)
        kplus = torch.where(applied, (k0 + col + 1)[None, :, None], 0)
        n_contrib = torch.maximum(n_contrib, kplus.amax(1))
    return acc, t_cur, n_contrib


def _backward(xy, conic, opacity, channels, lists, lens, pixf_x, pixf_y, t_final, n_contrib,
              g_acc):
    """Cotangents of xy, conic, opacity and channels from g_acc [C, T, 256]:
    the chunks back to front, each pixel's transmittance divided back out
    and its suffix contracted with the cotangent."""
    n_tiles, k_max = lists.shape
    device = xy.device
    ox, oy, px_loc, py_loc = _frame(pixf_x, pixf_y)
    col = torch.arange(CHUNK, device=device)
    ch = channels.shape[1]
    d_all = torch.zeros((xy.shape[0], 6 + ch), dtype=torch.float32, device=device)
    t_end, v_end = t_final, torch.zeros_like(t_final)
    for k0 in range(k_max - CHUNK, -1, -CHUNK):
        g = lists[:, k0:k0 + CHUNK]
        m_k = (k0 + col)[None, :] < lens[:, None]
        alpha, alpha_un, skip, gval, g_opa, dx, dy, a, b, c = _chunk_alpha(
            xy, conic, opacity, g, m_k, ox, oy, px_loc, py_loc)
        applied = ~skip & ((k0 + col + 1)[None, :, None] <= n_contrib[:, None])
        om = torch.where(applied, 1.0 - alpha, 1.0)
        s = torch.flip(torch.cumprod(torch.flip(om, [1]), dim=1), [1])  # prod of om_j, j >= c
        t_before = t_end[:, None] / s  # exact where applied
        weight = torch.where(applied, alpha * t_before, 0.0)
        g_chan = channels[g]  # [T, C, ch]
        dchan = torch.einsum("tcp,htp->tch", weight, g_acc)
        u = torch.einsum("tch,htp->tcp", g_chan, g_acc)
        bvec = torch.where(applied, alpha * u, 0.0)
        # v_c = om_c v_{c+1} + bvec_c from the chunk's end back to its front
        v = v_end
        v_inc = torch.empty_like(u)
        for j in range(CHUNK - 1, -1, -1):
            v = om[:, j] * v + bvec[:, j]
            v_inc[:, j] = v
        v_next = torch.cat([v_inc[:, 1:], v_end[:, None]], dim=1)
        dalpha = torch.where(applied, (u - v_next) * t_before, 0.0)
        not_clamped = alpha_un <= ALPHA_MAX
        # inside the where: a skipped lane's exp(power) may be inf, and 0 * inf is NaN
        dpower = torch.where(not_clamped, g_opa * dalpha * gval, 0.0)
        rows = torch.stack([
            (dpower * -(a * dx + b * dy)).sum(2),
            (dpower * -(c * dy + b * dx)).sum(2),
            (dpower * (-0.5 * dx * dx)).sum(2),
            (dpower * (-dx * dy)).sum(2),
            (dpower * (-0.5 * dy * dy)).sum(2),
            torch.where(not_clamped, gval * dalpha, 0.0).sum(2),
        ], dim=-1)
        rows = torch.cat([rows, dchan], dim=-1).reshape(-1, 6 + ch)
        d_all.index_add_(0, g.reshape(-1), rows)
        t_end, v_end = t_end / s[:, 0], v_inc[:, 0]
    return d_all[:, 0:2], d_all[:, 2:5], d_all[:, 5], d_all[:, 6:]


class CompositeTiles(torch.autograd.Function):
    """Composite per-tile lists -> [C, T, 256] accumulators (black
    background); the backward is _backward's analytic one (the JAX
    package's custom VJP)."""

    @staticmethod
    def forward(ctx, xy, conic, opacity, channels, lists, lens, pixf_x, pixf_y):
        acc, t_final, n_contrib = _forward(xy, conic, opacity, channels, lists, lens, pixf_x,
                                           pixf_y)
        ctx.save_for_backward(xy, conic, opacity, channels, lists, lens, pixf_x, pixf_y,
                              t_final, n_contrib)
        return acc

    @staticmethod
    def backward(ctx, g_acc):
        d = _backward(*ctx.saved_tensors, g_acc.contiguous())
        return (*d, None, None, None, None)


def composite_tiles(xy, conic, opacity, channels, lists, lens, pixf_x, pixf_y) -> torch.Tensor:
    """Composite xy [N, 2], conic [N, 3], opacity [N] and channels [N, C]
    over per-tile lists [T, K] (K a multiple of CHUNK) of lengths lens [T]
    at pixel coordinates pixf_x, pixf_y [T, 256]: [C, T, 256]."""
    return CompositeTiles.apply(xy, conic, opacity, channels, lists, lens, pixf_x, pixf_y)
