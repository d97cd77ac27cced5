"""Naive compositor, the semantic oracle: O(N x H x W), differentiable by
autograd.

Counterpart of splatam_tpu/render/naive.py. Every visible Gaussian in
stable depth order is evaluated at every pixel of the image under the
reference rasterizer's per-pixel rules (power > 0 skip, alpha < 1/255
skip, the 0.99 alpha clamp, stop before T * (1 - alpha) < 1e-4,
tile-rectangle membership). It shares no code with the kernels' walk:
no pair lists, no tiles, no per-tile order. A Python loop over Gaussians,
each step vectorised over the pixels, so it is for tests and small
renders only.
"""
from __future__ import annotations

import torch

from splatam_tpu_torch.render.projection import TILE, Projected, ProjectedAux

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def composite_naive(proj: Projected, aux: ProjectedAux, channels: torch.Tensor, width: int,
                    height: int) -> torch.Tensor:
    """The composited image [C, H, W] (black background) of channels [N, C]."""
    device, dtype = channels.device, channels.dtype
    visible = aux.visible
    key = torch.where(visible, proj.depth.detach(), torch.full_like(proj.depth, float("inf")))
    order = torch.argsort(key, stable=True)[:int(visible.sum())]  # invisible ones sort last
    xy, conic = proj.xy[order], proj.conic[order]
    opacity, chan = proj.opacity[order], channels[order]
    rect_min, rect_wh = aux.rect_min[order], aux.rect_wh[order]
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    pix_x, pix_y = xs.to(dtype), ys.to(dtype)
    tile_x, tile_y = xs // TILE, ys // TILE
    t_cur = torch.ones((height, width), dtype=dtype, device=device)
    done = torch.zeros((height, width), dtype=torch.bool, device=device)
    acc = torch.zeros((channels.shape[1], height, width), dtype=dtype, device=device)
    for i in range(order.shape[0]):
        rmin, rwh = rect_min[i], rect_wh[i]
        in_rect = ((tile_x >= rmin[0]) & (tile_x < rmin[0] + rwh[0])
                   & (tile_y >= rmin[1]) & (tile_y < rmin[1] + rwh[1]))
        dx = xy[i, 0] - pix_x
        dy = xy[i, 1] - pix_y
        a, b, c = conic[i, 0], conic[i, 1], conic[i, 2]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(opacity[i] * torch.exp(power), max=ALPHA_MAX)
        consider = in_rect & (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done
        test_t = t_cur * (1.0 - alpha)
        terminate = consider & (test_t < T_EPS)
        apply = consider & ~terminate
        w = torch.where(apply, alpha * t_cur, 0.0)
        acc = acc + chan[i][:, None, None] * w[None]
        t_cur = torch.where(apply, test_t, t_cur)
        done = done | terminate
    return acc
