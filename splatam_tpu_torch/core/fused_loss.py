"""get_loss's loss after the render as one hand-written kernel, with its
gradient in closed form (csrc/loss.cu).

The kernel computes the loss value and, in the same pass, the gradient
planes with respect to the rendered image [3, H, W] and depth [H, W]:
the three image planes final, the depth plane as -sign(gt - d) * mask,
which the backward scales by a device scalar (w_depth in tracking,
w_depth / max(mask count, 1) in mapping) from the reduction, so no host
read. `FusedLoss` keeps only those planes (4 x H x W floats) for the
backward, where autograd of the PyTorch composition (loss_composition,
the CPU's route) kept SSIM's intermediates.

loss_terms_plain is the same closed form in plain PyTorch (any float
dtype): the wrapper takes it for CPU tensors, and the tests hold it to
autograd of the composition.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatam_tpu_torch.core.losses import _blur_sep, _gaussian_window, calc_ssim
from splatam_tpu_torch.render import _cuda

TILE_W, TILE_H = 32, 16  # csrc/loss.cu LT_W, LT_H
PARTS = 4  # partials a block writes (csrc/loss.cu LOSS_PARTS)
SSIM_C1, SSIM_C2 = 0.01**2, 0.03**2


class LossRoute(NamedTuple):
    """The kernel's scalar arguments: a phase's PhaseConfig fields on its route."""

    mapping: bool
    use_sil: bool  # tracking's `silhouette > sil_thres` in the mask
    use_unc: bool  # depth_unc_thres > 0
    masked_im: bool  # tracking's image term under the mask
    sil_thres: float
    unc_thres_sq: float
    w_im: float
    w_depth: float


def route(pcfg, tracking: bool) -> LossRoute:
    """LossRoute of a PhaseConfig (slam/steps.py) in tracking or mapping."""
    use_sil = tracking and pcfg.use_sil_for_loss
    return LossRoute(
        mapping=not tracking, use_sil=use_sil, use_unc=pcfg.depth_unc_thres > 0.0,
        masked_im=tracking and (pcfg.use_sil_for_loss or pcfg.ignore_outlier_depth_loss),
        sil_thres=pcfg.sil_thres, unc_thres_sq=pcfg.depth_unc_thres**2, w_im=pcfg.w_im,
        w_depth=pcfg.w_depth)


def grid_blocks(mapping: bool, h: int, w: int) -> int:
    """Blocks of the tile kernel's grid (csrc/loss.cu loss_grid)."""
    return -(-w // TILE_W) * -(-h // TILE_H) * (3 if mapping else 1)


def pixel_mask(depth, depth_sq, sil, depth_gt, r: LossRoute, thresh=None):
    """get_loss's depth mask [H, W] (bool); thresh: the outlier threshold, a
    device scalar, or None for no outlier test."""
    valid = depth_gt > 0
    mask = valid
    if thresh is not None:
        mask = (torch.abs(depth_gt - depth) * valid < thresh) & valid
    mask = mask & ~torch.isnan(depth) & ~torch.isnan(depth_sq - depth * depth)
    if r.use_sil:
        mask = mask & (sil > r.sil_thres)
    if r.use_unc:
        s = torch.clamp(sil, min=1e-6)
        mask = mask & (depth_sq / s - (depth / s) ** 2 < r.unc_thres_sq)
    return mask


def loss_composition(im, depth, depth_sq, sil, color, depth_gt, r: LossRoute, thresh=None):
    """get_loss's (loss, weighted depth loss, weighted image loss) as PyTorch
    ops, differentiable through autograd (reference: scripts/splatam.py
    get_loss :214-347)."""
    mask = pixel_mask(depth.detach(), depth_sq.detach(), sil.detach(), depth_gt, r, thresh)
    if not r.mapping:
        depth_loss = torch.sum(torch.abs(depth_gt - depth) * mask)
    else:
        cnt = torch.clamp(mask.sum(), min=1)
        depth_loss = torch.sum(torch.abs(depth_gt - depth) * mask) / cnt
    if not r.mapping and r.masked_im:
        im_loss = torch.sum(torch.abs(color - im) * mask[None])
    elif not r.mapping:
        im_loss = torch.sum(torch.abs(color - im))
    else:
        im_loss = 0.8 * torch.abs(im - color).mean() + 0.2 * (1.0 - calc_ssim(im, color))
    w_depth = r.w_depth * depth_loss
    w_im = r.w_im * im_loss
    return w_depth + w_im, w_depth, w_im


def loss_terms_plain(im, depth, depth_sq, sil, color, depth_gt, r: LossRoute, thresh=None):
    """The kernel's closed form: (res [4] = (loss, w_depth * depth loss,
    w_im * image loss, mask count), grad [4, H, W] (d loss / d im, then
    -sign(gt - d) * mask), gscale [4, 1, 1] (1, 1, 1, the depth plane's
    scale)), in the inputs' dtype."""
    m = pixel_mask(depth, depth_sq, sil, depth_gt, r, thresh).to(depth.dtype)
    e = depth_gt - depth
    dsum, cnt = torch.sum(torch.abs(e) * m), m.sum()
    d_unit = -(torch.sign(e) * m)
    ei = color - im
    if not r.mapping:
        mi = m if r.masked_im else torch.ones_like(m)
        depth_loss, im_loss, dscale = dsum, torch.sum(torch.abs(ei) * mi), r.w_depth
        g_im = -(torch.sign(ei) * (r.w_im * mi))
    else:
        c = torch.clamp(cnt, min=1.0)
        n = im.numel()
        s, g_ssim = _ssim_and_grad(im, color, -((r.w_im * 0.2) / n))
        depth_loss = dsum / c
        im_loss = 0.8 * torch.abs(im - color).mean() + 0.2 * (1.0 - s.mean())
        dscale = r.w_depth / c
        g_im = g_ssim + ((r.w_im * 0.8) / n) * torch.sign(im - color)
    wd, wi = r.w_depth * depth_loss, r.w_im * im_loss
    res = torch.stack([wd + wi, wd, wi, cnt])
    one = torch.ones((), dtype=depth.dtype, device=depth.device)
    gscale = torch.stack([one, one, one, one * dscale]).reshape(4, 1, 1)
    return res, torch.cat([g_im, d_unit[None]]), gscale


def _ssim_and_grad(x, y, k: float):
    """SSIM's map S [C, H, W] of x against y, and k * dS.mean()/dx * numel:
    b(A) + 2 x b(B) + y b(C) from the five blurred moments (b: the 11-tap
    separable blur with zero padding, its own transpose)."""
    win = torch.as_tensor(_gaussian_window(11, 1.5), device=x.device).to(x.dtype)
    mu1, mu2 = _blur_sep(x, win), _blur_sep(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur_sep(x * x, win) - mu1_sq
    s2 = _blur_sep(y * y, win) - mu2_sq
    s12 = _blur_sep(x * y, win) - mu1_mu2
    a1, a2 = 2 * mu1_mu2 + SSIM_C1, 2 * s12 + SSIM_C2
    b1, b2 = mu1_sq + mu2_sq + SSIM_C1, s1 + s2 + SSIM_C2
    den = b1 * b2
    s = (a1 * a2) / den
    ga = k * (2.0 * (mu2 * (a2 - a1) - mu1 * s * (b2 - b1)) / den)
    gb = k * (-s / b2)
    gc = k * (2.0 * a1 / den)
    return s, _blur_sep(ga, win) + 2.0 * x * _blur_sep(gb, win) + y * _blur_sep(gc, win)


def loss_terms(im, depth, depth_sq, sil, color, depth_gt, r: LossRoute, thresh=None):
    """Kernel wrapper of loss_terms_plain: two launches on CUDA tensors (the
    tiles, then the reduction of their partials); CPU tensors take the plain
    version. im, depth, depth_sq and sil are read as contiguous planes,
    color [3, H, W] and depth_gt [H, W] at any strides."""
    if not im.is_cuda:
        return loss_terms_plain(im, depth, depth_sq, sil, color, depth_gt, r, thresh)
    h, w = depth.shape
    im, depth, depth_sq, sil = (x.contiguous() for x in (im, depth, depth_sq, sil))
    _cuda.require(im, "im", torch.float32, (3, h, w))
    for name, x in (("depth", depth), ("depth_sq", depth_sq), ("silhouette", sil)):
        _cuda.require(x, name, torch.float32, (h, w))
    for name, x, shape in (("color", color, (3, h, w)), ("depth_gt", depth_gt, (h, w))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected a float32 tensor of shape {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if thresh is not None:
        _cuda.require(thresh, "thresh", torch.float32, ())
    for name, x in (("depth", depth), ("depth_sq", depth_sq), ("silhouette", sil),
                    ("color", color), ("depth_gt", depth_gt), ("thresh", thresh)):
        if x is not None and x.device != im.device:
            raise ValueError(f"{name}: expected a tensor on {im.device}, got {x.device}")
    nb = grid_blocks(r.mapping, h, w)
    grad = torch.empty((4, h, w), dtype=torch.float32, device=im.device)
    scratch = torch.empty((8 + nb * PARTS,), dtype=torch.float32, device=im.device)
    res, gscale, partials = scratch[:4], scratch[4:8], scratch[8:]
    _cuda.launch(im, "loss_forward", int(r.mapping), im.data_ptr(), depth.data_ptr(),
                 depth_sq.data_ptr(), sil.data_ptr(), color.data_ptr(), *color.stride(),
                 depth_gt.data_ptr(), *depth_gt.stride(),
                 None if thresh is None else thresh.data_ptr(), h, w, int(r.use_sil),
                 int(r.use_unc), int(r.masked_im), r.sil_thres, r.unc_thres_sq, r.w_im,
                 r.w_depth, grad.data_ptr(), partials.data_ptr(), partials.numel(),
                 res.data_ptr(), gscale.data_ptr())
    loss_terms.launches["map" if r.mapping else "track"] += 2
    return res, grad, gscale.reshape(4, 1, 1)


loss_terms.launches = {"track": 0, "map": 0}  # launches of each route's two kernels


class FusedLoss(torch.autograd.Function):
    """(loss, w_depth * depth loss, w_im * image loss) of a render's planes;
    gradients flow to im and depth only (depth_sq and the silhouette enter
    the mask, which is constant). Keeps the gradient planes and their scales
    for the backward, nothing else."""

    @staticmethod
    def forward(ctx, im, depth, depth_sq, sil, color, depth_gt, r, thresh):
        res, grad, gscale = loss_terms(im, depth, depth_sq, sil, color, depth_gt, r, thresh)
        ctx.save_for_backward(grad, gscale)
        wd, wi = res[1], res[2]
        ctx.mark_non_differentiable(wd, wi)
        return res[0], wd, wi

    @staticmethod
    def backward(ctx, g, _g_wd, _g_wi):
        grad, gscale = ctx.saved_tensors
        scaled = grad * (gscale * g)
        return scaled[:3], scaled[3], None, None, None, None, None, None


def fused_loss(im, depth, depth_sq, sil, color, depth_gt, r: LossRoute, thresh=None):
    """get_loss's (loss, weighted depth loss, weighted image loss) through
    FusedLoss."""
    return FusedLoss.apply(im, depth, depth_sq.detach(), sil.detach(), color, depth_gt, r,
                           thresh)
