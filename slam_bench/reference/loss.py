"""SplaTAM's tracking and mapping losses in plain PyTorch (upstream
scripts/splatam.py get_loss, utils/slam_external.py calc_ssim), on a render
[r, g, b, z, z^2, silhouette]."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class LossConfig(NamedTuple):
    use_sil_for_loss: bool
    sil_thres: float
    w_im: float
    w_depth: float

    @classmethod
    def from_section(cls, section: dict) -> "LossConfig":
        """A tracking or mapping section of an experiment config. The
        options the benchmark's configurations leave at their defaults
        (ignore_outlier_depth_loss, use_l1 off, depth uncertainty) are
        refused, not silently skipped."""
        if section.get("ignore_outlier_depth_loss") or not section.get("use_l1", True):
            raise ValueError("the reference loss covers use_l1 and no outlier rejection")
        if float(section.get("depth_uncertainty_thres", 0.0)) > 0.0:
            raise ValueError("the reference loss has no depth-uncertainty mask")
        return cls(bool(section["use_sil_for_loss"]), float(section["sil_thres"]),
                   float(section["loss_weights"]["im"]), float(section["loss_weights"]["depth"]))


def _window(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    g = torch.tensor([math.exp(-(x - size // 2) ** 2 / (2.0 * sigma ** 2)) for x in range(size)],
                     dtype=torch.float64, device=device)
    g = (g / g.sum())[:, None]
    return g @ g.T


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of [C, H, W] images (11x11 Gaussian window, sigma 1.5)."""
    c = img1.shape[0]
    win = _window(device=img1.device).to(img1.dtype).expand(c, 1, 11, 11).contiguous()

    def blur(x):
        return F.conv2d(x[None], win, padding=5, groups=c)[0]

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu12 + c1) * (2 * s12 + c2))
            / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))).mean()


def loss(img: torch.Tensor, color: torch.Tensor, depth_gt: torch.Tensor, cfg: LossConfig,
         tracking: bool) -> torch.Tensor:
    """get_loss of a render img [6, H, W] against the frame (color [3, H, W]
    in [0, 1], depth_gt [H, W] in metres)."""
    im, depth, depth_sq, sil = img[:3], img[3], img[4], img[5]
    uncertainty = (depth_sq - depth * depth).detach()
    mask = (depth_gt > 0) & ~torch.isnan(depth) & ~torch.isnan(uncertainty)
    if tracking and cfg.use_sil_for_loss:
        mask = mask & (sil > cfg.sil_thres)
    mask = mask.detach()
    if tracking:
        depth_loss = torch.abs(depth_gt - depth)[mask].sum()
        im_loss = torch.abs(color - im)[:, mask].sum()
    else:
        depth_loss = torch.abs(depth_gt - depth)[mask].sum() / max(int(mask.sum()), 1)
        im_loss = 0.8 * torch.abs(im - color).mean() + 0.2 * (1.0 - ssim(im, color))
    return cfg.w_depth * depth_loss + cfg.w_im * im_loss


def loss_and_cotangent(img: torch.Tensor, color, depth_gt, cfg: LossConfig, tracking: bool):
    """(loss value, d loss / d img) of a render computed without autograd.
    The loss is taken in float64, so the reference's own rounding (the
    SSIM's variances are differences of near-equal blurs) stays far below
    the program's; the cotangent goes back in the render's float32."""
    leaf = img.detach().double().requires_grad_(True)
    with torch.enable_grad():
        value = loss(leaf, color.double(), depth_gt.double(), cfg, tracking)
        (grad,) = torch.autograd.grad(value, leaf)
    return float(value.detach()), grad.to(img.dtype)
