"""Loss and image-metric primitives.

Counterpart of splatam_tpu/core/losses.py (reference:
utils/slam_helpers.py:5-18, utils/slam_external.py:49-97). SSIM blurs with
two depthwise 1D convolutions of the 11-tap sigma-1.5 Gaussian window.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from splatam_tpu_torch.utils import spans


def l1_loss_v1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.abs(x - y).mean()


def calc_psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-channel PSNR, [C, H, W] inputs -> [C, 1]."""
    mse = ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(1, keepdim=True)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur_sep(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' blur of [C, H, W] with a separable 1D window."""
    c = img.shape[0]
    ws = window.shape[0]
    pad = ws // 2
    kh = window.reshape(1, 1, ws, 1).expand(c, 1, ws, 1)
    kw = window.reshape(1, 1, 1, ws).expand(c, 1, 1, ws)
    x = F.conv2d(img[None], kh, padding=(pad, 0), groups=c)
    x = F.conv2d(x, kw, padding=(0, pad), groups=c)
    return x[0]


def calc_ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              size_average: bool = True) -> torch.Tensor:
    """SSIM over [C, H, W] images in [0, 1]."""
    with spans.waited("loss.ssim_window"):  # a blocking upload
        window = torch.as_tensor(_gaussian_window(window_size, 1.5), device=img1.device)
    mu1 = _blur_sep(img1, window)
    mu2 = _blur_sep(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur_sep(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur_sep(img2 * img2, window) - mu2_sq
    sigma12 = _blur_sep(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2))


MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Multi-scale SSIM over [C, H, W] (5 scales, the standard weights, 2x2
    mean downsampling between scales). Counterpart of
    splatam_tpu/core/losses.py ms_ssim (reference: pytorch_msssim,
    utils/eval_helpers.py:19,482-483)."""
    weights = torch.tensor(MS_SSIM_WEIGHTS, dtype=torch.float32, device=img1.device)
    window = torch.as_tensor(_gaussian_window(11, 1.5), device=img1.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def ssim_and_cs(a, b):
        mu1, mu2 = _blur_sep(a, window), _blur_sep(b, window)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = _blur_sep(a * a, window) - mu1_sq
        s2 = _blur_sep(b * b, window) - mu2_sq
        s12 = _blur_sep(a * b, window) - mu1_mu2
        cs = (2 * s12 + c2) / (s1 + s2 + c2)
        ssim = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs
        return ssim.mean(), cs.mean()

    def downsample(x):
        c, h, w = x.shape
        h2, w2 = (h // 2) * 2, (w // 2) * 2
        return x[:, :h2, :w2].reshape(c, h2 // 2, 2, w2 // 2, 2).mean(dim=(2, 4))

    mcs = []
    a, b = img1, img2
    for i in range(5):
        ssim_val, cs = ssim_and_cs(a, b)
        mcs.append(cs)
        if i < 4:
            a, b = downsample(a), downsample(b)
    # The standard combination, with negative terms clamped at 0 (as the
    # reference package does).
    mcs = torch.clamp(torch.stack(mcs[:-1]), min=0.0)
    ssim_val = torch.clamp(ssim_val, min=0.0)
    return torch.prod(mcs ** weights[:-1]) * ssim_val ** weights[-1]
