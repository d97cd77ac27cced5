"""LPIPS (AlexNet) in PyTorch.

Counterpart of splatam_tpu/eval/lpips_jax.py (reference: torchmetrics'
LPIPS, utils/eval_helpers.py:20-21,484-485): the same AlexNet trunk,
shift/scale, channel normalisation and linear heads, as plain
`conv2d`/`max_pool2d` calls on the given device (the reference package runs
these convolutions outside any kernel of its own too).

Pretrained ImageNet weights are read from an .npz when one exists (the same
schema and the same file name as the reference package's). Without one, the
metric uses DETERMINISTIC SYNTHESIZED weights: `synthesize_weights` is a copy
of the reference package's (numpy `default_rng`), so both packages build
identical weights. Those values are NOT the canonical LPIPS calibration;
eval reports them under `lpips_synthetic`.

Weight npz format: alexnet conv kernels 'features.{0,3,6,8,10}.weight'
([out,in,kh,kw]) / '.bias', and LPIPS linear heads 'lin{0-4}.model.1.weight'
([1,C,1,1]).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

_ALEX_CFG = [
    # (key, out_ch, kernel, stride, padding)
    ("features.0", 64, 11, 4, 2),
    ("features.3", 192, 5, 1, 2),
    ("features.6", 384, 3, 1, 1),
    ("features.8", 256, 3, 1, 1),
    ("features.10", 256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}  # maxpool after first two conv stages
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# The reference package's file name, beside this module only: the port reads
# nothing outside its checkout unless a path is given.
DEFAULT_WEIGHT_PATHS = [os.path.join(os.path.dirname(__file__), "lpips_alex.npz")]


def synthesize_weights(seed: int = 0) -> dict:
    """Deterministic stand-in weights in the exact pretrained-npz schema.

    He-normal conv kernels / zero biases per AlexNet stage, and uniform
    positive linear heads normalized so lpips(x, x + small noise) lands in
    the same order of magnitude as the trained calibration.
    """
    rng = np.random.default_rng(seed)
    state = {"_synthetic": np.array(True)}
    in_ch = 3
    for key, out_ch, k, _, _ in _ALEX_CFG:
        fan_in = in_ch * k * k
        state[f"{key}.weight"] = (
            rng.normal(0.0, np.sqrt(2.0 / fan_in), (out_ch, in_ch, k, k))
        ).astype(np.float32)
        state[f"{key}.bias"] = np.zeros((out_ch,), np.float32)
        in_ch = out_ch
    for i, (_, out_ch, _, _, _) in enumerate(_ALEX_CFG):
        state[f"lin{i}.model.1.weight"] = (
            rng.uniform(0.0, 2.0 / out_ch, (1, out_ch, 1, 1))
        ).astype(np.float32)
    return state


def _load_weights(weights_path: str | None, allow_synthetic: bool = True):
    """Returns (weights dict, synthetic flag) or (None, False)."""
    paths = [weights_path] if weights_path else DEFAULT_WEIGHT_PATHS
    for p in paths:
        if p and os.path.exists(p):
            w = dict(np.load(p))
            return w, bool(w.get("_synthetic", False))
    if allow_synthetic:
        return synthesize_weights(), True
    return None, False


def _alex_features(weights: dict, x: torch.Tensor) -> list:
    """x: [N, 3, H, W] in [-1, 1] -> list of 5 feature maps."""
    x = (x - weights["_shift"]) / weights["_scale"]
    feats = []
    for i, (key, _, _, stride, pad) in enumerate(_ALEX_CFG):
        x = F.relu(F.conv2d(x, weights[f"{key}.weight"], weights[f"{key}.bias"],
                            stride=stride, padding=pad))
        feats.append(x)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x**2, dim=1, keepdim=True))
    return x / (norm + eps)


def lpips_fn(weights_path: str | None = None, allow_synthetic: bool = True,
             device="cuda"):
    """Returns lpips(img1, img2) over [3,H,W] images in [0,1] on `device`
    (with a `.synthetic` attribute), or None when pretrained weights are
    absent and `allow_synthetic` is False. The weights move to `device`
    once, here."""
    weights, synthetic = _load_weights(weights_path, allow_synthetic)
    if weights is None:
        return None
    device = torch.device(device)
    w = {k: torch.as_tensor(v, device=device) for k, v in weights.items() if k != "_synthetic"}
    w["_shift"] = torch.as_tensor(_SHIFT, device=device)[None, :, None, None]
    w["_scale"] = torch.as_tensor(_SCALE, device=device)[None, :, None, None]
    lins = [w[f"lin{i}.model.1.weight"][0, :, 0, 0][None, :, None, None]
            for i in range(len(_ALEX_CFG))]

    @torch.no_grad()
    def lpips(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        f1 = _alex_features(w, img1[None] * 2.0 - 1.0)
        f2 = _alex_features(w, img2[None] * 2.0 - 1.0)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for a, b, lin in zip(f1, f2, lins):
            d = (_normalize_tensor(a) - _normalize_tensor(b)) ** 2
            total = total + torch.mean(torch.sum(d * lin, dim=1))
        return total

    lpips.synthetic = synthetic
    return lpips
