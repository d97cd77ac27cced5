"""get_loss's loss in closed form (core/fused_loss.py), on the CPU.

The closed form (loss_terms_plain: the value, and the gradient planes
with respect to the rendered image and depth, SSIM's from its five
blurred moments) is the kernel's algorithm in plain PyTorch (csrc/loss.cu)
and the wrapper's plain version. It is held in float64 to torch.autograd
of get_loss's PyTorch composition (fused_loss.loss_composition) on
replica_bench's tracking and mapping phases and with each mask option on,
at 1200x680, 640x480 and 37x53 (odd and smaller than a 32x16 tile, so the
zero-padded borders are in every tile), with depth_gt == 0 pixels, a NaN
depth pixel and an all-masked depth: value within 1e-10 relative, each
gradient plane within 1e-10 of its own largest |value| (float64 sums in
another order). get_loss on the CPU must still compute what its
composition computed before the kernel existed, bit for bit.
"""
import ctypes
import json
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from splatam_tpu_torch.core import fused_loss, losses
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.render import _cuda, api
from splatam_tpu_torch.slam import pipeline, steps

ROOT = Path(__file__).resolve().parents[1]
SIZES = [(680, 1200), (480, 640), (37, 53)]


def _replica_bench_phase(name: str) -> steps.PhaseConfig:
    config = json.loads((ROOT / "slam_bench" / "configs" / "replica_bench.json").read_text())
    return pipeline._phase_cfg(config["experiment"][name])


# Each case's PhaseConfig, from replica_bench's: as configured, then with
# use_sil_for_loss flipped, depth_unc_thres > 0, and ignore_outlier_depth_loss
# on (without and with its floor).
OPTIONS = {
    "replica_bench": {},
    "sil_flipped": None,
    "depth_unc": {"depth_unc_thres": 0.07},
    "outlier": {"ignore_outlier_depth_loss": True},
    "outlier_floor": {"ignore_outlier_depth_loss": True, "outlier_floor": 0.2},
}


def _pcfg(tracking: bool, option: str) -> steps.PhaseConfig:
    base = _replica_bench_phase("tracking" if tracking else "mapping")
    if option == "sil_flipped":
        return replace(base, use_sil_for_loss=not base.use_sil_for_loss)
    return replace(base, **OPTIONS[option])


def _frame(h: int, w: int, seed: int, dtype=torch.float64, case: str = "plain"):
    """A render img [6, H, W] (rgb, depth, depth^2 + a variance, silhouette)
    and a frame (color, depth_gt) near it: depth_gt == 0 at ~10% of the
    pixels, outliers at ~2%, silhouettes both sides of 0.99 and 0.5."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float64)

    color = rand(3, h, w)
    im = torch.clamp(color + 0.2 * (rand(3, h, w) - 0.5), 0.0, 1.0)
    depth = 1.0 + 3.0 * rand(h, w)
    depth_sq = depth * depth + 0.01 * rand(h, w)
    sil = torch.where(rand(h, w) < 0.5, 1.0 - 0.02 * rand(h, w), rand(h, w))
    depth_gt = depth + 0.05 * (rand(h, w) - 0.5)
    depth_gt = torch.where(rand(h, w) < 0.02, depth_gt + 5.0, depth_gt)
    depth_gt = torch.where(rand(h, w) < 0.1, 0.0, depth_gt)
    if case == "nan_depth":
        depth[h // 2, w // 3] = float("nan")
    elif case == "all_masked":
        depth_gt = torch.zeros_like(depth_gt)
    img = torch.cat([im, depth[None], depth_sq[None], sil[None]])
    return img.to(dtype), color.to(dtype), depth_gt.to(dtype)


def _out(img) -> api.RenderOutput:
    return api.RenderOutput(im=img[:3], depth=img[3], silhouette=img[5], depth_sq=img[4],
                            radii=torch.zeros(1, dtype=torch.int32), n_pairs=0)


@pytest.fixture
def float64_window(monkeypatch):
    """calc_ssim's window in float64, so the composition runs in float64
    (conv2d takes one dtype)."""
    window = losses._gaussian_window
    monkeypatch.setattr(losses, "_gaussian_window",
                        lambda n, s: window(n, s).astype(np.float64))


def _threshold(img, depth_gt, pcfg):
    if not pcfg.ignore_outlier_depth_loss:
        return None
    return steps._outlier_thresh(img[3], depth_gt, pcfg)


def _autograd_reference(img, color, depth_gt, pcfg, tracking, scale=1.0):
    x = img.clone().requires_grad_(True)
    loss, wd, wi = fused_loss.loss_composition(x[:3], x[3], x[4], x[5], color, depth_gt,
                                               fused_loss.route(pcfg, tracking),
                                               _threshold(img, depth_gt, pcfg))
    (g,) = torch.autograd.grad(scale * loss, x)
    return loss.detach(), wd.detach(), wi.detach(), g


def _close(got, ref, rel: float) -> None:
    """Equal NaNs, else |got - ref| within rel of max |ref|."""
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    if ok.any():
        assert float((got[ok] - ref[ok]).abs().max()) <= rel * float(ref[ok].abs().max())


def _check_closed_form(img, color, depth_gt, pcfg, tracking):
    loss, wd, wi, g = _autograd_reference(img, color, depth_gt, pcfg, tracking)
    r = fused_loss.route(pcfg, tracking)
    res, grad, gscale = fused_loss.loss_terms_plain(
        img[:3], img[3], img[4], img[5], color, depth_gt, r, _threshold(img, depth_gt, pcfg))
    for got, ref in zip(res[:3], (loss, wd, wi)):
        _close(got.reshape(1), ref.reshape(1), 1e-10)
    mask = fused_loss.pixel_mask(img[3], img[4], img[5], depth_gt, r,
                                 _threshold(img, depth_gt, pcfg))
    assert float(res[3]) == float(mask.sum())
    scaled = grad * gscale
    for plane in range(4):
        _close(scaled[plane], g[plane], 1e-10)
    assert not g[4:].any()  # depth_sq and the silhouette only enter the mask


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("tracking", [True, False], ids=["tracking", "mapping"])
def test_closed_form_matches_autograd_of_the_composition(float64_window, tracking, option,
                                                         size):
    img, color, depth_gt = _frame(*size, seed=sum(size) + len(option))
    _check_closed_form(img, color, depth_gt, _pcfg(tracking, option), tracking)


@pytest.mark.parametrize("option", ["replica_bench", "outlier", "depth_unc"])
@pytest.mark.parametrize("case", ["nan_depth", "all_masked"])
@pytest.mark.parametrize("tracking", [True, False], ids=["tracking", "mapping"])
def test_closed_form_on_nan_and_masked_depth(float64_window, tracking, case, option):
    """A NaN depth pixel makes the loss NaN in both (|gt - d| * 0 is NaN)
    and leaves every gradient finite; an all-masked depth gives a zero
    depth term and gradient (mapping divides by max(count, 1))."""
    img, color, depth_gt = _frame(37, 53, seed=7, case=case)
    _check_closed_form(img, color, depth_gt, _pcfg(tracking, option), tracking)


def _loss_before_the_kernel(out, color, depth_gt, pcfg, tracking):
    """get_loss's loss as it was written before the kernel (the CPU's route
    must not change)."""
    depth, silhouette = out.depth, out.silhouette
    uncertainty = (out.depth_sq - depth * depth).detach()
    nan_mask = ~torch.isnan(depth) & ~torch.isnan(uncertainty)
    valid = depth_gt > 0
    if pcfg.ignore_outlier_depth_loss:
        depth_error = torch.abs(depth_gt - depth).detach() * valid
        thresh = 10.0 * steps._median_lower(depth_error)
        if pcfg.outlier_floor > 0.0:
            thresh = torch.clamp(thresh, min=pcfg.outlier_floor)
        mask = (depth_error < thresh) & valid
    else:
        mask = valid
    mask = mask & nan_mask
    if tracking and pcfg.use_sil_for_loss:
        mask = mask & (silhouette > pcfg.sil_thres)
    if pcfg.depth_unc_thres > 0.0:
        s = torch.clamp(silhouette, min=1e-6)
        var_norm = (out.depth_sq / s - (depth / s) ** 2).detach()
        mask = mask & (var_norm < pcfg.depth_unc_thres**2)
    mask = mask.detach()
    if tracking:
        depth_loss = torch.sum(torch.abs(depth_gt - depth) * mask)
    else:
        depth_loss = torch.sum(torch.abs(depth_gt - depth) * mask) / torch.clamp(mask.sum(),
                                                                                 min=1)
    if tracking and (pcfg.use_sil_for_loss or pcfg.ignore_outlier_depth_loss):
        im_loss = torch.sum(torch.abs(color - out.im) * mask[None])
    elif tracking:
        im_loss = torch.sum(torch.abs(color - out.im))
    else:
        im_loss = 0.8 * torch.abs(out.im - color).mean() + 0.2 * (
            1.0 - losses.calc_ssim(out.im, color))
    return pcfg.w_depth * depth_loss + pcfg.w_im * im_loss, pcfg.w_depth * depth_loss


@pytest.mark.parametrize("option", ["replica_bench", "outlier_floor", "depth_unc"])
@pytest.mark.parametrize("tracking", [True, False], ids=["tracking", "mapping"])
def test_get_loss_on_the_cpu_is_unchanged(monkeypatch, tracking, option):
    """get_loss on CPU tensors (float32) runs the PyTorch composition: its
    loss, weighted depth loss and gradient equal, bit for bit, those of the
    code as it was before the kernel."""
    img, color, depth_gt = _frame(37, 53, seed=11, dtype=torch.float32)
    pcfg = _pcfg(tracking, option)
    x = img.clone().requires_grad_(True)
    monkeypatch.setattr(steps, "loss_render", lambda *a, **k: _out(x))
    cam = Camera(37, 53, 40.0, 40.0, 26.0, 18.0)
    loss, aux = steps.get_loss(None, None, None, color, depth_gt, cam, pcfg, tracking,
                               not tracking)
    (g,) = torch.autograd.grad(loss, x)
    y = img.clone().requires_grad_(True)
    ref, ref_wd = _loss_before_the_kernel(_out(y), color, depth_gt, pcfg, tracking)
    (g_ref,) = torch.autograd.grad(ref, y)
    assert torch.equal(loss.detach(), ref.detach())
    assert torch.equal(aux.weighted_depth_loss, ref_wd.detach())
    assert torch.equal(g, g_ref)


@pytest.mark.parametrize("tracking", [True, False], ids=["tracking", "mapping"])
def test_fused_loss_keeps_only_the_gradient_planes(float64_window, tracking):
    """FusedLoss (its plain version on the CPU) saves the four gradient
    planes and their four scales for the backward, nothing else; its
    backward scales them by the incoming gradient, so 2.5 x the loss gives
    2.5 x the composition's gradient."""
    h, w = 37, 53
    img, color, depth_gt = _frame(h, w, seed=3)
    pcfg = _pcfg(tracking, "replica_bench")
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    x = img.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, wd, wi = fused_loss.fused_loss(x[:3], x[3], x[4], x[5], color, depth_gt,
                                             fused_loss.route(pcfg, tracking))
    assert sum(saved) == 4 * h * w + 4
    assert not wd.requires_grad and not wi.requires_grad
    (g,) = torch.autograd.grad(2.5 * loss, x)
    ref_loss, ref_wd, ref_wi, ref_g = _autograd_reference(img, color, depth_gt, pcfg, tracking,
                                                          scale=2.5)
    _close(loss.detach().reshape(1), ref_loss.reshape(1), 1e-10)
    for plane in range(6):
        _close(g[plane], ref_g[plane], 1e-10)


def _source(name: str) -> str:
    return (_cuda.CSRC / name).read_text()


def test_kernel_constants_match_the_wrapper():
    """csrc/loss.cu's tile, partials and window taps are the wrapper's and
    core/losses.py's: the taps equal _gaussian_window(11, 1.5) bit for bit."""
    src = _source("loss.cu")

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("LT_W"), const("LT_H"), const("LOSS_PARTS")) == (
        fused_loss.TILE_W, fused_loss.TILE_H, fused_loss.PARTS)
    body = re.search(r"__constant__ float WIN\[[^\]]*\] = \{([^}]*)\};", src).group(1)
    taps = np.array([float(v.strip().rstrip("f")) for v in body.split(",")], dtype=np.float32)
    assert taps.view(np.uint32).tolist() == (
        losses._gaussian_window(11, 1.5).view(np.uint32).tolist())
    assert fused_loss.grid_blocks(True, 680, 1200) == 38 * 43 * 3
    assert fused_loss.grid_blocks(False, 37, 53) == 2 * 3


def _prototypes() -> dict:
    """extern "C" functions of csrc/*.cu: name -> parameter declarations."""
    out = {}
    for path in sorted(_cuda.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" [\w\s\*]*?\b(\w+)\(([^)]*)\)', path.read_text()):
            out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_ctypes_signatures_match_the_sources(name):
    """Each entry of render/_cuda.py's signatures has the C function's
    parameters, one for one: int -> c_int, float -> c_float, a pointer ->
    c_void_p or a ctypes pointer."""
    params = _prototypes()[name]
    argtypes = _cuda._SIGNATURES[name]
    assert len(params) == len(argtypes), (params, argtypes)
    for decl, at in zip(params, argtypes):
        if "*" in decl:
            assert at is ctypes.c_void_p or issubclass(at, ctypes._Pointer), (decl, at)
        else:
            kind = decl.split()[0]
            assert at is {"int": ctypes.c_int, "float": ctypes.c_float}[kind], (decl, at)
