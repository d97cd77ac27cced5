"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports no jax, so it also runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
Every test needs a CUDA device (marker `cuda`) and skips without one.

Tolerances at 160x120 with 5k Gaussians (inputs from a numpy seed), each
output row (image channel, gradient column) against that row's own
largest value: images within 1e-5 and n_contrib exact (the forward
kernels round like their plain versions; a flipped threshold would move
a pixel by a whole pair's contribution); per-pair gradients within 1e-4
(per-pixel terms summed by warp shuffles instead of in pixel order);
per-Gaussian sums within 1e-5 (the same few terms in another order), at
every width 7 to 16. K1, K2 and K3 are held so at every channel count 1
to 10, and render_gaussians through them to its naive and tiles backends
on the card. K1 and K2 on per-pair rows must equal their
per-Gaussian mode bit for bit (the same kernel reads the same floats).
The fused forward's probe kernels run on the probe scripts' map at 64x48
(~500 pairs per tile): fwd2 must equal K4 bit for bit, math_only its
plain version as an image, and the dma walks their plain lane sums within
1e-5 per lane (the same float32 sums in another order). K3 and K5 sum in a
fixed order: two launches must be equal bit for bit. K1 and K2 cull the
(pair, warp) steps no pixel of the warp can apply: K1 must equal its plain
version bit for bit, and K2, whose sums also have a fixed order, must be
equal bit for bit across two launches, on adversarial rows (the families of
test_torch_cull.py) and on ragged tiles several batches deep. K4 runs the
same walk and cull behind its in-kernel projection: it must equal its plain
version bit for bit on ragged tiles several batches deep and on world
rows whose projection takes every branch (behind the near plane, det == 0,
clamped, scales from 0 to 1e12, centres far off the screen), and K4 and K5
on per-Gaussian rows read through pair_gauss must equal their per-pair mode
bit for bit. The loss kernel (csrc/loss.cu) is held to its plain version,
the closed form in float32, on test_torch_loss.py's frames: the loss within
1e-5 and each gradient plane within 1e-5 of its largest value (both blur
in float32, the mask is the same arithmetic), and equal bit for bit across
two launches (fixed-order sums).
"""
import numpy as np
import pytest
import torch

from splatam_tpu_torch.core import fused_loss
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.render import api, binning, composite, fused_iso, probes
from splatam_tpu_torch.scripts import scene
from splatam_tpu_torch.slam import steps
from test_torch_loss import _frame as loss_frame, _pcfg as loss_pcfg
from test_torch_cull import (FAMILIES, H as ROWS_H, W as ROWS_W, WORLD_FINITE, _family,
                             _world_family)

pytestmark = pytest.mark.cuda

CAM = Camera(height=120, width=160, fx=150.0, fy=150.0, cx=80.0, cy=60.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _map(device, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    f = dict(
        means3d=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                          rng.uniform(1.0, 5, n)], -1).astype(np.float32),
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
        logit_opacities=rng.normal(1.0, 0.5, n).astype(np.float32),
        log_scales=np.log(rng.uniform(0.01, 0.08, (n, 1))).astype(np.float32),
        active=rng.uniform(size=n) > 0.1,
    )
    return GaussianMap(**{k: torch.tensor(v, device=device) for k, v in f.items()})


def _pose(device):
    q = torch.tensor([0.99, 0.02, -0.03, 0.01], device=device)
    t = torch.tensor([0.02, -0.01, 0.03], device=device)
    return q, t


def _rel(got, ref):
    """Largest per-row error over that row's max|ref|: rows are the image
    channels of [C, H, W] and the columns of [P, k]."""
    rows = (lambda x: x.reshape(x.shape[0], -1)) if got.dim() == 3 else (lambda x: x.T)
    diff, scale = rows(got - ref).abs().amax(1), rows(ref).abs().amax(1)
    return float((diff / scale.clamp_min(1e-30)).max())


def _check_image(got, ref):
    assert torch.equal(got[-1], ref[-1]), "n_contrib differs"
    assert _rel(got[:-1], ref[:-1]) <= 1e-5


def test_composite_forward_kernel_matches_plain(cuda):
    gm = _map(cuda)
    proj, aux = api.project_gaussians(CAM, gm.means3d, gm.unnorm_rotations, gm.logit_opacities,
                             gm.log_scales, gm.active)
    b = binning.build_bins(proj, aux, CAM.width, CAM.height)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d], 1)
    attrs = attrs.contiguous()
    before = composite.composite_forward.launches[composite.CH]
    got = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, CAM.width, CAM.height)
    torch.cuda.synchronize()
    assert composite.composite_forward.launches[composite.CH] == before + 1
    ref = composite.composite_forward_plain(attrs, b.pair_gauss, b.tile_start, CAM.width,
                                            CAM.height)
    _check_image(got, ref)


def _generic_inputs(device, seed):
    """Per-Gaussian attrs and bins of the generic render of an anisotropic
    map, K1's state and seeded cotangents g [6, H, W]."""
    gm = _map(device, seed=seed)
    rng = np.random.default_rng(seed + 1)
    gm = gm._replace(log_scales=torch.tensor(
        np.log(rng.uniform(0.01, 0.08, (gm.capacity, 3))).astype(np.float32), device=device))
    proj, aux = api.project_gaussians(CAM, gm.means3d, gm.unnorm_rotations, gm.logit_opacities,
                                      gm.log_scales, gm.active)
    b = binning.build_bins(proj, aux, CAM.width, CAM.height)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d], 1)
    attrs = attrs.contiguous()
    state = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, CAM.width, CAM.height)
    gen = torch.Generator(device).manual_seed(seed)
    g = torch.randn((6, CAM.height, CAM.width), device=device, generator=gen)
    return attrs, b, state, g


def test_composite_backward_kernel_matches_plain(cuda):
    attrs, b, state, g = _generic_inputs(cuda, 6)
    before = composite.composite_backward.launches[composite.CH]
    got = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, CAM.width,
                                       CAM.height, state, g)
    torch.cuda.synchronize()
    assert composite.composite_backward.launches[composite.CH] == before + 1
    ref = composite.composite_backward_plain(attrs, b.pair_gauss, b.tile_start, CAM.width,
                                             CAM.height, state, g)
    assert got.shape == (b.n_pairs, 11) and bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= 1e-4


def _channels_inputs(device, ch, seed):
    """The generic render's kernel inputs at ch channels (seeded channels
    on an anisotropic map), K1's state and seeded cotangents g [ch + 1, H, W]."""
    attrs5, b, _, _ = _generic_inputs(device, seed)
    gen = torch.Generator(device).manual_seed(seed)
    chans = torch.rand((attrs5.shape[0], ch), device=device, generator=gen)
    attrs = torch.cat([attrs5[:, :6], chans], 1).contiguous()
    state = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, CAM.width, CAM.height)
    g = torch.randn((ch + 1, CAM.height, CAM.width), device=device, generator=gen)
    return attrs, b, state, g


@pytest.mark.parametrize("ch", composite.CHANNELS)
def test_every_channel_count_matches_plain(cuda, ch):
    """K1, K2 and K3 at ch channels (6 + ch columns) against their plain
    versions: K1 bit for bit, K2 within 1e-4 and K3 within 1e-5 per column,
    K2 and K3 equal across two launches, per-pair rows equal to
    per-Gaussian ones; each launch counted at its own width only."""
    attrs, b, state, g = _channels_inputs(cuda, ch, 20 + ch)
    w, h = CAM.width, CAM.height
    fwd = dict(composite.composite_forward.launches)
    bwd = dict(composite.composite_backward.launches)
    red = dict(composite.segment_reduce.launches)
    k1 = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h)
    k2 = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, state, g)
    k3 = composite.segment_reduce(k2, b.dst, b.offsets, b.counts)
    torch.cuda.synchronize()
    assert k1.shape == (ch + 2, h, w) and k2.shape == (b.n_pairs, 6 + ch)
    assert torch.equal(k1, state)
    assert torch.equal(k1, composite.composite_forward_plain(attrs, b.pair_gauss, b.tile_start,
                                                             w, h))
    assert _rel(k2, composite.composite_backward_plain(attrs, b.pair_gauss, b.tile_start, w, h,
                                                       state, g)) <= 1e-4
    assert _rel(k3, composite.segment_reduce_plain(k2, b.dst, b.offsets, b.counts)) <= 1e-5
    assert torch.equal(k2, composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h,
                                                        state, g))
    assert torch.equal(k3, composite.segment_reduce(k2, b.dst, b.offsets, b.counts))
    rows = attrs[b.pair_gauss.long()].contiguous()
    assert torch.equal(composite.composite_forward(rows, None, b.tile_start, w, h), k1)
    assert torch.equal(composite.composite_backward(rows, None, b.tile_start, w, h, state, g), k2)
    moved = lambda now, before: {k: now[k] - before[k] for k in now if now[k] != before[k]}
    assert moved(composite.composite_forward.launches, fwd) == {ch: 2}
    assert moved(composite.composite_backward.launches, bwd) == {ch: 3}
    assert moved(composite.segment_reduce.launches, red) == {6 + ch: 2}


@pytest.mark.parametrize("n_colors,append", [(3, False), (8, True)])
def test_render_gaussians_on_the_card_matches_the_references(cuda, n_colors, append):
    """render_gaussians through K1 -> K2 -> K3 (kernel ch 3 and 10) against
    its naive and tiles backends on the card: images within 1e-4,
    gradients within 5e-5 of the largest magnitude (the JAX suite's)."""
    gm = _map(cuda, n=2000, seed=n_colors)
    gen = torch.Generator(cuda).manual_seed(n_colors)
    colors = torch.rand((gm.capacity, n_colors), device=cuda, generator=gen)
    rows = n_colors + (3 if append else 0)
    w = torch.randn((rows, CAM.height, CAM.width), device=cuda, generator=gen)
    out = {}
    for backend in ("auto", "naive", "tiles"):
        params = [x.clone().requires_grad_(True) for x in
                  (gm.means3d, colors, gm.unnorm_rotations, gm.logit_opacities, gm.log_scales)]
        img, _, _ = api.render_gaussians(CAM, *params, gm.active, backend=backend,
                                         append_depth_channels=append)
        out[backend] = (img.detach(), torch.autograd.grad((img * w).sum(), params))
    img_a, grads_a = out["auto"]
    for backend in ("naive", "tiles"):
        img, grads = out[backend]
        assert float((img - img_a).abs().max()) <= 1e-4
        for mine, ref in zip(grads, grads_a):
            assert float((mine - ref).abs().max()) <= 5e-5 * float(ref.abs().max())


def test_per_pair_mode_equals_per_gaussian_mode(cuda):
    attrs, b, state, g = _generic_inputs(cuda, 7)
    rows = attrs[b.pair_gauss.long()].contiguous()
    w, h = CAM.width, CAM.height
    assert torch.equal(composite.composite_forward(rows, None, b.tile_start, w, h), state)
    assert torch.equal(
        composite.composite_backward(rows, None, b.tile_start, w, h, state, g),
        composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, state, g))


def test_segment_reduce_11_kernel_matches_plain(cuda):
    attrs, b, state, g = _generic_inputs(cuda, 8)
    dpair = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, CAM.width,
                                         CAM.height, state, g)
    before = composite.segment_reduce.launches[11]
    got = composite.segment_reduce(dpair, b.dst, b.offsets, b.counts)
    ref = composite.segment_reduce_plain(dpair, b.dst, b.offsets, b.counts)
    torch.cuda.synchronize()
    assert composite.segment_reduce.launches[11] == before + 1
    assert got.shape == (attrs.shape[0], 11)
    assert _rel(got, ref) <= 1e-5


def test_fused_kernels_match_plain(cuda):
    gm = _map(cuda, seed=1)
    q, t = _pose(cuda)
    ps = steps.loss_pair_structure(gm, q, t, CAM, with_world16=True)
    rmat = fused_iso.build_rotation(fused_iso.normalize(q)[None])[0]
    geom = fused_iso._geom_for(CAM)
    pose = fused_iso.make_pose_vec(rmat, t, geom[0], geom[1], *geom[2])
    before = fused_iso.fused_forward.launches, fused_iso.fused_backward.launches
    out = fused_iso.fused_forward(ps.world8, pose, ps.tile_start, CAM.width, CAM.height)
    ref = fused_iso.fused_forward_plain(ps.world8, pose, ps.tile_start, CAM.width, CAM.height)
    _check_image(out, ref)
    gen = torch.Generator(cuda).manual_seed(0)
    g = torch.randn((6, CAM.height, CAM.width), device=cuda, generator=gen)
    d = fused_iso.fused_backward(ps.world8, pose, ps.tile_start, CAM.width, CAM.height, ref, g)
    d_ref = fused_iso.fused_backward_plain(ps.world8, pose, ps.tile_start, CAM.width,
                                           CAM.height, ref, g)
    torch.cuda.synchronize()
    assert _rel(d, d_ref) <= 1e-4
    assert (fused_iso.fused_forward.launches, fused_iso.fused_backward.launches) == (
        before[0] + 1, before[1] + 1)


def test_segment_reduce_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    n, p = 3000, 20000
    counts = rng.multinomial(p, rng.dirichlet(np.ones(n) * 0.5)).astype(np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    dst = rng.permutation(p).astype(np.int32)
    dpair = rng.normal(size=(p, 8)).astype(np.float32)
    args = [torch.tensor(x, device=cuda) for x in (dpair, dst, offsets, counts)]
    got = composite.segment_reduce(*args)
    ref = composite.segment_reduce_plain(*args)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_losses_and_gradients_on_card_match_cpu(cuda):
    """The tracking and mapping losses through the autograd Functions (K4,
    K5, the pose contraction, K3) on the card vs the plain path on the CPU:
    loss rtol 1e-4, each gradient column within 1e-3 of its own largest
    value (SSIM's convolutions and the sums run on two devices)."""
    color = torch.rand((3, CAM.height, CAM.width), generator=torch.Generator().manual_seed(3))
    depth = 1.0 + 3.0 * torch.rand((CAM.height, CAM.width),
                                   generator=torch.Generator().manual_seed(4))
    pcfg_t = steps.PhaseConfig(True, 0.5, True, False, 0.5, 1.0)
    pcfg_m = steps.PhaseConfig(False, 0.5, True, False, 0.5, 1.0)
    results = {}
    for dev in ("cpu", cuda):
        gm = _map(dev, seed=5)
        q, t = _pose(dev)
        q.requires_grad_(True)
        t.requires_grad_(True)
        ps = steps.loss_pair_structure(gm, q, t, CAM, with_world16=True)
        lt, _ = steps.get_loss(gm, q, t, color.to(dev), depth.to(dev), CAM, pcfg_t, True,
                               False, ps)
        gq, gt = torch.autograd.grad(lt, (q, t))
        params = tuple(x.clone().requires_grad_(True) for x in (
            gm.means3d, gm.rgb_colors, gm.logit_opacities, gm.log_scales))
        gm2 = gm._replace(means3d=params[0], rgb_colors=params[1],
                          logit_opacities=params[2], log_scales=params[3])
        lm, _ = steps.get_loss(gm2, q.detach(), t.detach(), color.to(dev), depth.to(dev), CAM,
                               pcfg_m, False, True, ps._replace(world8=None))
        gp = torch.autograd.grad(lm, params)
        results[str(dev)] = [x.detach().cpu() for x in (lt, lm, gq, gt, *gp)]
    cpu, dev = results["cpu"], results[str(cuda)]
    for a, b in zip(cpu[:2], dev[:2]):
        assert abs(float(a) - float(b)) <= 1e-4 * abs(float(a))
    for a, b in zip(cpu[2:], dev[2:]):
        assert _rel(b.reshape(-1, 1) if b.dim() == 1 else b,
                    a.reshape(-1, 1) if a.dim() == 1 else a) <= 1e-3


def test_wrappers_reject_bad_arguments(cuda):
    w8 = torch.zeros((4, 8), device=cuda, dtype=torch.float64)
    pose = torch.zeros(24, device=cuda)
    ts = torch.zeros(CAM.width // 16 * (CAM.height // 16) + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="world8"):
        fused_iso.fused_forward(w8, pose, ts, CAM.width, CAM.height)
    with pytest.raises(ValueError, match="tile_start"):
        fused_iso.fused_forward(w8.float(), pose, ts[:-1], CAM.width, CAM.height)
    with pytest.raises(ValueError, match="attrs: the compositing kernels take 1 to 10"):
        composite.composite_backward(torch.zeros((4, 17), device=cuda), None, ts, CAM.width,
                                     CAM.height, None, None)
    with pytest.raises(ValueError, match="columns"):
        composite.segment_reduce(torch.zeros((4, 17), device=cuda), ts[:4], ts[:1], ts[:1])


def _loss_inputs(size, option, tracking, device, seed=0):
    """test_torch_loss's frame in float32 on `device`, its route and its
    outlier threshold."""
    img, color, depth_gt = loss_frame(*size, seed=seed, dtype=torch.float32)
    img, color, depth_gt = img.to(device), color.to(device), depth_gt.to(device)
    pcfg = loss_pcfg(tracking, option)
    thresh = None
    if pcfg.ignore_outlier_depth_loss:
        thresh = steps._outlier_thresh(img[3], depth_gt, pcfg)
    args = (img[:3], img[3], img[4], img[5], color, depth_gt,
            fused_loss.route(pcfg, tracking), thresh)
    return args


@pytest.mark.parametrize("size", [(680, 1200), (480, 640), (37, 53)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("option", ["replica_bench", "outlier", "depth_unc"])
@pytest.mark.parametrize("tracking", [True, False], ids=["tracking", "mapping"])
def test_loss_kernel_matches_plain(cuda, monkeypatch, tracking, option, size):
    """The loss kernel against its plain version on the same float32 planes
    (the plain version's blurs in full float32: no TF32): loss, weighted
    terms and mask count within 1e-5 relative, each gradient plane within
    1e-5 of its own largest |value|, and its scales exactly (the mask is
    the same float32 arithmetic in both, so no pixel flips). The frame's
    colour is also read at the strides of an HWC image, as the keyframes'
    is."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    args = _loss_inputs(size, option, tracking, cuda, seed=sum(size))
    res, grad, gscale = fused_loss.loss_terms(*args)
    ref_res, ref_grad, ref_gscale = fused_loss.loss_terms_plain(*args)
    assert float(res[3]) == float(ref_res[3])
    for got, ref in zip(res[:3].cpu(), ref_res[:3].cpu()):
        assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    assert _rel(grad, ref_grad) <= 1e-5
    assert torch.equal(gscale, ref_gscale)
    hwc = args[4].permute(1, 2, 0).contiguous().permute(2, 0, 1)
    res2, grad2, _ = fused_loss.loss_terms(*args[:4], hwc, *args[5:])
    assert torch.equal(res2, res) and torch.equal(grad2, grad)


@pytest.mark.parametrize("tracking", [True, False], ids=["tracking", "mapping"])
def test_loss_kernel_is_deterministic(cuda, tracking):
    """Fixed-order sums, no float atomics: two launches at 1200x680 give the
    same loss and gradient planes bit for bit."""
    args = _loss_inputs((680, 1200), "replica_bench", tracking, cuda, seed=9)
    first = fused_loss.loss_terms(*args)
    second = fused_loss.loss_terms(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_get_loss_launches_the_loss_kernel(cuda):
    """get_loss on the card runs the loss as the kernel's two launches (the
    tiles and the reduction) in tracking and in mapping, and never on the
    CPU."""
    color = torch.rand((3, CAM.height, CAM.width), generator=torch.Generator().manual_seed(3))
    depth = 1.0 + 3.0 * torch.rand((CAM.height, CAM.width),
                                   generator=torch.Generator().manual_seed(4))
    pcfg = steps.PhaseConfig(True, 0.5, True, False, 0.5, 1.0)
    for dev, per_call in (("cpu", 0), (cuda, 2)):
        gm = _map(dev, seed=5)
        q, t = _pose(dev)
        ps = steps.loss_pair_structure(gm, q, t, CAM, with_world16=True)
        before = dict(fused_loss.loss_terms.launches)
        steps.get_loss(gm, q, t, color.to(dev), depth.to(dev), CAM, pcfg, True, False, ps)
        steps.get_loss(gm, q, t, color.to(dev), depth.to(dev), CAM, pcfg, False, True,
                       ps._replace(world8=None))
        after = fused_loss.loss_terms.launches
        assert {k: after[k] - before[k] for k in after} == {"track": per_call, "map": per_call}


def test_mapping_get_loss_keeps_at_most_the_gradient_planes(cuda):
    """At 1200x680 a mapping get_loss (fused render) holds at most 16 MB more
    between its forward and autograd.grad than its render alone: the four
    gradient planes (13.06 MB) and the partials, not SSIM's intermediates."""
    cam = Camera(height=680, width=1200, fx=600.0, fy=600.0, cx=599.5, cy=339.5)
    gm = _map(cuda, n=20000, seed=6)
    q, t = _pose(cuda)
    ps = steps.loss_pair_structure(gm, q, t, cam)
    color = torch.rand((3, cam.height, cam.width), device=cuda)
    depth = 1.0 + 3.0 * torch.rand((cam.height, cam.width), device=cuda)
    pcfg = steps.PhaseConfig(False, 0.5, True, False, 0.5, 1.0)
    params = tuple(x.clone().requires_grad_(True) for x in (
        gm.means3d, gm.rgb_colors, gm.logit_opacities, gm.log_scales))
    gm2 = gm._replace(means3d=params[0], rgb_colors=params[1], logit_opacities=params[2],
                      log_scales=params[3])

    def held(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        kept = fn()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() - base, kept

    render, out = held(lambda: steps.loss_render(gm2, q, t, cam, False, True, ps))
    del out
    whole, (loss, _) = held(lambda: steps.get_loss(gm2, q, t, color, depth, cam, pcfg, False,
                                                  True, ps))
    assert whole - render <= 16e6, (whole, render)
    grads = torch.autograd.grad(loss, params)
    assert all(torch.isfinite(g).all() for g in grads)


def test_loss_wrapper_rejects_bad_arguments(cuda):
    args = list(_loss_inputs((37, 53), "replica_bench", False, cuda))
    with pytest.raises(ValueError, match="im"):
        fused_loss.loss_terms(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="color"):
        fused_loss.loss_terms(*args[:4], args[4][:, :-1], *args[5:])
    with pytest.raises(ValueError, match="depth_gt"):
        fused_loss.loss_terms(*args[:5], args[5].cpu(), *args[6:])


@pytest.mark.parametrize("logit", [-2.0, 1.0])
def test_probe_kernels_match_k4_and_plain(cuda, logit):
    gm, q, t, cam = scene.synthetic_scene(150_000, 64, 48, logit, cuda)
    ps, pose = scene.fused_inputs(gm, q, t, cam)
    w8, ts, w, h = ps.world8, ps.tile_start, cam.width, cam.height
    assert int((ts[1:] - ts[:-1]).max()) > 4 * probes.C
    before = (probes.fwd2.launches, probes.math_only.launches, dict(probes.dma_walk.launches))
    k4 = fused_iso.fused_forward(w8, pose, ts, w, h)
    assert torch.equal(probes.fwd2(w8, pose, ts, w, h), k4)
    _check_image(probes.math_only(w8, pose, ts, w, h),
                 probes.math_only_plain(w8, pose, ts, w, h))
    for b in probes.DMA_BLOCKS:
        got = probes.dma_walk(w8, ts, b)
        assert got.shape == (ts.shape[0] - 1, probes.C)
        assert _rel(got, probes.dma_walk_plain(w8, ts, b)) <= 1e-5
    torch.cuda.synchronize()
    assert probes.fwd2.launches == before[0] + 1 and probes.math_only.launches == before[1] + 1
    assert all(probes.dma_walk.launches[b] == before[2][b] + 1 for b in probes.DMA_BLOCKS)


def test_probe_wrappers_reject_bad_arguments(cuda):
    ts = torch.zeros(CAM.width // 16 * (CAM.height // 16) + 1, dtype=torch.int32, device=cuda)
    pose = torch.zeros(24, device=cuda)
    with pytest.raises(ValueError, match="world8"):
        probes.fwd2(torch.zeros((4, 7), device=cuda), pose, ts, CAM.width, CAM.height)
    with pytest.raises(ValueError, match="b: expected"):
        probes.dma_walk(torch.zeros((4, 8), device=cuda), ts, 3)
    with pytest.raises(ValueError, match="tile_start"):
        probes.math_only(torch.zeros((4, 8), device=cuda), pose, ts[:-1], CAM.width, CAM.height)


@pytest.mark.parametrize("k", composite.SEGMENT_WIDTHS)
def test_segment_reduce_edge_counts_are_deterministic(cuda, k):
    """K3 on Gaussians with 0, 1, 2, 33 and 200 pairs, n = 1001 (a multiple
    of neither lane group), against its plain version and index_add_ within
    1e-5 per column, and equal bit for bit across two launches; at 8
    columns also on rows that are not 16-byte aligned (the per-column
    kernel, same order of sums: equal bit for bit)."""
    rng = np.random.default_rng(k)
    counts = np.array([0, 1, 2, 33, 200] * 200 + [3], np.int32)
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    p = int(counts.sum())
    dst = rng.permutation(p).astype(np.int32)
    dpair = torch.tensor(rng.normal(size=(p, k)).astype(np.float32), device=cuda)
    idx = [torch.tensor(x, device=cuda) for x in (dst, offsets, counts)]
    before = composite.segment_reduce.launches[k]
    got = composite.segment_reduce(dpair, *idx)
    again = composite.segment_reduce(dpair, *idx)
    ref = composite.segment_reduce_plain(dpair, *idx)
    gid = torch.repeat_interleave(torch.arange(counts.size, device=cuda),
                                  idx[2].long())[idx[0].long().argsort()]
    lib = torch.zeros((counts.size, k), device=cuda).index_add_(0, gid, dpair)
    torch.cuda.synchronize()
    assert composite.segment_reduce.launches[k] == before + 2
    assert torch.equal(got, again)
    assert _rel(got, ref) <= 1e-5 and _rel(lib, got) <= 1e-5
    assert bool((got[counts == 0] == 0).all())
    if k == 8:
        buf = torch.empty(p * k + 1, device=cuda)
        shifted = buf[1:].view(p, k)
        shifted.copy_(dpair)
        assert shifted.data_ptr() % 16
        assert torch.equal(composite.segment_reduce(shifted, *idx), got)


def _deep_scene(device):
    """152x116 (ragged right and bottom tiles), 20k Gaussians: tiles
    several 64-pair batches deep whose pixels stop early, so some pairs lie
    past their tile's deepest n_contrib."""
    cam = Camera(height=116, width=152, fx=150.0, fy=150.0, cx=76.0, cy=58.0)
    gm = _map(device, n=20000, seed=9)
    q, t = _pose(device)
    ps = steps.loss_pair_structure(gm, q, t, cam, with_world16=True)
    rmat = fused_iso.build_rotation(fused_iso.normalize(q)[None])[0]
    geom = fused_iso._geom_for(cam)
    pose = fused_iso.make_pose_vec(rmat, t, geom[0], geom[1], *geom[2])
    return cam, ps, pose


def test_fused_backward_one_channel_at_a_time(cuda):
    """K5 with the cotangent in one of the six channels at a time (so a
    column-to-lane mix-up cannot hide behind a larger column) within 1e-4
    per column of its plain version, equal bit for bit across two launches,
    and zeros for every pair past its tile's deepest n_contrib."""
    cam, ps, pose = _deep_scene(cuda)
    w, h, ts = cam.width, cam.height, ps.tile_start
    lens = ts[1:] - ts[:-1]
    assert int(lens.max()) > 3 * 64
    state = fused_iso.fused_forward(ps.world8, pose, ts, w, h)
    reach = composite.to_tiles(state[-1:])[0].amax(1).long()
    slot = torch.arange(ps.n_pairs, device=cuda)
    tile_of = torch.repeat_interleave(torch.arange(lens.numel(), device=cuda), lens.long())
    past = slot - ts[:-1].long()[tile_of] >= reach[tile_of]
    assert int(past.sum()) > 0
    gen = torch.Generator(cuda).manual_seed(3)
    for c in range(6):
        g = torch.zeros((6, h, w), device=cuda)
        g[c] = torch.randn((h, w), device=cuda, generator=gen)
        d = fused_iso.fused_backward(ps.world8, pose, ts, w, h, state, g)
        again = fused_iso.fused_backward(ps.world8, pose, ts, w, h, state, g)
        ref = fused_iso.fused_backward_plain(ps.world8, pose, ts, w, h, state, g)
        torch.cuda.synchronize()
        assert torch.equal(d, again), f"channel {c}: two launches differ"
        assert _rel(d, ref) <= 1e-4, f"channel {c}"
        assert bool((d[past] == 0).all()), f"channel {c}: a pair past the reach is not 0"


def _assert_same_image(got, ref):
    """Every channel, the silhouette and n_contrib, bit for bit."""
    assert torch.equal(got[-1], ref[-1]), "n_contrib differs"
    assert torch.equal(got, ref), f"worst row {_rel(got[:-1], ref[:-1]):.1e}"


# The non_finite family is left to the CPU tests: fminf(0.99, NaN) is 0.99 in
# the kernels while torch.clamp keeps the NaN, so kernel and plain version
# differ there by construction (in every walk kernel of the port).
@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "non_finite"])
def test_composite_kernels_on_adversarial_rows(cuda, family):
    """K1 equal to its plain version bit for bit and K2 within 1e-4 per
    column, twice and equal bit for bit, on rows the cull must not get wrong
    (opacity around 1/255 and above 1, det <= 0, strong anisotropy, far
    centres, footprints larger than the tile, grazing ellipses), per pair
    and gathered through pair_gauss, on a 40x28 image (ragged tiles)."""
    rows, ts = _family(family, seed=11)
    rows, ts = rows.to(cuda), ts.to(cuda)
    w, h = ROWS_W, ROWS_H
    gen = torch.Generator(cuda).manual_seed(2)
    g = torch.randn((6, h, w), device=cuda, generator=gen)
    perm = torch.randperm(rows.shape[0], device=cuda, generator=gen).to(torch.int32)
    table = torch.empty_like(rows)
    table[perm.long()] = rows
    ref = composite.composite_forward_plain(rows, None, ts, w, h)
    dref = composite.composite_backward_plain(rows, None, ts, w, h, ref, g)
    for attrs, idx in ((rows, None), (table, perm)):
        _assert_same_image(composite.composite_forward(attrs, idx, ts, w, h), ref)
        d = composite.composite_backward(attrs, idx, ts, w, h, ref, g)
        again = composite.composite_backward(attrs, idx, ts, w, h, ref, g)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(d).all())
        assert torch.equal(d, again), "two launches differ"
        assert _rel(d, dref) <= 1e-4


def _deep_generic(device):
    """_deep_scene's camera and map through the generic render: ragged
    tiles more than two of K1's 256-pair batches deep."""
    cam = Camera(height=116, width=152, fx=150.0, fy=150.0, cx=76.0, cy=58.0)
    gm = _map(device, n=20000, seed=9)
    proj, aux = api.project_gaussians(cam, gm.means3d, gm.unnorm_rotations, gm.logit_opacities,
                                      gm.log_scales, gm.active)
    b = binning.build_bins(proj, aux, cam.width, cam.height)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d], 1)
    return cam, attrs.contiguous(), b


def test_composite_forward_equals_plain_on_deep_ragged_tiles(cuda):
    cam, attrs, b = _deep_generic(cuda)
    w, h, ts = cam.width, cam.height, b.tile_start
    assert int((ts[1:] - ts[:-1]).max()) > 2 * 256
    ref = composite.composite_forward_plain(attrs, b.pair_gauss, ts, w, h)
    _assert_same_image(composite.composite_forward(attrs, b.pair_gauss, ts, w, h), ref)
    rows = attrs[b.pair_gauss.long()].contiguous()
    _assert_same_image(composite.composite_forward(rows, None, ts, w, h), ref)


def test_composite_backward_one_channel_at_a_time(cuda):
    """K2 with the cotangent in one of the six channels at a time (so a
    column-to-lane mix-up cannot hide behind a larger column) within 1e-4
    per column of its plain version, equal bit for bit across two launches,
    and zeros for every pair past its tile's deepest n_contrib."""
    cam, attrs, b = _deep_generic(cuda)
    w, h, ts = cam.width, cam.height, b.tile_start
    lens = ts[1:] - ts[:-1]
    assert int(lens.max()) > 3 * 64
    state = composite.composite_forward(attrs, b.pair_gauss, ts, w, h)
    reach = composite.to_tiles(state[-1:])[0].amax(1).long()
    slot = torch.arange(b.n_pairs, device=cuda)
    tile_of = torch.repeat_interleave(torch.arange(lens.numel(), device=cuda), lens.long())
    past = slot - ts[:-1].long()[tile_of] >= reach[tile_of]
    assert int(past.sum()) > 0
    gen = torch.Generator(cuda).manual_seed(3)
    for c in range(6):
        g = torch.zeros((6, h, w), device=cuda)
        g[c] = torch.randn((h, w), device=cuda, generator=gen)
        d = composite.composite_backward(attrs, b.pair_gauss, ts, w, h, state, g)
        again = composite.composite_backward(attrs, b.pair_gauss, ts, w, h, state, g)
        ref = composite.composite_backward_plain(attrs, b.pair_gauss, ts, w, h, state, g)
        torch.cuda.synchronize()
        assert torch.equal(d, again), f"channel {c}: two launches differ"
        assert _rel(d, ref) <= 1e-4, f"channel {c}"
        assert bool((d[past] == 0).all()), f"channel {c}: a pair past the reach is not 0"


def _scattered_table(rows, seed):
    """(table, index): the per-pair rows scattered into a table in a seeded
    random order, and the int32 index that gathers them back."""
    gen = torch.Generator(rows.device).manual_seed(seed)
    perm = torch.randperm(rows.shape[0], device=rows.device, generator=gen).to(torch.int32)
    table = torch.empty_like(rows)
    table[perm.long()] = rows
    return table, perm


def test_fused_kernels_equal_in_both_input_modes(cuda):
    """K4 and K5 on the map's per-Gaussian rows through the structure's
    pair_gauss (mapping's inputs) equal, bit for bit, the same kernels on the
    gathered per-pair rows (tracking's inputs)."""
    gm = _map(cuda, seed=12)
    q, t = _pose(cuda)
    ps, pose = scene.fused_inputs(gm, q, t, CAM)
    w, h, ts = CAM.width, CAM.height, ps.tile_start
    table = fused_iso.pack_world8(gm.means3d, gm.logit_opacities, gm.log_scales, gm.rgb_colors,
                                  gm.active)
    assert torch.equal(table[ps.pair_gauss.long()], ps.world8)
    before = fused_iso.fused_forward.launches, fused_iso.fused_backward.launches
    state = fused_iso.fused_forward(ps.world8, pose, ts, w, h)
    assert torch.equal(fused_iso.fused_forward(table, pose, ts, w, h, ps.pair_gauss), state)
    g = torch.randn((6, h, w), device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    d = fused_iso.fused_backward(ps.world8, pose, ts, w, h, state, g)
    d_idx = fused_iso.fused_backward(table, pose, ts, w, h, state, g, ps.pair_gauss)
    torch.cuda.synchronize()
    assert d_idx.shape == (ps.n_pairs, 8) and torch.equal(d_idx, d)
    assert (fused_iso.fused_forward.launches, fused_iso.fused_backward.launches) == (
        before[0] + 2, before[1] + 2)
    with pytest.raises(ValueError, match="pair_gauss"):
        fused_iso.fused_forward(table, pose, ts, w, h, ps.pair_gauss.long())


def test_fused_forward_matches_plain_on_deep_ragged_tiles(cuda):
    cam, ps, pose = _deep_scene(cuda)
    w, h, ts = cam.width, cam.height, ps.tile_start
    assert int((ts[1:] - ts[:-1]).max()) > 2 * 256
    got = fused_iso.fused_forward(ps.world8, pose, ts, w, h)
    _assert_same_image(got, fused_iso.fused_forward_plain(ps.world8, pose, ts, w, h))
    table, idx = _scattered_table(ps.world8, 4)
    assert torch.equal(fused_iso.fused_forward(table, pose, ts, w, h, idx), got)
    assert torch.equal(probes.fwd2(ps.world8, pose, ts, w, h), got)


@pytest.mark.parametrize("family", WORLD_FINITE)
def test_fused_forward_on_adversarial_world_rows(cuda, family):
    """K4 equal to its plain version bit for bit (as K1 is: the same walk,
    and a projection that rounds like the plain one) on world rows whose
    projection the cull must not get wrong, per pair and through pair_gauss;
    fwd2 equal to K4 and math_only to its plain version on the same rows; on
    a 40x28 image (ragged tiles)."""
    w8, pose, ts = (x.to(cuda) for x in _world_family(family, seed=5))
    w, h = ROWS_W, ROWS_H
    ref = fused_iso.fused_forward_plain(w8, pose, ts, w, h)
    got = fused_iso.fused_forward(w8, pose, ts, w, h)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_same_image(got, ref)
    table, idx = _scattered_table(w8, 6)
    assert torch.equal(fused_iso.fused_forward(table, pose, ts, w, h, idx), got)
    assert torch.equal(probes.fwd2(w8, pose, ts, w, h), got)
    _assert_same_image(probes.math_only(w8, pose, ts, w, h),
                       probes.math_only_plain(w8, pose, ts, w, h))


def _micro_config(workdir, frames):
    """test_torch_slam.py's micro config (64x48, 6 tracking / 8 mapping
    iterations, rebin_every=8: the fused path), without importing jax."""
    import os

    from splatam_tpu_torch.slam.config import load_experiment_config

    config = load_experiment_config(os.path.join(os.path.dirname(__file__), "..", "configs",
                                                 "synthetic", "splatam.py"))
    config["workdir"] = str(workdir)
    config["data"].update(desired_image_height=48, desired_image_width=64, num_frames=frames)
    config["tracking"]["num_iters"] = 6
    config["mapping"]["num_iters"] = 8
    config["mapping_window_size"] = 5
    config["keyframe_every"] = 2
    config["tpu"] = dict(capacity=1 << 13, rebin_every=8)
    return config


@pytest.fixture(scope="module")
def slam_runs(tmp_path_factory):
    """rgbd_slam on the micro config (3 frames), on the card and on the CPU,
    each seeded at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from splatam_tpu_torch.slam.config import seed_everything
    from splatam_tpu_torch.slam.pipeline import rgbd_slam

    out = {}
    for dev in ("cuda", "cpu"):
        config = _micro_config(tmp_path_factory.mktemp(dev), 3)
        seed_everything(0)
        out[dev] = (config, rgbd_slam(config, dev))
    return out


def _params(config):
    import os

    return dict(np.load(os.path.join(config["workdir"], config["run_name"], "params.npz")))


def test_rgbd_slam_on_the_card_matches_cpu(slam_runs):
    """Poses within 1e-4 of the CPU run (the plain versions), equal
    keyframes (0, 1 and the num_frames - 2 one, 1), finite metrics."""
    (gcfg, gm), (ccfg, cm) = slam_runs["cuda"], slam_runs["cpu"]
    mine, ref = _params(gcfg), _params(ccfg)
    np.testing.assert_allclose(mine["cam_unnorm_rots"], ref["cam_unnorm_rots"], atol=1e-4)
    np.testing.assert_allclose(mine["cam_trans"], ref["cam_trans"], atol=1e-4)
    assert mine["keyframe_time_indices"].tolist() == ref["keyframe_time_indices"].tolist()
    assert all(np.isfinite(gm[k]) for k in ("psnr", "ms_ssim", "depth_l1", "ate_rmse",
                                            "lpips_synthetic"))


def test_eval_sequence_on_the_card_launches_k1(slam_runs, tmp_path):
    """eval_sequence on the card renders every frame through K1 and, on the
    run's own params.npz, gives the run's metrics bit for bit."""
    from splatam_tpu_torch.data import dataset_from_config
    from splatam_tpu_torch.eval.evaluate import eval_sequence
    from splatam_tpu_torch.scripts.harness import launch_counts, reset_launch_counts

    config, metrics = slam_runs["cuda"]
    cfg_m = config["mapping"]
    dataset = dataset_from_config(config["data"])
    reset_launch_counts()
    again = eval_sequence(dataset, _params(config), 3, str(tmp_path), cfg_m["sil_thres"],
                          cfg_m["num_iters"], cfg_m["add_new_gaussians"],
                          eval_every=config["eval_every"], device="cuda", save_plots=False)
    assert launch_counts()["composite_forward"] >= 3
    assert again == {k: v for k, v in metrics.items() if k != "runtime"}


@pytest.fixture(scope="module")
def replica_v2_runs(tmp_path_factory):
    """rgbd_slam of configs/replica_v2/splatam.py (cut to 48x64, 3 frames, 6
    tracking / 8 mapping iterations) on a Replica-V2 tree of the synthetic
    scene at the YAML's 1200x680 camera, written by data/export.py (no
    imaging library), on the card and on the CPU, each seeded at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os

    from splatam_tpu_torch.data.export import synthetic_sequence, write_replica_v2
    from splatam_tpu_torch.slam.config import load_experiment_config, seed_everything
    from splatam_tpu_torch.slam.pipeline import rgbd_slam

    root = str(tmp_path_factory.mktemp("replica_v2"))
    os.symlink(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs"),
               os.path.join(root, "configs"))
    ds = synthetic_sequence(3, 680, 1200, fx=600.0, fy=600.0, cx=599.5, cy=339.5)
    write_replica_v2(os.path.join(root, "data", "Replica_V2", "room_0"), ds, range(3))
    here, out = os.getcwd(), {}
    os.chdir(root)
    try:
        for dev in ("cuda", "cpu"):
            config = load_experiment_config(os.path.join("configs", "replica_v2", "splatam.py"))
            config["workdir"] = os.path.join(root, dev)
            config["data"].update(desired_image_height=48, desired_image_width=64, num_frames=3)
            config["tracking"]["num_iters"] = 6
            config["mapping"]["num_iters"] = 8
            seed_everything(0)
            out[dev] = (config, rgbd_slam(config, dev))
    finally:
        os.chdir(here)
    return out


def test_replica_v2_config_on_the_card_matches_cpu(replica_v2_runs):
    """The real-format path (ReplicaV2 loader, dataset YAML, rebin_every=1:
    K1, K2 and K3 at 11 columns) on the card: poses within 1e-4 of the CPU
    run, equal keyframes, finite metrics."""
    (gcfg, gm), (ccfg, cm) = replica_v2_runs["cuda"], replica_v2_runs["cpu"]
    mine, ref = _params(gcfg), _params(ccfg)
    np.testing.assert_allclose(mine["cam_unnorm_rots"], ref["cam_unnorm_rots"], atol=1e-4)
    np.testing.assert_allclose(mine["cam_trans"], ref["cam_trans"], atol=1e-4)
    assert mine["keyframe_time_indices"].tolist() == ref["keyframe_time_indices"].tolist()
    assert all(np.isfinite(gm[k]) for k in ("psnr", "ms_ssim", "depth_l1", "ate_rmse"))
