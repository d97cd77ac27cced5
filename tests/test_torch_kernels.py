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
8 and at 11 columns. K1 and K2 on per-pair rows must equal their
per-Gaussian mode bit for bit (the same kernel reads the same floats).
The fused forward's probe kernels run on the probe scripts' map at 64x48
(~500 pairs per tile): fwd2 must equal K4 bit for bit, math_only its
plain version as an image, and the dma walks their plain lane sums within
1e-5 per lane (the same float32 sums in another order).
"""
import numpy as np
import pytest
import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.render import api, binning, composite, fused_iso, probes
from splatam_tpu_torch.scripts import scene
from splatam_tpu_torch.slam import steps

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
    before = composite.composite_forward.launches
    got = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, CAM.width, CAM.height)
    torch.cuda.synchronize()
    assert composite.composite_forward.launches == before + 1
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
    before = composite.composite_backward.launches
    got = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, CAM.width,
                                       CAM.height, state, g)
    torch.cuda.synchronize()
    assert composite.composite_backward.launches == before + 1
    ref = composite.composite_backward_plain(attrs, b.pair_gauss, b.tile_start, CAM.width,
                                             CAM.height, state, g)
    assert got.shape == (b.n_pairs, 11) and bool(torch.isfinite(got).all())
    assert _rel(got, ref) <= 1e-4


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
    with pytest.raises(ValueError, match="attrs"):
        composite.composite_backward(w8.float(), None, ts, CAM.width, CAM.height, None, None)
    with pytest.raises(ValueError, match="columns"):
        composite.segment_reduce(torch.zeros((4, 9), device=cuda), ts[:4], ts[:1], ts[:1])


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
