"""The port's generic differentiable render (K1 forward, K2 -> K3 backward,
the projection by autograd), its pair-space world-16 tracking render and
K3 at 11 columns, against the JAX package on shared numpy inputs.

The JAX side runs its Pallas kernels under the TPU interpreter, as
tests/test_pallas_interpret.py does; the port runs the kernels' plain
versions (the tensors lie on the CPU). Tolerances are the JAX suite's own
for its backends: images 1e-4 absolute, every gradient within 5e-5 of its
own largest magnitude (test_pallas_interpret.py:76-77); K3's sums at
rtol 1e-5 (the same float32 terms in another order). The loss weighs
every output row, the silhouette included, with a seeded cotangent, so a
dropped silhouette term or a zeroed column shows. The kernels themselves
are held to these plain versions in tests/test_torch_kernels.py (CUDA).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.core.gaussians import GaussianMap as JMap
from splatam_tpu.render.api import RenderConfig, render_gaussians, render_rgbd_sil_pairspace
from splatam_tpu.render.pallas.composite_pallas import segment_reduce_scan_pallas
from splatam_tpu.slam import steps as jsteps
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.render import api, composite
from splatam_tpu_torch.slam import steps

# The port's plain compositing loops issue thousands of tiny ops; with
# several test workers on one machine, torch's default intra-op thread
# pool per worker oversubscribes the cores (measured on 8 cores with 6
# workers: >900 s instead of ~75 s for the port's end-to-end files), so
# one thread each.
torch.set_num_threads(1)

JCAM = JCamera(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CAM = Camera(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CFG_P = RenderConfig(backend="pallas", pair_cap=1 << 12, tile_k_max=512)
Q = np.asarray([0.99, 0.02, -0.03, 0.01], np.float32)
T = np.asarray([0.02, -0.01, 0.03], np.float32)
GRAD_TOL = 5e-5


def _scene(n=512, seed=0, iso=True):
    """test_torch_render.py's scene: some Gaussians lie behind the camera."""
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(-0.5, 5, n)], -1
    ).astype(np.float32)
    return dict(
        means=means,
        rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        logit=rng.normal(1.0, 0.5, n).astype(np.float32),
        logsc=np.log(rng.uniform(0.01, 0.08, (n, 1 if iso else 3))).astype(np.float32),
        active=rng.uniform(size=n) > 0.1,
    )


def _cotangent(seed):
    """Weights of the six public rows r, g, b, depth, silhouette, depth^2."""
    return np.random.default_rng(seed).normal(size=(6, 48, 64)).astype(np.float32)


def _close_grad(mine, ref, name):
    ref = np.asarray(ref)
    assert np.isfinite(mine).all(), name
    scale = np.abs(ref).max() + 1e-8
    np.testing.assert_allclose(mine, ref, atol=GRAD_TOL * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("iso", [True, False], ids=["isotropic", "anisotropic"])
def test_generic_render_and_gradients_match_pallas_interpret(iso):
    s = _scene(seed=2, iso=iso)
    w = _cotangent(3)
    names = ("means", "rgb", "quats", "logit", "logsc")
    active = jnp.asarray(s["active"])

    def jloss(*a):
        img = render_gaussians(JCAM, *a, active, config=CFG_P)[0]
        return jnp.sum(img * w), img

    with pltpu.force_tpu_interpret_mode():
        (_, img_j), grads_j = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                                         has_aux=True))(
            *(jnp.asarray(s[k]) for k in names))

    t = {k: torch.tensor(v).requires_grad_(k != "active") for k, v in s.items()}
    out = api.render_rgbd_sil(CAM, *(t[k] for k in names), t["active"])
    img = torch.cat([out.im, out.depth[None], out.silhouette[None], out.depth_sq[None]])
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j), atol=1e-4)
    grads = torch.autograd.grad((img * torch.tensor(w)).sum(), [t[k] for k in names])
    for name, mine, ref in zip(names, grads, grads_j):
        if iso and name == "quats":
            # A spherical covariance does not depend on the rotation: both
            # gradients are float32 noise, which only has to stay finite.
            assert torch.isfinite(mine).all() and float(mine.abs().max()) < 1e-2
            continue
        _close_grad(mine.numpy(), ref, name)
    behind = s["means"][:, 2] < 0.2
    assert behind.any() and np.isfinite(grads[0].numpy()[behind]).all()


def test_pairspace_world16_render_and_pose_gradients_match_jax():
    s = _scene(seed=4, iso=False)
    fields = dict(means3d=s["means"], rgb_colors=s["rgb"], unnorm_rotations=s["quats"],
                  logit_opacities=s["logit"], log_scales=s["logsc"], active=s["active"])
    jgm = JMap(**{k: jnp.asarray(v) for k, v in fields.items()})
    tgm = GaussianMap(**{k: torch.tensor(v) for k, v in fields.items()})
    w = _cotangent(5)
    # The pair-space render returns [r, g, b], depth, silhouette, depth^2.
    with pltpu.force_tpu_interpret_mode():
        ps_j = jsteps.loss_pair_structure(jgm, jnp.asarray(Q), jnp.asarray(T), JCAM, CFG_P,
                                          with_world16=True)
        assert ps_j.world16 is not None and ps_j.world8 is None

        def jloss(q, t):
            o = render_rgbd_sil_pairspace(JCAM, ps_j, q, t, 512)
            img = jnp.concatenate([o.im, o.depth[None], o.silhouette[None], o.depth_sq[None]])
            return jnp.sum(img * w), img

        (_, img_j), (dq_j, dt_j) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(
            jnp.asarray(Q), jnp.asarray(T))

    q, t = torch.tensor(Q, requires_grad=True), torch.tensor(T, requires_grad=True)
    ps = steps.loss_pair_structure(tgm, q, t, CAM, with_world16=True)
    assert ps.world16 is not None and ps.world8 is None
    out = api.render_rgbd_sil_pairspace(CAM, ps, q, t)
    img = torch.cat([out.im, out.depth[None], out.silhouette[None], out.depth_sq[None]])
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j), atol=1e-4)
    dq, dt = torch.autograd.grad((img * torch.tensor(w)).sum(), (q, t))
    _close_grad(dq.numpy(), dq_j, "q")
    _close_grad(dt.numpy(), dt_j, "t")


def test_segment_reduce_11_columns_matches_pallas_interpret():
    """K3's plain version at the generic path's 6 + 5 columns vs
    segment_reduce_scan_pallas at 16 rows, gathered at the segment ends
    (composite_pallas.py:751-763)."""
    rng = np.random.default_rng(6)
    n, p = 300, 2048
    counts = rng.multinomial(p, rng.dirichlet(np.ones(n) * 0.5)).astype(np.int32)
    counts[rng.uniform(size=n) < 0.1] = 0
    counts[0] += p - counts.sum()
    grouped = np.zeros((16, p), np.float32)
    grouped[:11] = rng.normal(size=(11, p))
    dst = rng.permutation(p).astype(np.int32)
    gid = np.repeat(np.arange(n), counts).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        scanned = np.asarray(segment_reduce_scan_pallas(jnp.asarray(grouped), jnp.asarray(gid)))
    offsets = np.cumsum(counts) - counts
    ends = np.clip(offsets + counts - 1, 0, None)
    ref = np.where(counts[:, None] > 0, scanned[:11, ends].T, 0.0)

    dpair = np.empty((p, 11), np.float32)
    dpair[dst] = grouped[:11].T
    mine = composite.segment_reduce(torch.tensor(dpair), torch.tensor(dst),
                                    torch.tensor(offsets.astype(np.int32)),
                                    torch.tensor(counts))
    assert mine.shape == (n, 11)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-5)


def _pairs(seed):
    """Per-Gaussian attrs and a fresh binning of the test scene."""
    s = _scene(n=256, seed=seed, iso=False)
    t = {k: torch.tensor(v) for k, v in s.items()}
    proj, aux = api.project_gaussians(CAM, t["means"], t["quats"], t["logit"], t["logsc"],
                                      t["active"])
    b = api.binning_mod.build_bins(proj, aux, CAM.width, CAM.height)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], t["rgb"], d, d * d], 1)
    return attrs.contiguous(), b


def test_per_pair_rows_equal_per_gaussian_rows():
    """K1 and K2 on per-pair rows (no index) equal their per-Gaussian mode."""
    attrs, b = _pairs(7)
    rows = attrs[b.pair_gauss.long()].contiguous()
    a = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, 64, 48)
    p = composite.composite_forward(rows, None, b.tile_start, 64, 48)
    assert torch.equal(a, p)
    g = torch.tensor(np.random.default_rng(8).normal(size=(6, 48, 64)).astype(np.float32))
    da = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, 64, 48, a, g)
    dp = composite.composite_backward(rows, None, b.tile_start, 64, 48, p, g)
    assert da.shape == (b.n_pairs, 11) and torch.equal(da, dp)


def test_backward_plain_is_the_gradient_of_forward_plain():
    """K2's plain version (the reverse walk) equals autograd through K1's
    plain version with respect to the per-pair rows, every column within
    1e-4 of the largest gradient (float32, two summation orders); the
    silhouette cotangent alone gives a non-zero gradient too."""
    attrs, b = _pairs(9)
    rows = attrs[b.pair_gauss.long()].detach().clone()
    rng = np.random.default_rng(10)
    for g in (rng.normal(size=(6, 48, 64)), np.eye(6)[5][:, None, None] * np.ones((6, 48, 64))):
        g = torch.tensor(g.astype(np.float32))
        leaf = rows.clone().requires_grad_(True)
        out = composite.composite_forward_plain(leaf, None, b.tile_start, 64, 48)
        (ref,) = torch.autograd.grad(out[:6], leaf, g)
        got = composite.composite_backward_plain(rows, None, b.tile_start, 64, 48,
                                                 out.detach(), g)
        assert float(ref.abs().max()) > 0
        torch.testing.assert_close(got, ref, atol=1e-4 * float(ref.abs().max()), rtol=0)
