"""The port's fused isotropic render (K4 forward, K5 backward, the pose
contraction and K3) against the JAX package's `tiles` backend, as
tests/test_fused_iso.py holds the Pallas pair to it.

Tolerances (the JAX suite's for its fused path): tracking loss rtol 2e-4
and pose grads 2e-4 * max|grad|; mapping loss rtol 2e-4 and the parameter
grads 3e-4 * max|grad|; depth and silhouette images 2e-4 and 1e-4. The
tiles backend composites with log-space chunked products, the port
sequentially per pixel, so the two differ by float32 reassociation.
The kernels themselves are held to the plain versions in
tests/test_torch_kernels.py (CUDA only). K4 and K5 read the world rows per
sorted pair or per Gaussian through the pairs' Gaussian indices: the plain
versions' two modes must agree exactly, and mapping must take the second
(no per-pair copy of the rows).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.core.gaussians import GaussianMap as JMap
from splatam_tpu.render.api import RenderConfig
from splatam_tpu.slam import steps as jsteps
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.render import fused_iso
from splatam_tpu_torch.slam import steps

JCAM = JCamera(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CAM = Camera(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CFG_T = RenderConfig(backend="tiles", pair_cap=1 << 12, tile_k_max=512)
FIELDS = dict(use_sil_for_loss=True, sil_thres=0.5, use_l1=True,
              ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0)
J_TRACK, T_TRACK = jsteps.PhaseConfig(**FIELDS), steps.PhaseConfig(**FIELDS)
FIELDS_MAP = dict(FIELDS, use_sil_for_loss=False)
J_MAP, T_MAP = jsteps.PhaseConfig(**FIELDS_MAP), steps.PhaseConfig(**FIELDS_MAP)
Q = np.asarray([0.99, 0.02, -0.03, 0.01], np.float32)
T = np.asarray([0.02, -0.01, 0.03], np.float32)


def _maps(n=384, seed=0):
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
    return (JMap(**{k: jnp.asarray(v) for k, v in f.items()}),
            GaussianMap(**{k: torch.tensor(v) for k, v in f.items()}))


def _frame(seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (3, 48, 64)).astype(np.float32),
            rng.uniform(1.0, 4.0, (48, 64)).astype(np.float32))


def test_tracking_loss_and_pose_grads_match_jax():
    jgm, tgm = _maps()
    color, depth = _frame(3)

    def jloss(qt):
        ps = jsteps.loss_pair_structure(jgm, jnp.asarray(Q), jnp.asarray(T), JCAM, CFG_T)
        return jsteps.get_loss(jgm, qt[0], qt[1], jnp.asarray(color), jnp.asarray(depth),
                               JCAM, J_TRACK, CFG_T, True, False, pair_structure=ps)[0]

    loss_j, (dq_j, dt_j) = jax.jit(jax.value_and_grad(jloss))((jnp.asarray(Q), jnp.asarray(T)))

    q, t = torch.tensor(Q, requires_grad=True), torch.tensor(T, requires_grad=True)
    ps = steps.loss_pair_structure(tgm, q, t, CAM, with_world16=True)
    loss, _ = steps.get_loss(tgm, q, t, torch.tensor(color), torch.tensor(depth), CAM,
                             T_TRACK, True, False, ps)
    dq, dt = torch.autograd.grad(loss, (q, t))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=2e-4)
    for mine, ref in ((dq, dq_j), (dt, dt_j)):
        ref = np.asarray(ref)
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(mine.numpy(), ref, atol=2e-4 * scale, rtol=2e-3)


def test_mapping_loss_and_param_grads_match_jax():
    jgm, tgm = _maps(seed=1)
    color, depth = _frame(4)
    jq, jt = jnp.asarray(Q), jnp.asarray(T)
    ps_j = jsteps.loss_pair_structure(jgm, jq, jt, JCAM, CFG_T)

    def jloss(params):
        g2 = jgm._replace(means3d=params[0], rgb_colors=params[1],
                          logit_opacities=params[2], log_scales=params[3])
        return jsteps.get_loss(g2, jq, jt, jnp.asarray(color), jnp.asarray(depth), JCAM,
                               J_MAP, CFG_T, False, True, pair_structure=ps_j)[0]

    jparams = (jgm.means3d, jgm.rgb_colors, jgm.logit_opacities, jgm.log_scales)
    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(jparams)

    q, t = torch.tensor(Q), torch.tensor(T)
    ps = steps.loss_pair_structure(tgm, q, t, CAM)
    params = tuple(x.clone().requires_grad_(True) for x in (
        tgm.means3d, tgm.rgb_colors, tgm.logit_opacities, tgm.log_scales))
    g2 = tgm._replace(means3d=params[0], rgb_colors=params[1], logit_opacities=params[2],
                      log_scales=params[3])
    loss, _ = steps.get_loss(g2, q, t, torch.tensor(color), torch.tensor(depth), CAM, T_MAP,
                             False, True, ps)
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=2e-4)
    for name, mine, ref in zip(("means3d", "rgb", "logit_op", "log_scales"), grads, grads_j):
        ref = np.asarray(ref)
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(mine.numpy(), ref, atol=3e-4 * scale, rtol=3e-3,
                                   err_msg=name)


def test_forward_images_match_jax():
    jgm, tgm = _maps(seed=2)
    color, depth = _frame(5)
    jq, jt = jnp.asarray(Q), jnp.asarray(T)
    ps_j = jsteps.loss_pair_structure(jgm, jq, jt, JCAM, CFG_T)
    _, aux_j = jax.jit(lambda: jsteps.get_loss(
        jgm, jq, jt, jnp.asarray(color), jnp.asarray(depth), JCAM, J_MAP, CFG_T, False, True,
        pair_structure=ps_j))()
    q, t = torch.tensor(Q), torch.tensor(T)
    ps = steps.loss_pair_structure(tgm, q, t, CAM)
    with torch.no_grad():
        _, aux = steps.get_loss(tgm, q, t, torch.tensor(color), torch.tensor(depth), CAM,
                                T_MAP, False, True, ps)
    np.testing.assert_allclose(aux.render_depth.numpy(), np.asarray(aux_j.render_depth),
                               atol=2e-4)
    np.testing.assert_allclose(aux.silhouette.numpy(), np.asarray(aux_j.silhouette),
                               atol=1e-4)


def _pair_inputs(tgm, cam):
    q, t = torch.tensor(Q), torch.tensor(T)
    ps = steps.loss_pair_structure(tgm, q, t, cam, with_world16=True)
    rmat = fused_iso.build_rotation(fused_iso.normalize(q)[None])[0]
    limx, limy = 1.3 * cam.width / (2 * cam.fx), 1.3 * cam.height / (2 * cam.fy)
    pose = fused_iso.make_pose_vec(rmat, t, cam.width, cam.height, cam.fx, cam.fy, cam.cx,
                                   cam.cy, limx, limy)
    return ps, pose


def test_plain_backward_is_the_gradient_of_plain_forward():
    """K5's plain version (reverse walk + projection chain) equals autograd
    through K4's plain version w.r.t. the per-pair world rows; 1e-4 of the
    largest gradient (float32, two summation orders)."""
    _, tgm = _maps(n=200, seed=6)
    ps, pose = _pair_inputs(tgm, CAM)
    rng = np.random.default_rng(7)
    g = torch.tensor(rng.normal(size=(6, 48, 64)).astype(np.float32))
    w8 = ps.world8.clone().requires_grad_(True)
    out = fused_iso.fused_forward_plain(w8, pose, ps.tile_start, 64, 48)
    (ref,) = torch.autograd.grad(out[:6], w8, g)
    got = fused_iso.fused_backward_plain(ps.world8, pose, ps.tile_start, 64, 48, out.detach(), g)
    torch.testing.assert_close(got, ref, atol=1e-4 * float(ref.abs().max()), rtol=0)


def test_plain_versions_agree_in_both_input_modes():
    """fused_forward_plain and fused_backward_plain on per-Gaussian rows read
    through pair_gauss equal the same calls on the gathered per-pair rows
    exactly (the gather is the only difference)."""
    _, tgm = _maps(n=200, seed=8)
    ps, pose = _pair_inputs(tgm, CAM)
    table = fused_iso.pack_world8(tgm.means3d, tgm.logit_opacities, tgm.log_scales,
                                  tgm.rgb_colors, tgm.active)
    assert ps.pair_gauss.dtype == torch.int32 and table.shape[0] != ps.n_pairs
    assert torch.equal(table[ps.pair_gauss.long()], ps.world8)
    g = torch.tensor(np.random.default_rng(9).normal(size=(6, 48, 64)).astype(np.float32))
    out = fused_iso.fused_forward(ps.world8, pose, ps.tile_start, 64, 48)
    assert torch.equal(fused_iso.fused_forward(table, pose, ps.tile_start, 64, 48, ps.pair_gauss),
                       out)
    d = fused_iso.fused_backward(ps.world8, pose, ps.tile_start, 64, 48, out, g)
    d_idx = fused_iso.fused_backward(table, pose, ps.tile_start, 64, 48, out, g, ps.pair_gauss)
    assert d_idx.shape == (ps.n_pairs, 8) and torch.equal(d_idx, d)
    assert float(d.abs().max()) > 0


def test_mapping_render_reads_the_rows_through_the_index(monkeypatch):
    """FusedGauss hands K4 and K5 the per-Gaussian rows [N, 8] and the
    structure's pair_gauss, and its gradients are those of the gathered-rows
    formulation (autograd through the gather and the plain forward)."""
    _, tgm = _maps(n=200, seed=10)
    q, t = torch.tensor(Q), torch.tensor(T)
    ps = steps.loss_pair_structure(tgm, q, t, CAM)
    seen = []
    fwd, bwd = fused_iso.fused_forward, fused_iso.fused_backward

    def spy(fn):
        def call(world8, *args):
            seen.append((world8.shape, args[-1]))
            return fn(world8, *args)
        return call

    monkeypatch.setattr(fused_iso, "fused_forward", spy(fwd))
    monkeypatch.setattr(fused_iso, "fused_backward", spy(bwd))
    params = tuple(x.clone().requires_grad_(True) for x in (
        tgm.means3d, tgm.logit_opacities, tgm.log_scales, tgm.rgb_colors))
    img = fused_iso.composite_fused_gauss(*params, tgm.active, ps, CAM, q, t)
    g = torch.tensor(np.random.default_rng(11).normal(size=(6, 48, 64)).astype(np.float32))
    grads = torch.autograd.grad(img, params, g)
    assert [s for s, _ in seen] == [(tgm.capacity, 8)] * 2
    assert all(idx is ps.pair_gauss for _, idx in seen)

    rows = fused_iso.pack_world8(*params, tgm.active)
    _, pose = _pair_inputs(tgm, CAM)
    ref_img = fwd(rows[ps.pair_gauss.long()], pose, ps.tile_start, 64, 48)[:6]
    ref = torch.autograd.grad(ref_img, params, g)
    assert torch.equal(img, ref_img.detach())
    for mine, want in zip(grads, ref):
        torch.testing.assert_close(mine, want, atol=1e-4 * float(want.abs().max()), rtol=0)
