"""The port's fused isotropic render (K4 forward, K5 backward, the pose
contraction and K3) against the JAX package's `tiles` backend, as
tests/test_fused_iso.py holds the Pallas pair to it.

Tolerances (the JAX suite's for its fused path): tracking loss rtol 2e-4
and pose grads 2e-4 * max|grad|; mapping loss rtol 2e-4 and the parameter
grads 3e-4 * max|grad|; depth and silhouette images 2e-4 and 1e-4. The
tiles backend composites with log-space chunked products, the port
sequentially per pixel, so the two differ by float32 reassociation.
The kernels themselves are held to the plain versions in
tests/test_torch_kernels.py (CUDA only).
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
    ps = steps.loss_pair_structure(tgm, q, t, CAM, with_world8=True)
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
    ps = steps.loss_pair_structure(tgm, q, t, cam, with_world8=True)
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
