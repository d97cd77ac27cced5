"""The PyTorch port's core modules against the JAX package, on shared numpy
inputs: transforms, camera, the masked map (round trip and compaction),
SSIM/PSNR/L1 and Adam. Also checks that the port never loads jax.

Tolerances: float32 elementwise math in both frameworks -> 1e-6 absolute
(rounding order only); SSIM sums ~2k products per pixel -> 1e-6; Adam
after 5 steps -> 1e-5 against JAX (which rounds the bias corrections to
float32; the port keeps them in Python floats like torch.optim.Adam) and
1e-6 against torch.optim.Adam itself.
"""
import os
import subprocess
import sys

import numpy as np
import jax  # noqa: F401
import jax.numpy as jnp
import torch

from splatam_tpu.core import camera as jcam
from splatam_tpu.core import gaussians as jG
from splatam_tpu.core import losses as jlosses
from splatam_tpu.core import transforms as jT
from splatam_tpu.slam import optim as joptim
from splatam_tpu_torch.core import camera as tcam
from splatam_tpu_torch.core import gaussians as tG
from splatam_tpu_torch.core import losses as tlosses
from splatam_tpu_torch.core import transforms as tT
from splatam_tpu_torch.slam import optim as toptim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(16, 4)).astype(np.float32)
    q2 = rng.normal(size=(16, 4)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    _close(tT.normalize(torch.tensor(q1)), jT.normalize(jnp.asarray(q1)))
    _close(tT.quat_mult(torch.tensor(q1), torch.tensor(q2)),
           jT.quat_mult(jnp.asarray(q1), jnp.asarray(q2)), atol=2e-6)
    rot_t = tT.build_rotation(torch.tensor(q1))
    _close(rot_t, jT.build_rotation(jnp.asarray(q1)))
    _close(tT.matrix_to_quaternion(rot_t),
           jT.matrix_to_quaternion(jnp.asarray(rot_t.numpy())), atol=2e-6)
    _close(tT.pose_to_w2c(torch.tensor(q1[0]), torch.tensor(t)),
           jT.pose_to_w2c(jnp.asarray(q1[0]), jnp.asarray(t)))


def test_setup_camera_matches_jax():
    k = np.array([[500.0, 0, 320.5], [0, 510.0, 240.25], [0, 0, 1]])
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, 0.3]
    a = jcam.setup_camera(640, 480, k, w2c)
    b = tcam.setup_camera(640, 480, k, w2c)
    assert tuple(a) == tuple(b)
    _close(b.w2c_tensor("cpu"), a.w2c_array())
    assert (a.tanfovx, a.tanfovy) == (b.tanfovx, b.tanfovy)


def _params(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "means3D": rng.normal(size=(n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(size=(n, 3)).astype(np.float32),
        "unnorm_rotations": rng.normal(size=(n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(size=(n, 1)).astype(np.float32),
        "log_scales": rng.normal(size=(n, 1)).astype(np.float32),
    }


def test_map_round_trip_matches_jax():
    params = _params(37, 1)
    jm = jG.from_params_dict(params, capacity=64)
    tm = tG.from_params_dict(params, "cpu", capacity=64)
    for name in tG.GaussianMap._fields:
        _close(getattr(tm, name), getattr(jm, name), atol=0)
    assert tm.num_active() == int(jm.num_active())
    back_t, back_j = tG.compact_to_numpy(tm), jG.compact_to_numpy(jm)
    for k in back_j:
        _close(back_t[k], back_j[k], atol=0)
    fields = {k: np.asarray(getattr(jm, k)) for k in jG.GaussianMap._fields}
    tm2 = tG.from_jax_numpy(fields, "cpu")
    for name in tG.GaussianMap._fields:
        _close(getattr(tm2, name), fields[name], atol=0)
    grown = tG.grow_capacity(tm, 100)
    assert grown.capacity == 100 and grown.num_active() == 37


def test_compact_matches_jax_slot_for_slot():
    """Like test_components' compaction check: a map with holes compacts to
    the same slot order in both packages."""
    params = _params(50, 2)
    jm = jG.from_params_dict(params, capacity=64)
    rng = np.random.default_rng(3)
    holes = rng.uniform(size=64) < 0.3
    jm = jm._replace(active=jm.active & ~jnp.asarray(holes))
    ts = np.arange(64, dtype=np.float32)
    fields = {k: np.asarray(getattr(jm, k)) for k in jG.GaussianMap._fields}
    tm = tG.from_jax_numpy(fields, "cpu")
    jc, jts = jG.compact(jm, jnp.asarray(ts))
    tc, tts = tG.compact(tm, torch.tensor(ts))
    for name in tG.GaussianMap._fields:
        _close(getattr(tc, name), getattr(jc, name), atol=0)
    _close(tts, jts, atol=0)
    n = tc.num_active()
    assert tc.span() == n and bool(tc.active[:n].all())


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)
    ta, tb, ja, jb = torch.tensor(a), torch.tensor(b), jnp.asarray(a), jnp.asarray(b)
    _close(tlosses.calc_ssim(ta, tb), jlosses.calc_ssim(ja, jb))
    _close(tlosses.calc_ssim(ta, tb, size_average=False),
           jlosses.calc_ssim(ja, jb, size_average=False))
    _close(tlosses.calc_psnr(ta, tb), jlosses.calc_psnr(ja, jb), atol=1e-4)
    _close(tlosses.l1_loss_v1(ta, tb), jlosses.l1_loss_v1(ja, jb))


def test_adam_matches_jax():
    rng = np.random.default_rng(5)
    p0 = (rng.normal(size=(20, 3)).astype(np.float32), rng.normal(size=(20,)).astype(np.float32))
    grads = [tuple(rng.normal(size=x.shape).astype(np.float32) for x in p0) for _ in range(5)]
    lrs = (0.01, 0.05)
    for eps in (1e-8, 1e-15):
        tp = tuple(torch.tensor(x) for x in p0)
        jp = tuple(jnp.asarray(x) for x in p0)
        ts, js = toptim.adam_init(tp), joptim.adam_init(jp)
        for g in grads:
            tp, ts = toptim.adam_step(ts, tp, tuple(torch.tensor(x) for x in g), lrs, eps)
            jp, js = joptim.adam_step(js, jp, tuple(jnp.asarray(x) for x in g),
                                      tuple(jnp.float32(x) for x in lrs), eps)
        for a, b in zip(tp, jp):
            _close(a, b, atol=1e-5)
        ref = [torch.nn.Parameter(torch.tensor(x)) for x in p0]
        opt = torch.optim.Adam([{"params": [r], "lr": lr} for r, lr in zip(ref, lrs)], eps=eps)
        for g in grads:
            for r, x in zip(ref, g):
                r.grad = torch.tensor(x)
            opt.step()
        for a, b in zip(tp, ref):
            _close(a, b.detach())
    mask = torch.zeros(20, dtype=torch.bool)
    mask[3] = True
    reset = toptim.reset_slots(ts, mask)
    assert float(reset.m[0][3].abs().sum()) == 0.0 and float(reset.v[1][3]) == 0.0
    assert float(reset.m[0][4].abs().sum()) > 0.0


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax (and the loaders'
    cv2 / imageio / yaml, which the GPU machine lacks) out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import splatam_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'splatam_tpu.')))\n"
        "bad += [k for k in ('cv2', 'imageio', 'yaml') if k in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr
