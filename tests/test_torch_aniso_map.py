"""Anisotropic maps (log_scales [N, 3]) in the port against the JAX package:
building one from a point cloud, the round trip of a JAX map, the
world -> camera transform that rotates the Gaussians' quaternions, and
densification writing [n, 3] scales. Tolerances: 0 where both sides copy
or broadcast the same floats; 1e-6 for float32 elementwise math (rounding
order only); densification's render at the JAX suite's 1e-4.
"""
import numpy as np
import pytest
import jax  # noqa: F401
import jax.numpy as jnp
import torch

from splatam_tpu.core import gaussians as jG
from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.render.api import RenderConfig
from splatam_tpu.slam import steps as jsteps
from splatam_tpu_torch.core import gaussians as tG
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.slam import steps

# The port's plain compositing loops issue thousands of tiny ops; with
# several test workers on one machine, torch's default intra-op thread
# pool per worker oversubscribes the cores (measured on 8 cores with 6
# workers: >900 s instead of ~75 s for the port's end-to-end files), so
# one thread each.
torch.set_num_threads(1)

JCAM = JCamera(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CAM = Camera(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
Q = np.asarray([0.99, 0.02, -0.03, 0.01], np.float32)
T = np.asarray([0.02, -0.01, 0.03], np.float32)


def _cloud(m=300, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(m, 3)).astype(np.float32) + np.float32([0, 0, 3])
    return (pts, rng.uniform(size=(m, 3)).astype(np.float32),
            rng.uniform(1e-4, 1e-2, m).astype(np.float32), rng.uniform(size=m) > 0.2)


def _maps(iso, seed=1, capacity=512):
    """The same map in both packages, some of it moved off the identity
    rotation and the equal scales."""
    cloud = _cloud(seed=seed)
    jm = jG.from_pointcloud(*(jnp.asarray(x) for x in cloud), capacity, isotropic=iso)
    rng = np.random.default_rng(seed + 1)
    fields = {k: np.asarray(getattr(jm, k)) for k in jG.GaussianMap._fields}
    fields["unnorm_rotations"] = rng.normal(size=(capacity, 4)).astype(np.float32)
    fields["log_scales"] = fields["log_scales"] + rng.normal(
        0, 0.2, fields["log_scales"].shape).astype(np.float32)
    return jG.GaussianMap(**{k: jnp.asarray(v) for k, v in fields.items()}), \
        tG.from_jax_numpy(fields, "cpu")


def test_anisotropic_map_from_pointcloud_and_round_trip_match_jax():
    cloud = _cloud()
    jm = jG.from_pointcloud(*(jnp.asarray(x) for x in cloud), 512, isotropic=False)
    tm = tG.from_pointcloud(*(torch.tensor(x) for x in cloud), 512, isotropic=False)
    assert tm.log_scales.shape == (512, 3) and not tm.isotropic
    for name in tG.GaussianMap._fields:  # log_scales: two libraries' log, 1e-6
        np.testing.assert_allclose(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                   atol=1e-6 if name == "log_scales" else 0, rtol=0)
    fields = {k: np.asarray(getattr(jm, k)) for k in jG.GaussianMap._fields}
    back = tG.from_jax_numpy(fields, "cpu")
    assert back.log_scales.shape == (512, 3)
    for name in tG.GaussianMap._fields:
        np.testing.assert_array_equal(getattr(back, name).numpy(), fields[name])


@pytest.mark.parametrize("iso", [True, False], ids=["isotropic", "anisotropic"])
def test_transform_to_frame_matches_jax(iso):
    jm, tm = _maps(iso)
    jmeans, jrots = jsteps.transform_to_frame(jm, jnp.asarray(Q), jnp.asarray(T), True, True)
    tmeans, trots = steps.transform_to_frame(tm, torch.tensor(Q), torch.tensor(T), True, True)
    np.testing.assert_allclose(tmeans.numpy(), np.asarray(jmeans), atol=1e-6, rtol=0)
    np.testing.assert_allclose(trots.numpy(), np.asarray(jrots), atol=1e-6, rtol=0)
    if not iso:  # the camera rotates every Gaussian
        assert np.abs(trots.numpy() - tm.unnorm_rotations.numpy()).max() > 1e-2


def test_densify_writes_anisotropic_scales_like_jax():
    jm, tm = _maps(False, seed=3, capacity=4096)
    rng = np.random.default_rng(4)
    color = rng.uniform(size=(3, 48, 64)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, (48, 64)).astype(np.float32)
    ts = np.zeros(4096, np.float32)
    cfg = RenderConfig(backend="tiles", pair_cap=1 << 15, tile_k_max=2048)
    jg, jts, n_j, drop_j, _, _ = jsteps.densify_step(
        jm, jnp.asarray(ts), jnp.asarray(color), jnp.asarray(depth), jnp.asarray(Q),
        jnp.asarray(T), jnp.int32(5), JCAM, 0.5, cfg)
    tg, tts, n_t, drop_t = steps.densify_step(
        tm, torch.tensor(ts), torch.tensor(color), torch.tensor(depth), torch.tensor(Q),
        torch.tensor(T), 5, CAM, 0.5)
    assert (n_t, drop_t) == (int(n_j), int(drop_j)) and n_t > 0
    new = (tts.numpy() == 5.0)
    assert new.sum() == n_t and np.array_equal(new, np.asarray(jts) == 5.0)
    scales = tg.log_scales.numpy()
    assert scales.shape == (4096, 3)
    np.testing.assert_array_equal(scales[new][:, 0], scales[new][:, 2])  # one scale per point
    for name in tG.GaussianMap._fields:
        np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
