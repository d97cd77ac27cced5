"""Coarse-to-fine tracking and separate tracking/densification sizes in the
port, against the JAX package.

- _downscale_camera (stride and pool conventions, factors 2 and 4) equals
  the JAX function field for field (the cameras of
  tests/test_coarse_to_fine.py:35,86), and _pool_target (a hole, a fully
  invalid block, factors 2 and 4, sizes that do not divide) agrees within
  1e-6 (tests/test_coarse_to_fine.py:106).
- End to end on the micro config (tests/test_torch_slam.py's harness,
  48x64): c2f levels [[2, 3]] with pooling over 3 frames; one tracking call
  (frame 1) at levels [[2, 4]] in stride mode, and one with c2f_extra_iters;
  densification at 24x32 over 3 frames. Poses within 1e-4 and equal active
  counts. (At [[2, 4]] over 3 frames frame 2's densification may add one
  Gaussian more in one package: a pixel on the silhouette threshold, which
  poses within 1e-4 can flip; tests/test_torch_c2f_flip.py checks that.)
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.slam.pipeline import _downscale_camera as j_downscale, _pool_target as j_pool
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.slam.pipeline import _downscale_camera, _pool_target
from test_torch_slam import run_both

torch.set_num_threads(1)  # see tests/test_torch_slam.py

FIELDS = ("height", "width", "fx", "fy", "cx", "cy")


@pytest.mark.parametrize("pool", [False, True], ids=["stride", "pool"])
@pytest.mark.parametrize("factor", [2, 4])
def test_downscale_camera_matches_jax(factor, pool):
    for h, w in ((120, 160), (121, 157)):
        kw = dict(height=h, width=w, fx=140.0, fy=141.5, cx=81.3, cy=59.2)
        mine = _downscale_camera(Camera(**kw), factor, pool=pool)
        ref = j_downscale(JCamera(**kw), factor, pool=pool)
        assert [getattr(mine, f) for f in FIELDS] == [getattr(ref, f) for f in FIELDS]


@pytest.mark.parametrize("factor, h, w", [(2, 8, 8), (2, 13, 17), (4, 30, 41)])
def test_pool_target_matches_jax(factor, h, w):
    rng = np.random.default_rng(h * w)
    color = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
    depth[0, 0] = 0.0  # a hole in the first block
    depth[factor: 2 * factor, factor: 2 * factor] = 0.0  # a fully invalid block
    depth[rng.uniform(size=(h, w)) < 0.2] = 0.0
    c, d = _pool_target(torch.tensor(color), torch.tensor(depth), factor)
    jc, jd = j_pool(jnp.asarray(color), jnp.asarray(depth), factor)
    assert tuple(c.shape) == jc.shape and tuple(d.shape) == jd.shape
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert float(d[1, 1]) == 0.0


def _poses_match(rt, jrt, t_active, j_active):
    assert t_active == j_active
    np.testing.assert_allclose(rt.cam_rots, jrt.cam_rots, atol=1e-4)
    np.testing.assert_allclose(rt.cam_trans, jrt.cam_trans, atol=1e-4)
    assert np.abs(rt.cam_trans[len(t_active) - 1]).max() > 1e-3  # the camera moved


def test_c2f_pool_loop_matches_jax(tmp_path):
    c2f = {"coarse_to_fine": {"enabled": True, "levels": [[2, 3]], "downsample": "pool"}}
    rt, jrt, t_active, j_active = run_both(tmp_path, tracking=c2f)
    _poses_match(rt, jrt, t_active, j_active)
    assert rt.iters_run == jrt._iters_run == 6  # 3 coarse + 3 full of num_iters=6


@pytest.mark.parametrize("extra", [False, True], ids=["stride", "c2f_extra_iters"])
def test_c2f_tracking_call_matches_jax(tmp_path, extra):
    """Frame 1's tracking: stride mode at factor 2, or pooling at factor 2
    with the coarse iterations on top of num_iters."""
    tracking = {"coarse_to_fine": {"enabled": True, "levels": [[2, 4]],
                                   "downsample": "pool" if extra else "stride"},
                "c2f_extra_iters": extra}
    rt, jrt, t_active, j_active = run_both(tmp_path, frames=2, tracking=tracking)
    _poses_match(rt, jrt, t_active, j_active)
    assert rt.iters_run == jrt._iters_run == (10 if extra else 6)


def test_densify_at_its_own_size_matches_jax(tmp_path):
    """data.densification_image_* at 24x32 beside the main 48x64: the map
    starts from the 24x32 frame and every densification reads it."""
    rt, jrt, t_active, j_active = run_both(
        tmp_path, data={"densification_image_height": 24, "densification_image_width": 32})
    assert (rt.densify_cam.height, rt.densify_cam.width) == (24, 32)
    assert [getattr(rt.densify_cam, f) for f in FIELDS] == \
        [getattr(jrt.densify_cam, f) for f in FIELDS]
    assert rt.tracking_cam == rt.cam and rt.tracking_dataset is None
    assert t_active[0] <= 24 * 32
    _poses_match(rt, jrt, t_active, j_active)
    assert rt.scene_radius == pytest.approx(float(jrt.scene_radius), rel=1e-6)
