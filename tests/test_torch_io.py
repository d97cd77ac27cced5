"""The port's params.npz, PLY and ATE modules against the JAX package's.

All three are numpy code the port keeps a copy of (importing the JAX
package's would import jax), so the two must agree exactly: params.npz
round-trips every key with its shape and dtype; save_ply writes the same
bytes from the same arrays, and load_ply reads them back (colours through
the SH-DC constant, within 1e-6); evaluate_ate within 1e-9 on seeded
trajectories.
"""
import numpy as np
import jax  # noqa: F401  (both frameworks in one process: import both first)

from splatam_tpu.eval import ate as jate
from splatam_tpu.io import ply as jply
from splatam_tpu_torch.eval import ate as tate
from splatam_tpu_torch.io import params_io, ply as tply


def _splat(n=257, s=1, seed=0):
    rng = np.random.default_rng(seed)
    return dict(means3D=rng.normal(size=(n, 3)).astype(np.float32),
                rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
                logit_opacities=rng.normal(size=(n, 1)).astype(np.float32),
                log_scales=rng.normal(-4, 1, (n, s)).astype(np.float32))


def test_params_round_trip(tmp_path):
    params = _splat()
    params.update(cam_unnorm_rots=np.ones((1, 4, 5), np.float32),
                  cam_trans=np.zeros((1, 3, 5), np.float32),
                  timestep=np.arange(257, dtype=np.float32), intrinsics=np.eye(3, dtype=np.float32),
                  w2c=np.eye(4, dtype=np.float32), org_width=64, org_height=48,
                  gt_w2c_all_frames=np.tile(np.eye(4, dtype=np.float32), (5, 1, 1)),
                  keyframe_time_indices=np.array([0, 4]))
    params_io.save_params(params, str(tmp_path))
    params_io.save_params_ckpt(params, str(tmp_path), 3)
    for name in ("params.npz", "params3.npz"):
        back = params_io.load_params(str(tmp_path / name))
        assert sorted(back) == sorted(params)
        for k, v in params.items():
            v = np.asarray(v)
            assert back[k].shape == v.shape and back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v)


def test_ply_bytes_equal_and_read_back(tmp_path):
    for s in (1, 3):
        p = _splat(s=s, seed=s)
        args = (p["means3D"], p["log_scales"], p["unnorm_rotations"], p["rgb_colors"],
                p["logit_opacities"])
        tply.save_ply(str(tmp_path / "port.ply"), *args)
        jply.save_ply(str(tmp_path / "jax.ply"), *args)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
        back = tply.load_ply(str(tmp_path / "port.ply"))
        np.testing.assert_array_equal(back["means3D"], p["means3D"])
        np.testing.assert_array_equal(back["log_scales"], np.tile(p["log_scales"], (1, 3 // s)))
        np.testing.assert_array_equal(back["unnorm_rotations"], p["unnorm_rotations"])
        np.testing.assert_array_equal(back["logit_opacities"], p["logit_opacities"])
        np.testing.assert_allclose(back["rgb_colors"], p["rgb_colors"], atol=1e-6)
        assert not back["normals"].any()


def test_evaluate_ate_matches_jax():
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 40):
        gt, est = [], []
        for _ in range(n):
            a, b = np.eye(4), np.eye(4)
            a[:3, 3] = rng.normal(size=3)
            b[:3, 3] = a[:3, 3] + rng.normal(0, 0.05, 3)
            gt.append(a.astype(np.float32))
            est.append(b.astype(np.float32))
        mine, ref = tate.evaluate_ate(gt, est), jate.evaluate_ate(gt, est)
        assert abs(mine - ref) <= 1e-9, (n, mine, ref)
        if n > 2:
            assert mine > 0
