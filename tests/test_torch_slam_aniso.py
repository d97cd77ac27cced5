"""The port's SLAM loop against the JAX package's on an anisotropic map
(gaussian_distribution="anisotropic", log_scales [N, 3]) at
tpu.rebin_every=8: tracking renders in pair space from world-16 rows
(per-pair projection, K1 and K2 on per-pair rows, pose gradients by
autograd of the projection), mapping through the generic render with
reused structures (K1 -> K2 -> K3). Harness, micro config and tolerances:
tests/test_torch_slam.py; the [N, 3] log-scales are held like the means.
The rotations, which the anisotropic map optimises, only have to stay
finite: every Gaussian starts with three equal scales (densification
writes one scale per point), so its rotation gradient starts as float
noise that Adam (eps 1e-15) turns into steps of up to a few lr of either
sign in both packages (18% of the entries differ by more than 1e-5 after
3 frames; the render-level rotation gradients are compared in
test_torch_generic_render.py).
"""
import numpy as np

from test_torch_slam import assert_loops_match, run_both


def test_slam_loop_anisotropic_matches_jax(tmp_path):
    rt, jrt, *counts = run_both(tmp_path, gaussian_distribution="anisotropic")
    assert not rt.gm.isotropic and rt.gm.log_scales.shape[1] == 3
    mine, ref = assert_loops_match(rt, jrt, *counts)
    scales = np.abs(mine["log_scales"] - ref["log_scales"])
    assert np.mean(scales > 1e-5) <= 0.01, np.mean(scales > 1e-5)
    assert np.isfinite(mine["unnorm_rotations"]).all()


def test_slam_loop_anisotropic_rebin_every_1_matches_jax(tmp_path):
    """Anisotropic at rebin_every=1: both phases take the generic render
    with no structure (test_torch_slam_rebin1.py's route)."""
    rt, jrt, *counts = run_both(tmp_path, gaussian_distribution="anisotropic",
                                tpu={"rebin_every": 1})
    mine, _ = assert_loops_match(rt, jrt, *counts)
    assert np.isfinite(mine["unnorm_rotations"]).all()
