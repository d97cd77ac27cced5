"""The port's SLAM loop against the JAX package's at tpu.rebin_every=1
(reference semantics: every tracking and mapping iteration projects, bins
and composites from scratch), on an isotropic map: the generic render
(K1 forward, K2 -> K3 backward, the projection by autograd) in both
phases. Harness, micro config and tolerances: tests/test_torch_slam.py.

An isotropic map's rotations are not compared: they never enter a render
in the port, while the JAX package's Adam (eps 1e-15) turns their
float-noise gradients into lr-sized steps.
"""
from test_torch_slam import assert_loops_match, run_both


def test_slam_loop_rebin_every_1_matches_jax(tmp_path):
    rt, jrt, *_ = run_both(tmp_path, tpu={"rebin_every": 1})
    assert rt.rebin_every == 1 and rt.gm.isotropic
    assert_loops_match(rt, jrt, *_)
