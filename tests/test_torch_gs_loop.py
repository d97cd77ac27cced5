"""rgbd_slam's frame with in-loop 3DGS densification
(mapping.use_gaussian_splatting_densification) in the port against the JAX
package: tests/test_slam_pipeline.py:117-143's config (the micro config
with ground-truth poses, densify_dict start_after=2, densify_every=2,
stop_after=8, grad_thresh=0.01) for 3 frames, at rebin_every=8 and at 1.

Mapping harvests the screen-space statistics through the generic render
at both settings (the fused mapping render forms none, get_loss's gate),
runs in chunks of 2 iterations with the Adam state and the statistics
carried, densifies at full capacity between chunks and compacts. The
port's split noise is the JAX package's draws (test_torch_gs.
jax_split_noise; the generator's seed is seed * 9973 + frame in both), at
a capacity where the JAX package never overflows (it skips a pass when it
does; the port grows first). Harness and tolerances: tests/
test_torch_slam.py (poses within 1e-4, equal active counts after every
frame, 99% of the map's means within 1e-5).
"""
import pytest
import torch

from splatam_tpu.slam import steps_gs as jsteps_gs
from splatam_tpu_torch.slam import steps_gs
from test_torch_gs import jax_split_noise
from test_torch_slam import _config, assert_loops_match, run_both

torch.set_num_threads(1)  # see tests/test_torch_slam.py

DENSIFY = dict(start_after=2, remove_big_after=4, stop_after=8, densify_every=2,
               grad_thresh=0.01, num_to_split_into=2, removal_opacity_threshold=0.005,
               final_removal_opacity_threshold=0.005, reset_opacities=False,
               reset_opacities_every=500)


def _gs_config(tmp_path, **overrides):
    """tests/test_slam_pipeline.py's small_config with in-loop 3DGS."""
    config = _config(tmp_path, **overrides)
    config["tracking"].update(num_iters=8, use_gt_poses=True)
    config["mapping"].update(num_iters=16, use_gaussian_splatting_densification=True,
                             densify_dict=dict(DENSIFY))
    config["tpu"]["capacity"] = 1 << 15
    return config


@pytest.mark.parametrize("rebin", [8, 1], ids=["rebin8", "rebin1"])
def test_in_loop_3dgs_matches_jax(tmp_path, monkeypatch, rebin):
    overflows = []
    step = jsteps_gs.densify_3dgs_step

    def jax_step(*args, **kwargs):
        out = step(*args, **kwargs)
        overflows.append(int(out[3]))
        return out

    monkeypatch.setattr(jsteps_gs, "densify_3dgs_step", jax_step)
    monkeypatch.setattr(steps_gs, "split_noise", jax_split_noise(0))
    rt, jrt, t_active, j_active = run_both(tmp_path, make_config=_gs_config,
                                           tpu={"rebin_every": rebin})
    assert len(overflows) > 0 and not any(overflows), overflows
    assert len(rt.gs_passes) == len(overflows)
    assert any(p["cloned"] + p["split"] for p in rt.gs_passes)
    assert_loops_match(rt, jrt, t_active, j_active)
