"""The port's SLAM loop against the JAX package's, end to end.

Both SLAMRuntimes run bench.py's frame order for 3 frames of the micro
config (tests/test_slam_pipeline.py's, with rebin_every=8 so the port's
fused path is the one under test); the JAX side uses the `tiles` backend.
Both draw keyframes from np.random with the same seed. Per-frame poses
must agree within 1e-4 (float32 reassociation through ~20 optimizer steps
per frame; the observed gap is ~1e-6) and the active Gaussian counts
exactly. Final map means: Adam (eps 1e-15) turns a Gaussian whose
gradient is at float noise into full lr-sized steps of either sign, so
single entries may differ by up to lr * iterations (8e-4 per frame); at
least 99% of entries must agree within 1e-5.
"""
import copy
import os

import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch  # noqa: F401

from splatam_tpu.slam.config import load_experiment_config, seed_everything
from splatam_tpu.slam.pipeline import SLAMRuntime as JRuntime, _frame_to_device
from splatam_tpu_torch.core.gaussians import compact_to_numpy
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame

CONFIG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "synthetic", "splatam.py")
FRAMES = 3


def _config(tmp_path):
    config = copy.deepcopy(load_experiment_config(CONFIG_PATH))
    config["workdir"] = str(tmp_path)
    config["data"].update(desired_image_height=48, desired_image_width=64, num_frames=FRAMES)
    config["tracking"]["num_iters"] = 6
    config["mapping"]["num_iters"] = 8
    config["mapping_window_size"] = 5
    config["keyframe_every"] = 2
    config["tpu"] = dict(capacity=1 << 13, pair_cap=1 << 15, tile_k_max=2048,
                         backend="tiles", rebin_every=8)
    return config


def _jax_frame(rt, time_idx):
    """bench.py:92-154, verbatim order."""
    color_np, depth_np, _, gt_pose = rt.dataset[time_idx]
    rt.gt_w2c_all.append(np.linalg.inv(gt_pose))
    color, depth = _frame_to_device(color_np, depth_np)
    if time_idx > 0:
        if time_idx > 1:
            p1 = rt.cam_rots[time_idx - 1] / np.linalg.norm(rt.cam_rots[time_idx - 1])
            p2 = rt.cam_rots[time_idx - 2] / np.linalg.norm(rt.cam_rots[time_idx - 2])
            nr = p1 + (p1 - p2)
            rt.cam_rots[time_idx] = nr / np.linalg.norm(nr)
            rt.cam_trans[time_idx] = rt.cam_trans[time_idx - 1] + (
                rt.cam_trans[time_idx - 1] - rt.cam_trans[time_idx - 2])
        else:
            rt.cam_rots[time_idx] = rt.cam_rots[time_idx - 1]
            rt.cam_trans[time_idx] = rt.cam_trans[time_idx - 1]
    rt.compact()
    if time_idx > 0:
        rt.track_frame(time_idx, color, depth)
        rt.densify_frame(time_idx, color, depth)
    selected = rt.select_keyframes(time_idx, depth_np)
    rt._stage_keyframe(rt.kf_scratch_slot, color_np, depth_np)
    rt.map_frame(time_idx, selected)
    if time_idx == 0 or (time_idx + 1) % rt.config["keyframe_every"] == 0:
        slot = len(rt.keyframe_list)
        rt._stage_keyframe(slot, color_np, depth_np)
        rt.keyframe_list.append({"id": time_idx, "slot": slot,
                                 "q": rt.cam_rots[time_idx].copy(),
                                 "t": rt.cam_trans[time_idx].copy()})
        rt.keyframe_time_indices.append(time_idx)


def test_slam_loop_matches_jax(tmp_path):
    seed_everything(0)
    jrt = JRuntime(_config(tmp_path))
    j_active = []
    for i in range(FRAMES):
        _jax_frame(jrt, i)
        j_active.append(int(jrt.gm.num_active()))
    jrt.shutdown()

    seed_everything(0)
    rt = SLAMRuntime(_config(tmp_path), "cpu")
    t_active = []
    for i in range(FRAMES):
        run_frame(rt, i)
        t_active.append(rt.gm.num_active())

    assert t_active == j_active
    assert t_active[-1] > t_active[0]  # densification added Gaussians
    np.testing.assert_allclose(rt.cam_rots, jrt.cam_rots, atol=1e-4)
    np.testing.assert_allclose(rt.cam_trans, jrt.cam_trans, atol=1e-4)
    assert np.abs(rt.cam_trans[-1]).max() > 1e-3  # the camera moved
    assert [k["id"] for k in rt.keyframe_list] == [k["id"] for k in jrt.keyframe_list]
    from splatam_tpu.core.gaussians import compact_to_numpy as j_compact

    mine, ref = compact_to_numpy(rt.gm), j_compact(jrt.gm)
    diff = np.abs(mine["means3D"] - ref["means3D"])
    lr = rt.config["mapping"]["lrs"]["means3D"]
    assert diff.max() <= lr * rt.config["mapping"]["num_iters"] * FRAMES, diff.max()
    assert np.mean(diff > 1e-5) <= 0.01, np.mean(diff > 1e-5)
    assert np.isfinite(mine["log_scales"]).all()


@pytest.mark.parametrize("override, item", [
    ({"tpu": {"rebin_every": 1}}, "TPU kernel list item 5"),
    ({"gaussian_distribution": "anisotropic"}, "TPU kernel list item 5"),
    ({"tracking": {"coarse_to_fine": {"enabled": True}}}, "module list item 5"),
    ({"tpu": {"spatial_shards": 2}}, "module list item 9"),
    ({"mapping": {"use_gaussian_splatting_densification": True}}, "module list item 7"),
])
def test_unported_configurations_raise(tmp_path, override, item):
    config = _config(tmp_path)
    for key, value in override.items():
        if isinstance(value, dict):
            config[key].update(value)
        else:
            config[key] = value
    with pytest.raises(NotImplementedError, match=item):
        SLAMRuntime(config, "cpu")
