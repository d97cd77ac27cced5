"""The port's SLAM loop against the JAX package's, end to end.

Both SLAMRuntimes run rgbd_slam's frame order (splatam_tpu/slam/
pipeline.py:1642-1760, without its logging and evaluation) for 3 frames
of the micro config (tests/test_slam_pipeline.py's, with rebin_every=8 so
the port's fused path is the one under test here; the generic path's
configurations are in test_torch_slam_rebin1.py and
test_torch_slam_aniso.py); the JAX side uses the `tiles` backend.
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
import torch

from splatam_tpu.slam.config import load_experiment_config, seed_everything
from splatam_tpu.slam.pipeline import SLAMRuntime as JRuntime, _frame_to_device, _quat_from_w2c
from splatam_tpu_torch.core.gaussians import compact_to_numpy
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame

# The port's plain compositing loops issue thousands of tiny ops; with
# several test workers on one machine, torch's default intra-op thread
# pool per worker oversubscribes the cores (measured on 8 cores with 6
# workers: >900 s instead of ~75 s for the port's end-to-end files), so
# one thread each.
torch.set_num_threads(1)

CONFIG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "synthetic", "splatam.py")
FRAMES = 3


def _config(tmp_path, **overrides):
    """The micro config; overrides update a section (dict) or set a key."""
    config = copy.deepcopy(load_experiment_config(CONFIG_PATH))
    config["workdir"] = str(tmp_path)
    config["data"].update(desired_image_height=48, desired_image_width=64, num_frames=FRAMES)
    config["tracking"]["num_iters"] = 6
    config["mapping"]["num_iters"] = 8
    config["mapping_window_size"] = 5
    config["keyframe_every"] = 2
    config["tpu"] = dict(capacity=1 << 13, pair_cap=1 << 15, tile_k_max=2048,
                         backend="tiles", rebin_every=8)
    for key, value in overrides.items():
        if isinstance(value, dict):
            config[key].update(value)
        else:
            config[key] = value
    return config


def _jax_frame(rt, time_idx):
    """rgbd_slam's frame (splatam_tpu/slam/pipeline.py:1642-1760): pose
    init honouring tracking.forward_prop, tracking or the ground-truth pose
    (tracking.use_gt_poses), densify unless mapping.add_new_gaussians is off
    (:1732), keyframes, map; tracking and densification read their frames
    from their own datasets where the config gives them sizes of their own
    (:1641-1645, :1733-1737)."""
    color_np, depth_np, _, gt_pose = rt.dataset[time_idx]
    gt_w2c = np.linalg.inv(gt_pose)
    rt.gt_w2c_all.append(gt_w2c)
    color, depth = _frame_to_device(color_np, depth_np)
    tr_color, tr_depth, d_color, d_depth = color, depth, color, depth
    if rt.tracking_dataset is not None:
        tr_color, tr_depth = _frame_to_device(*rt.tracking_dataset[time_idx][:2])
    if rt.densify_dataset is not None:
        d_color, d_depth = _frame_to_device(*rt.densify_dataset[time_idx][:2])
    if time_idx > 0:
        if time_idx > 1 and rt.config["tracking"]["forward_prop"]:
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
        if rt.config["tracking"]["use_gt_poses"]:
            rt.cam_rots[time_idx] = _quat_from_w2c(gt_w2c)
            rt.cam_trans[time_idx] = gt_w2c[:3, 3]
        else:
            rt.track_frame(time_idx, tr_color, tr_depth)
        if rt.config["mapping"]["add_new_gaussians"]:
            rt.densify_frame(time_idx, d_color, d_depth)
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


def run_both(tmp_path, frames=FRAMES, make_config=None, **overrides):
    """Run the JAX package's and the port's loops on one config (the micro
    config, or make_config(tmp_path, **overrides)); returns (port runtime,
    JAX runtime, port active counts, JAX active counts)."""
    make_config = make_config or _config
    seed_everything(0)
    jrt = JRuntime(make_config(tmp_path, **overrides))
    j_active = []
    for i in range(frames):
        _jax_frame(jrt, i)
        j_active.append(int(jrt.gm.num_active()))
    jrt.shutdown()

    seed_everything(0)
    rt = SLAMRuntime(make_config(tmp_path, **overrides), "cpu")
    t_active = []
    for i in range(frames):
        run_frame(rt, i)
        t_active.append(rt.gm.num_active())
    return rt, jrt, t_active, j_active


def assert_loops_match(rt, jrt, t_active, j_active, frames=FRAMES):
    """Equal active counts and keyframes, poses within 1e-4, a moving
    camera, and at least 99% of the map's mean entries within 1e-5."""
    from splatam_tpu.core.gaussians import compact_to_numpy as j_compact

    assert t_active == j_active
    assert t_active[-1] > t_active[0]  # densification added Gaussians
    np.testing.assert_allclose(rt.cam_rots, jrt.cam_rots, atol=1e-4)
    np.testing.assert_allclose(rt.cam_trans, jrt.cam_trans, atol=1e-4)
    assert np.abs(rt.cam_trans[-1]).max() > 1e-3  # the camera moved
    assert [k["id"] for k in rt.keyframe_list] == [k["id"] for k in jrt.keyframe_list]
    mine, ref = compact_to_numpy(rt.gm), j_compact(jrt.gm)
    diff = np.abs(mine["means3D"] - ref["means3D"])
    lr = rt.config["mapping"]["lrs"]["means3D"]
    assert diff.max() <= lr * rt.config["mapping"]["num_iters"] * frames, diff.max()
    assert np.mean(diff > 1e-5) <= 0.01, np.mean(diff > 1e-5)
    assert np.isfinite(mine["log_scales"]).all()
    return mine, ref


def test_slam_loop_matches_jax(tmp_path):
    assert_loops_match(*run_both(tmp_path))


def test_forward_prop_off_copies_the_previous_pose(tmp_path):
    """tracking.forward_prop=False starts each frame's tracking from the
    previous pose, as the JAX package does (pipeline.py:1649-1661)."""
    rt, jrt, t_active, j_active = run_both(tmp_path, tracking={"forward_prop": False})
    assert t_active == j_active
    np.testing.assert_allclose(rt.cam_rots, jrt.cam_rots, atol=1e-4)
    np.testing.assert_allclose(rt.cam_trans, jrt.cam_trans, atol=1e-4)


def test_use_gt_poses_skips_tracking(tmp_path):
    """tracking.use_gt_poses=True takes each frame's pose from the ground
    truth w2c (pipeline.py:1682-1685): the poses equal the JAX package's
    and the ground truth's."""
    rt, jrt, t_active, j_active = run_both(tmp_path, frames=2,
                                           tracking={"use_gt_poses": True})
    assert t_active == j_active
    np.testing.assert_allclose(rt.cam_rots[:2], jrt.cam_rots[:2], atol=1e-6)
    np.testing.assert_allclose(rt.cam_trans[:2], jrt.cam_trans[:2], atol=1e-6)
    np.testing.assert_allclose(rt.cam_trans[1], rt.gt_w2c_all[1][:3, 3], atol=1e-6)


def test_add_new_gaussians_off_skips_densification(tmp_path):
    """mapping.add_new_gaussians=False: no frame densifies (the reference's
    gate, pipeline.py:1732), so the map never grows; poses and counts equal
    the JAX package's."""
    rt, jrt, t_active, j_active = run_both(tmp_path, mapping={"add_new_gaussians": False})
    assert t_active == j_active
    assert max(t_active) <= t_active[0]  # pruning may remove, nothing adds
    np.testing.assert_allclose(rt.cam_rots, jrt.cam_rots, atol=1e-4)
    np.testing.assert_allclose(rt.cam_trans, jrt.cam_trans, atol=1e-4)
    assert np.abs(rt.cam_trans[-1]).max() > 1e-3  # tracking still ran


@pytest.mark.parametrize("override, item", [
    ({"tpu": {"spatial_shards": 2}}, "module list item 1.11"),
    ({"mapping": {"use_gaussian_splatting_densification": True}}, "module list item 1.8"),
    ({"tracking": {"visualize_tracking_loss": True}}, "module list item 1.10"),
])
def test_unported_configurations_raise(tmp_path, override, item):
    """The configurations of the module items that were once refused build
    now that their items are ported: 1.8 (in-loop 3DGS densification), 1.10
    (tracking.visualize_tracking_loss) and 1.11 (row bands; the runtime
    places two bands). tests/test_torch_gs_loop.py,
    tests/test_torch_tracking_viz.py and tests/test_torch_spatial_runtime.py
    run them."""
    rt = SLAMRuntime(_config(tmp_path, **override), "cpu")
    assert rt.gs_passes == []
    assert rt.bands == ([torch.device("cpu")] * 2 if item == "module list item 1.11" else None)
