"""The device generator against the program's numpy scene
(splatam_tpu_torch/data/synthetic.py) at 64x48: colour, depth and pose."""
from __future__ import annotations

import numpy as np
import torch

from slam_bench import scene, traffic
from splatam_tpu_torch.data.synthetic import SyntheticDataset

H, W, N = 48, 64, 5
CAM = {"height": H, "width": W, "fx": 57.6, "fy": 57.6, "cx": 32.0, "cy": 24.0,
       "png_depth_scale": 6553.5}


def _dataset():
    return SyntheticDataset(num_frames=N, height=H, width=W, seed=11, trajectory="pan")


def _plan(ds):
    """A plan on the numpy scene's pan: its orbit, its phase and its step."""
    plan = traffic.Plan({"fps": 30, "rotation_deg_per_s": 23.327, "translation_m_per_s": 0.413,
                         "start_angle": 0.0, "jitter_rad": 0.0, "setup_frames": 1,
                         "trace_frames": 1}, seed=0, n_frames=N)
    plan.start, plan.step, plan.radius = ds._phase, 0.35 / (N - 1), scene.ORBIT_RADIUS
    return plan


def test_the_plan_moves_at_the_traffics_speeds():
    plan = traffic.Plan({"fps": 30, "rotation_deg_per_s": 23.327, "translation_m_per_s": 0.413,
                         "start_angle": 4.0, "jitter_rad": 0.01, "setup_frames": 1,
                         "trace_frames": 1}, seed=3000000007, n_frames=40)
    turns, moves = [], []
    for i in range(39):
        a, b = plan.c2w(i), plan.c2w(i + 1)
        cos = (np.trace(a[:3, :3].T @ b[:3, :3]) - 1.0) / 2.0
        turns.append(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))) * 30)
        moves.append(np.linalg.norm(b[:3, 3] - a[:3, 3]) * 30)
    # the orbit's small vertical sway adds under 1% to either speed
    assert abs(np.mean(turns) / 23.327 - 1.0) < 0.01
    assert abs(np.mean(moves) / 0.413 - 1.0) < 0.01


def test_poses_match_the_numpy_trajectory():
    ds = _dataset()
    plan = _plan(ds)
    for i in range(N):
        np.testing.assert_allclose(plan.relative_pose(i), ds.poses[i], atol=1e-12)


def test_colour_and_depth_match_the_numpy_ray_cast():
    ds = _dataset()
    ds._world_from_frame0 = np.eye(4)
    plan = _plan(ds)
    c2w = np.stack([plan.c2w(s) for s in range(N)])
    color, depth = scene.raycast(torch.tensor(c2w), H, W, CAM["fx"], CAM["fy"], CAM["cx"],
                                 CAM["cy"], 3.0)
    for i in range(N):
        want_c, want_d = ds.render_frame(c2w[i])
        np.testing.assert_allclose(color[i].numpy(), want_c, atol=1e-3)
        np.testing.assert_allclose(depth[i].numpy(), want_d[..., 0], rtol=1e-6)


def test_sensor_frames_are_quantized_as_a_sensor_gives_them():
    ds = _dataset()
    plan = _plan(ds)
    frames = traffic.make_frames(plan, CAM, {"depth_noise_sigma": 0.0}, {"room_half": 3.0}, 5,
                                 torch.device("cpu"))
    assert frames.color.dtype == np.uint8 and frames.depth.dtype == np.uint16
    stream = traffic.SensorStream(plan, frames, CAM)
    color, depth, k, pose = stream[2]
    assert color.dtype == np.float32 and depth.shape == (H, W, 1) and k[0, 0] == CAM["fx"]
    ds._world_from_frame0 = np.eye(4)
    want_c, want_d = ds.render_frame(plan.c2w(2))
    assert np.abs(color - want_c).max() <= 0.5 + 1e-3
    assert np.abs(depth - want_d).max() <= 0.5 / CAM["png_depth_scale"] + 1e-6


def test_depth_noise_is_drawn_anew_for_every_frame_from_the_seed():
    ds = _dataset()
    plan = _plan(ds)
    plan.step = 0.0  # every frame shows one view
    sensor = {"depth_noise_sigma": 0.01}
    a = traffic.make_frames(plan, CAM, sensor, {"room_half": 3.0}, 5, torch.device("cpu"))
    b = traffic.make_frames(plan, CAM, sensor, {"room_half": 3.0}, 5, torch.device("cpu"))
    c = traffic.make_frames(plan, CAM, sensor, {"room_half": 3.0}, 6, torch.device("cpu"))
    assert a.depth.shape[0] == N
    assert np.array_equal(a.depth, b.depth) and not np.array_equal(a.depth, c.depth)
    assert not np.array_equal(a.depth[0], a.depth[1])
