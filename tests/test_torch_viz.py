"""The port's map viewers against the JAX package's, on a params.npz the
port writes (io/params_io.py save_params) at 64x48.

viz/scene.py's four functions against splatam_tpu/viz/scene.py: the
camera and the map loaded alike, the views rendered within the JAX
suite's image tolerance (1e-4; the JAX side composites with its default
CPU backend, the tiles compositor), the point clouds equal. Then both CLIs
headless on the CPU: final_recon writes the 24-view orbit and each PNG
decodes (data/png.py read_png) to the uint8 of render_view at that view;
online_recon writes its replay frames, each the uint8 of its render, and
its per-frame active masks equal those of viz_scripts/online_recon.py.
"""
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatam_tpu.viz import scene as jscene
from splatam_tpu_torch.data.png import read_png
from splatam_tpu_torch.io.params_io import save_params
from splatam_tpu_torch.scripts import final_recon, online_recon
from splatam_tpu_torch.viz import scene

# one intra-op thread per test worker (see test_torch_generic_render.py)
torch.set_num_threads(1)

H, W, FRAMES = 48, 64, 5
VIZ = dict(render_mode="color", offset_first_viz_cam=True, show_sil=False, visualize_cams=True,
           viz_w=W, viz_h=H, viz_near=0.01, viz_far=100.0, view_scale=2, viz_fps=5)


def write_run(root, n=400, seed=0) -> str:
    """A run directory's params.npz (an isotropic map whose Gaussians were
    made over FRAMES frames, a short pan of poses, the mapping camera at
    twice the viewer's size) and an experiment file naming it; returns the
    experiment file's path."""
    rng = np.random.default_rng(seed)
    quats = np.tile(np.float32([1, 0, 0, 0])[:, None], (1, FRAMES))
    quats[2] = np.linspace(0, 0.08, FRAMES)  # a turn about y
    params = dict(
        means3D=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                          rng.uniform(1.5, 5, n)], -1).astype(np.float32),
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
        logit_opacities=rng.normal(1.0, 1.0, (n, 1)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.02, 0.1, (n, 1))).astype(np.float32),
        cam_unnorm_rots=quats[None].astype(np.float32),
        cam_trans=np.stack([np.linspace(0, 0.2, FRAMES), np.zeros(FRAMES),
                            np.zeros(FRAMES)])[None].astype(np.float32),
        timestep=rng.integers(0, FRAMES, n).astype(np.float32),
        intrinsics=np.float32([[120, 0, 64], [0, 120, 48], [0, 0, 1]]),
        w2c=np.eye(4, dtype=np.float32), org_width=np.int64(2 * W), org_height=np.int64(2 * H),
        gt_w2c_all_frames=np.tile(np.eye(4, dtype=np.float32), (FRAMES, 1, 1)),
        keyframe_time_indices=np.arange(FRAMES))
    save_params(params, os.path.join(root, "viz"))
    exp = os.path.join(root, "viz_experiment.py")
    config = dict(workdir=str(root), run_name="viz", viz=VIZ, tpu={"backend": "auto"})
    with open(exp, "w") as f:
        f.write(f"config = {config!r}\n")
    return exp


@pytest.fixture
def run(tmp_path):
    exp = write_run(tmp_path)
    return exp, os.path.join(tmp_path, "viz"), os.path.join(tmp_path, "viz", "params.npz")


def test_scene_functions_match_jax(run):
    _, _, path = run
    w2c, k = scene.load_camera(VIZ, path)
    jw2c, jk = jscene.load_camera(VIZ, path)
    np.testing.assert_array_equal(w2c, jw2c)
    np.testing.assert_array_equal(k, jk)
    gm, w2cs, _ = scene.load_scene_data(path, "cpu")
    jgm, jw2cs, _ = jscene.load_scene_data(path)
    for name, mine in gm._asdict().items():
        np.testing.assert_array_equal(mine.numpy(), np.asarray(getattr(jgm, name)), err_msg=name)
    assert len(w2cs) == len(jw2cs) == FRAMES
    np.testing.assert_allclose(np.stack(w2cs), np.stack(jw2cs), atol=1e-6)
    for view in (w2cs[-1], final_recon.orbit_w2c(w2cs[-1], 7)):
        for white in (True, False):
            im, depth, sil = scene.render_view(gm, view, k, VIZ, white_bg=white)
            jim, jdepth, jsil = jscene.render_view(jgm, view, k, VIZ, white_bg=white)
            assert im.shape == (3, H, W) and float(sil.max()) > 0.5
            for a, b in ((im, jim), (depth, jdepth), (sil, jsil)):
                np.testing.assert_allclose(a, b, atol=1e-4)
    for mode in ("color", "depth"):
        cfg = dict(VIZ, render_mode=mode)
        pts, cols = scene.rgbd2pcd_np(im, depth, view, k, cfg)
        jpts, jcols = jscene.rgbd2pcd_np(im, depth, view, k, cfg)
        np.testing.assert_array_equal(pts, jpts)
        np.testing.assert_array_equal(cols, jcols)


def test_final_recon_headless_writes_the_rendered_orbit(run):
    exp, run_dir, path = run
    paths = final_recon.main([exp, "--device", "cpu"])
    assert paths == [os.path.join(run_dir, "viz_frames", f"view_{i:03d}.png")
                     for i in range(final_recon.N_VIEWS)]
    gm, w2cs, _ = scene.load_scene_data(path, "cpu")
    _, k = scene.load_camera(VIZ, path)
    for i, png in enumerate(paths):
        im, _, _ = scene.render_view(gm, final_recon.orbit_w2c(w2cs[-1], i), k, VIZ)
        np.testing.assert_array_equal(read_png(png), final_recon.to_uint8(im))


def test_online_recon_headless_replays_the_map_as_the_jax_script_masks_it(run):
    exp, run_dir, path = run
    frames = online_recon.main([exp, "--device", "cpu"])
    assert frames == list(range(FRAMES))  # stride 1 below 200 frames
    params = dict(np.load(path, allow_pickle=True))
    gm, ts = online_recon.device_map_and_timesteps(params, "cpu")
    spec = importlib.util.spec_from_file_location(
        "jax_online_recon", os.path.join(os.path.dirname(__file__), "..", "viz_scripts",
                                         "online_recon.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    jgm, jts = jmod.device_map_and_timesteps(params)
    _, k = scene.load_camera(VIZ, path)
    w2cs = scene.estimated_w2cs(params)
    counts = []
    for t in frames:
        mask = gm.active & (ts <= t)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jgm.active & (jts <= t)))
        counts.append(int(mask.sum()))
        im, _, _ = scene.render_view(gm._replace(active=mask), w2cs[t], k, VIZ)
        png = os.path.join(run_dir, "online_replay", f"replay_{t:04d}.png")
        np.testing.assert_array_equal(read_png(png), final_recon.to_uint8(im))
    assert counts == sorted(counts) and 0 < counts[0] < counts[-1] == 400
    assert np.isinf(np.asarray(jts)[400:]).all() and jnp.asarray(jts).shape == ts.shape
