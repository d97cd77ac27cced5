"""tracking.visualize_tracking_loss in the port (slam/pipeline.py
tracking_loss_panels and _save_tracking_loss_viz, viz/panels.py) against
the JAX package's _save_tracking_loss_viz (splatam_tpu/slam/pipeline.py:
1518-1591).

- The eight panels on one map and pose equal the arrays the JAX function
  hands to imshow (captured by patching matplotlib.axes.Axes.imshow): the
  JAX runtime runs 2 frames of the micro config, and the port renders the
  JAX map (its params.npz arrays) at the JAX tracked pose. Images within
  1e-4 (the render parity of tests/test_torch_render.py), masks equal;
  titles and colour maps equal.
- rgbd_slam with the key writes one panel PNG per tracked frame, through
  matplotlib and, with matplotlib hidden, as a 2x4 grid through
  data/png.py; either way the run's poses, map and metrics equal the run
  without the key bit for bit (the panel renders and changes no state).
- viz/panels.py's jet against matplotlib's within 0.02 (matplotlib reads a
  256-entry table, jet's steepest segment rises 4 per unit).
"""
import copy
import os
import sys

import matplotlib
import matplotlib.axes
import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

import splatam_tpu.slam.pipeline as j_pipeline
from splatam_tpu_torch.core.camera import setup_camera
from splatam_tpu_torch.core.gaussians import from_params_dict
from splatam_tpu_torch.data import frame_to_tensors
from splatam_tpu_torch.data.png import read_png
from splatam_tpu_torch.slam import pipeline
from splatam_tpu_torch.slam.config import seed_everything
from splatam_tpu_torch.viz import panels
from test_torch_slam import JRuntime, _config, _jax_frame

torch.set_num_threads(1)
matplotlib.use("Agg")

FRAMES = 3


def test_panels_match_what_jax_draws(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    seed_everything(0)
    jrt = JRuntime(_config(tmp_path / "jax"))
    for i in range(2):
        _jax_frame(jrt, i)
    jrt.shutdown()
    color_np, depth_np, _, _ = jrt.dataset[1]
    drawn = []
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow",
                        lambda ax, img, cmap=None, **kw: drawn.append((np.asarray(img), cmap)))
    j_color, j_depth = j_pipeline._frame_to_device(color_np, depth_np)
    j_pipeline._save_tracking_loss_viz(jrt, 1, j_color, j_depth)
    assert os.path.exists(os.path.join(jrt.output_dir, "tracking_loss_viz", "0001.png"))

    gm = from_params_dict(jrt.export_params(), "cpu")
    cam = setup_camera(color_np.shape[1], color_np.shape[0], jrt.intrinsics, None)
    color, depth = frame_to_tensors(color_np, depth_np, "cpu")
    mine = pipeline.tracking_loss_panels(gm, jrt.cam_rots[1], jrt.cam_trans[1], cam, color,
                                         depth, jrt.config["tracking"]["sil_thres"])
    assert len(mine) == len(drawn) == 8
    for (img, title, cmap), (ref, ref_cmap) in zip(mine, drawn):
        assert cmap == ref_cmap, title
        assert img.shape == ref.shape, title
        np.testing.assert_allclose(img, ref, atol=1e-4, err_msg=title)
    mask = mine[6][0]
    assert 0 < mask.mean() < 1  # the silhouette panel has both sides
    assert [t for _, t, _ in mine][:4] == ["GT RGB", "GT Depth", "Rastered RGB", "Rastered Depth"]


def _run(tmp_path, name, **tracking):
    config = _config(tmp_path / name, data={"num_frames": FRAMES}, eval_every=1,
                     tracking={"num_iters": 3, **tracking}, mapping={"num_iters": 3})
    seed_everything(0)
    metrics = pipeline.rgbd_slam(copy.deepcopy(config), "cpu")
    run = os.path.join(config["workdir"], config["run_name"])
    return metrics, dict(np.load(os.path.join(run, "params.npz"))), run


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("off"), "off")


@pytest.mark.parametrize("drawer", ["matplotlib", "write_png"])
def test_rgbd_slam_writes_a_panel_per_tracked_frame(tmp_path, monkeypatch, plain_run, drawer):
    monkeypatch.delenv("DISPLAY", raising=False)
    if drawer == "write_png":
        monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib raises
    metrics, params, run = _run(tmp_path, drawer, visualize_tracking_loss=True)
    viz = os.path.join(run, "tracking_loss_viz")
    assert sorted(os.listdir(viz)) == [f"{t:04d}.png" for t in range(1, FRAMES)]
    if drawer == "write_png":
        grid = read_png(os.path.join(viz, "0001.png"))
        assert grid.shape == (2 * 48, 4 * 64, 3) and grid.dtype == np.uint8
        assert grid.std() > 0
    ref_metrics, ref_params, _ = plain_run
    assert sorted(params) == sorted(ref_params)
    for k in ref_params:
        np.testing.assert_array_equal(params[k], ref_params[k], err_msg=k)
    strip = lambda m: {k: v for k, v in m.items() if k != "runtime"}  # noqa: E731
    assert strip(metrics) == strip(ref_metrics)


def test_jet_matches_matplotlib():
    import matplotlib.cm

    x = np.linspace(0.0, 1.0, 1001)
    np.testing.assert_allclose(panels.jet(x), matplotlib.cm.jet(x)[:, :3], atol=0.02)
    grid = panels.panel_grid([(np.full((2, 3), 5.0), "flat", "jet"),
                              (np.zeros((2, 3, 3)), "rgb", None)], cols=2)
    assert grid.shape == (2, 6, 3) and (grid[:, :3] == [0, 0, 128]).all()
