"""The port's full online entry point against the JAX package's.

Both packages' `rgbd_slam` run 4 frames of test_torch_slam.py's micro
config (6 tracking / 8 mapping iterations at 64x48, rebin_every=8, the
fused path), keyframe_every=4 and a checkpoint every 2 frames; the port
through its CLI (`scripts/splatam.py`'s main with --device cpu), the JAX
side on the `tiles` backend, each seeded at 0. Keyframes are 0, 2 (the
num_frames - 2 one that bench.py's loop does not add) and 3.

Held to the JAX package: per-frame poses within 1e-4 (float32
reassociation through ~20 optimizer steps per frame, as in
test_torch_slam.py), equal keyframe_time_indices, params.npz with the
same keys, shapes and dtypes and equal Gaussian counts, the same metric
keys with PSNR within 0.05 dB, depth within 1e-4 m and ATE within 1e-4 m
(the maps differ by Adam's float noise, see test_torch_slam.py). A
checkpoint written by either package resumes in the other; the two resumed
runs' poses agree within 1e-4.
"""
import copy
import os
import shutil

import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

from splatam_tpu.slam.config import seed_everything as j_seed
from splatam_tpu.slam.pipeline import SLAMRuntime as JRuntime, rgbd_slam as j_rgbd_slam
from splatam_tpu_torch.scripts.splatam import main as splatam_main
from splatam_tpu_torch.slam.config import seed_everything
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, rgbd_slam
from test_torch_slam import _config

torch.set_num_threads(1)

FRAMES = 4
CKPT = 2
KEYFRAMES = [0, 2, 3]
PARAM_KEYS = ["means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales",
              "cam_unnorm_rots", "cam_trans", "timestep", "intrinsics", "w2c",
              "gt_w2c_all_frames", "keyframe_time_indices"]


def slam_config(workdir, **overrides):
    return _config(workdir, **{"data": {"num_frames": FRAMES}, "keyframe_every": 4,
                               "save_checkpoints": True, "checkpoint_interval": CKPT,
                               **overrides})


def _run_dir(config):
    return os.path.join(config["workdir"], config["run_name"])


def _load(config, name="params.npz"):
    return dict(np.load(os.path.join(_run_dir(config), name), allow_pickle=True))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX config, metrics), (port config, metrics): the port's run goes
    through the CLI, from a config file."""
    jcfg = slam_config(str(tmp_path_factory.mktemp("jax")))
    j_seed(0)
    jm = j_rgbd_slam(copy.deepcopy(jcfg))
    tdir = tmp_path_factory.mktemp("port")
    tcfg = slam_config(str(tdir))
    path = tdir / "experiment.py"
    path.write_text(f"config = {tcfg!r}\n")
    tm = splatam_main([str(path), "--device", "cpu"])
    return (jcfg, jm), (tcfg, tm)


def test_rgbd_slam_matches_jax(runs):
    (jcfg, jm), (tcfg, tm) = runs
    mine, ref = _load(tcfg), _load(jcfg)
    np.testing.assert_allclose(mine["cam_unnorm_rots"], ref["cam_unnorm_rots"], atol=1e-4)
    np.testing.assert_allclose(mine["cam_trans"], ref["cam_trans"], atol=1e-4)
    assert np.abs(mine["cam_trans"][..., -1]).max() > 1e-3  # the camera moved
    assert mine["keyframe_time_indices"].tolist() == ref["keyframe_time_indices"].tolist()
    assert mine["keyframe_time_indices"].tolist() == KEYFRAMES
    assert sorted(mine) == sorted(ref) and set(PARAM_KEYS) <= set(mine)
    for k in ref:
        assert mine[k].shape == ref[k].shape and mine[k].dtype == ref[k].dtype, k
    assert mine["means3D"].shape[0] == mine["timestep"].shape[0]
    np.testing.assert_array_equal(mine["timestep"], ref["timestep"])

    assert sorted(tm) == sorted(jm) and sorted(tm["runtime"]) == sorted(jm["runtime"])
    assert abs(tm["psnr"] - jm["psnr"]) <= 0.05
    for k in ("depth_l1", "depth_rmse", "ate_rmse"):
        assert abs(tm[k] - jm[k]) <= 1e-4, k
    assert tm["lpips_calibration"] == jm["lpips_calibration"] == "synthetic"
    assert all(np.isfinite(v) for v in tm["runtime"].values())


def test_cli_writes_the_run_directory(runs):
    _, (tcfg, _) = runs
    run = _run_dir(tcfg)
    for name in ("config.py", "params.npz", f"params{CKPT}.npz",
                 f"keyframe_time_indices{CKPT}.npy", "eval/psnr.txt"):
        assert os.path.exists(os.path.join(run, name)), name
    assert np.load(os.path.join(run, f"keyframe_time_indices{CKPT}.npy")).tolist() == [0, 2]


def test_eval_and_export_clis_read_the_run(runs):
    """eval_novel_view's main on the run's params.npz gives the run's own
    metrics (the same map, frames and device); export_ply's main writes a
    splat that load_ply reads back into the saved arrays."""
    from splatam_tpu_torch.io.ply import load_ply
    from splatam_tpu_torch.scripts import eval_novel_view, export_ply

    _, (tcfg, tm) = runs
    path = os.path.join(tcfg["workdir"], "experiment.py")
    again = eval_novel_view.main([path, "--device", "cpu"])
    assert again == {k: v for k, v in tm.items() if k != "runtime"}
    assert os.path.exists(os.path.join(_run_dir(tcfg), "eval_train", "psnr.txt"))
    params, back = _load(tcfg), load_ply(export_ply.main([path]))
    np.testing.assert_array_equal(back["means3D"], params["means3D"])
    np.testing.assert_array_equal(back["log_scales"], np.tile(params["log_scales"], (1, 3)))
    np.testing.assert_allclose(back["rgb_colors"], params["rgb_colors"], atol=1e-6)


def _resume(src_config, workdir, resume_fn):
    """Copy src's checkpoint CKPT into a fresh run directory and resume
    there; returns the resumed run's params.npz."""
    cfg = slam_config(str(workdir), load_checkpoint=True, checkpoint_time_idx=CKPT)
    os.makedirs(_run_dir(cfg))
    for name in (f"params{CKPT}.npz", f"keyframe_time_indices{CKPT}.npy"):
        shutil.copy(os.path.join(_run_dir(src_config), name), _run_dir(cfg))
    resume_fn(cfg)
    return _load(cfg)


def test_checkpoints_resume_across_packages(runs, tmp_path):
    (jcfg, _), (tcfg, _) = runs

    def port(cfg):
        seed_everything(0)
        rgbd_slam(cfg, "cpu")

    def jax_(cfg):
        j_seed(0)
        j_rgbd_slam(cfg)

    in_port = _resume(jcfg, tmp_path / "port_from_jax", port)
    in_jax = _resume(tcfg, tmp_path / "jax_from_port", jax_)
    for k in ("cam_unnorm_rots", "cam_trans"):
        np.testing.assert_allclose(in_port[k], in_jax[k], atol=1e-4)
        assert np.isfinite(in_port[k]).all()
    assert in_port["keyframe_time_indices"].tolist() == in_jax["keyframe_time_indices"].tolist()
    assert in_port["means3D"].shape == in_jax["means3D"].shape


def test_keyframe_store_grows_keeping_the_scratch_slot(tmp_path):
    """Past the store's capacity both packages grow it by 8 slots, keep
    every keyframe and keep the scratch slot (the current frame) last."""
    j_seed(0)
    jrt = JRuntime(_config(str(tmp_path / "j")))
    rt = SLAMRuntime(_config(str(tmp_path / "t")), "cpu")
    color_np, depth_np, _, _ = rt.dataset[1]
    for r in (rt, jrt):
        r._stage_keyframe(r.kf_scratch_slot, color_np, depth_np)
    cap, ids = rt.kf_colors.shape[0], [i % rt.num_frames for i in range(rt.kf_colors.shape[0] + 1)]
    for i in ids:
        c, d, _, _ = rt.dataset[i]
        rt.add_keyframe(i, c, d)
        slot = len(jrt.keyframe_list)
        while slot >= jrt.kf_scratch_slot:
            jrt._grow_kf_store()
        jrt._stage_keyframe(slot, c, d)
        jrt.keyframe_list.append({"id": i, "slot": slot})
    jrt.shutdown()
    assert rt.kf_colors.shape[0] == jrt.kf_colors.shape[0] == cap + 8
    assert rt.kf_scratch_slot == jrt.kf_scratch_slot == cap + 7
    np.testing.assert_array_equal(rt.kf_colors.numpy(), np.asarray(jrt.kf_colors))
    np.testing.assert_array_equal(rt.kf_depths.numpy(), np.asarray(jrt.kf_depths))
    assert rt.keyframe_time_indices == ids
