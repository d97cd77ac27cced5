"""The live NeRFCapture path against the JAX package's: the iPhone demo's
frame decode and online loop (scripts/iphone_demo.py), the dataset capture
(scripts/nerfcapture2dataset.py) and the DDS bridge
(splatam_tpu/live/dds.py).

The JAX script's `_init_runtime_live` (SLAMRuntime.__init__ re-typed
after __new__) predates attributes the JAX runtime now reads: its
live_slam raises AttributeError ('_pairs_seen') at frame 0. The JAX side
therefore builds its runtime as that function means to, with the JAX
constructor itself on the in-memory frame list (_jax_live_init); the rest
of its live_slam and _step_frame run as written.

Both packages read one replayed stream (splatam_tpu_torch/live/replay.py):
the synthetic scene at 128x96 in NeRFCapture's sample layout (uint8 RGB,
float32 depth bytes at 32x24 as the phone's depth is coarser than its
colour, an OpenGL-convention transform_matrix), with an empty read and a
sample without depth among the frames. Each script's make_reader is
patched to serve it.

Tolerances:
- _decode_frame: colour equal to cv2's uint8 resize at the configs' exact
  2x reduction, within one level at another ratio (cv2's fixed-point
  weights); depth, intrinsics and pose equal;
- live_slam (configs/iphone/online_demo.py cut to 4 frames at 64x48 and
  3/3 iterations, at map_every 1 as written and 2): poses within 1e-4, as
  tests/test_torch_rgbd_slam.py holds rgbd_slam; equal keyframes, Gaussian
  counts, rgb PNGs and transforms.json; params.npz with the same keys,
  shapes and dtypes;
- the loaders on the two captured trees: colour within 1e-4 (0-255),
  depth, intrinsics and pose within 1e-6 (tests/test_torch_data_loaders.py).
"""
import json
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

import scripts.iphone_demo as j_demo
import scripts.nerfcapture2dataset as j_capture
import splatam_tpu.slam.pipeline as j_pipeline
import splatam_tpu.data as jdata
import splatam_tpu.data.base as jbase
import splatam_tpu_torch.data as tdata
import splatam_tpu_torch.data.base as tbase
from splatam_tpu.slam.config import load_experiment_config as j_load_config
from splatam_tpu.slam.config import seed_everything as j_seed
from splatam_tpu_torch.data.imgproc import resize_nearest
from splatam_tpu_torch.data.synthetic import SyntheticDataset
from splatam_tpu_torch.live import dds
from splatam_tpu_torch.live.replay import SampleReader, to_sample
from splatam_tpu_torch.scripts import iphone_demo, nerfcapture2dataset
from splatam_tpu_torch.slam.config import load_experiment_config, seed_everything
from splatam_tpu_torch.slam.pipeline import SLAMRuntime

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "configs", "iphone", "online_demo.py")
H, W = 96, 128  # the samples' colour size; the loop runs at half of it
DEPTH_HW = (24, 32)
FRAMES = 4


def _samples(n: int = FRAMES) -> list:
    """n samples with depth, an empty read after the first and a sample
    without depth after the second."""
    ds = SyntheticDataset(num_frames=n + 1, height=H, width=W, motion_scale=2.0)
    out = []
    for i in range(n):
        color, depth, k, pose = ds[i]
        out.append(to_sample(i, color, resize_nearest(depth[..., 0], *DEPTH_HW), k, pose))
    color, _, k, pose = ds[n]
    return [out[0], None, out[1], to_sample(n, color, None, k, pose), *out[2:]]


def _live_config(load, workdir, **overrides) -> dict:
    config = load(DEMO)
    config["workdir"] = str(workdir)
    config["data"].update(num_frames=FRAMES, desired_image_height=H // 2,
                          desired_image_width=W // 2)
    config["tracking"]["num_iters"] = 3
    config["mapping"]["num_iters"] = 3
    config.update(overrides)
    return config


def _jax_live_init(made: list):
    """_init_runtime_live as the JAX script means it ("SLAMRuntime.__init__
    minus the file-dataset construction"): the JAX constructor with
    _make_datasets giving the live frame list. Appends each runtime to
    made."""
    def init(rt, config, live_ds):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_pipeline, "_make_datasets", lambda cfg: (live_ds, None, None))
            j_pipeline.SLAMRuntime.__init__(rt, config)
        made.append(rt)
    return init


def test_decode_frame_matches_jax():
    sample = _samples()[0]
    mine = iphone_demo._decode_frame(sample, W // 2, H // 2, 2.0)
    ref = j_demo._decode_frame(sample, W // 2, H // 2, 2.0)
    for a, b in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert mine[1].shape == (H // 2, W // 2, 1)
    # another ratio: cv2's uint8 bilinear weights are fixed-point
    color, _, _, _ = iphone_demo._decode_frame(sample, 80, 60, 1.6)
    ref_color, _, _, _ = j_demo._decode_frame(sample, 80, 60, 1.6)
    assert np.abs(color - ref_color).max() <= 1.0


@pytest.fixture(scope="module", params=[1, 2], ids=["map_every1", "map_every2"])
def live_runs(request, tmp_path_factory):
    """(JAX run dir, port run dir, port runtime) of live_slam on the
    stream, map_every as written (1) and 2."""
    mp, made = pytest.MonkeyPatch(), []
    mp.setattr(j_demo, "make_reader", lambda: (None, SampleReader(_samples())))
    mp.setattr(iphone_demo, "make_reader", lambda: (None, SampleReader(_samples())))
    mp.setattr(j_demo, "_init_runtime_live", _jax_live_init(made))
    try:
        jcfg = _live_config(j_load_config, tmp_path_factory.mktemp("jax"),
                            map_every=request.param)
        j_seed(0)
        j_demo.live_slam(jcfg)
        made[0].shutdown()
        tcfg = _live_config(load_experiment_config, tmp_path_factory.mktemp("port"),
                            map_every=request.param)
        seed_everything(0)
        rt = iphone_demo.live_slam(tcfg, "cpu")
    finally:
        mp.undo()
    run = lambda c: Path(c["workdir"]) / c["run_name"]  # noqa: E731
    return run(jcfg), run(tcfg), rt


def test_live_slam_matches_jax(live_runs):
    jrun, trun, rt = live_runs
    mine = dict(np.load(trun / "params.npz", allow_pickle=True))
    ref = dict(np.load(jrun / "params.npz", allow_pickle=True))
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].shape == ref[k].shape and mine[k].dtype == ref[k].dtype, k
    np.testing.assert_allclose(mine["cam_unnorm_rots"], ref["cam_unnorm_rots"], atol=1e-4)
    np.testing.assert_allclose(mine["cam_trans"], ref["cam_trans"], atol=1e-4)
    assert np.abs(mine["cam_trans"][..., -1]).max() > 1e-3  # the camera moved
    assert mine["keyframe_time_indices"].tolist() == ref["keyframe_time_indices"].tolist()
    # the ground truth is the phone's pose relative to the first frame
    np.testing.assert_allclose(mine["gt_w2c_all_frames"], ref["gt_w2c_all_frames"], atol=1e-6)
    np.testing.assert_allclose(mine["gt_w2c_all_frames"][0], np.eye(4), atol=1e-6)
    # the samples without depth (and the empty read) were skipped
    manifest = json.loads((trun / "transforms.json").read_text())
    assert manifest == json.loads((jrun / "transforms.json").read_text())
    assert [f["file_path"] for f in manifest["frames"]] == [f"rgb/{i}.png" for i in range(FRAMES)]
    for i in range(FRAMES):
        np.testing.assert_array_equal(cv2.imread(str(trun / "rgb" / f"{i}.png")),
                                      cv2.imread(str(jrun / "rgb" / f"{i}.png")))
    # no densification or tracking dataset, though the config sets a densification size
    assert rt.config["data"]["densification_image_height"] != H // 2
    assert rt.densify_dataset is None and rt.tracking_dataset is None
    assert rt.densify_cam == rt.cam and rt.tracking_cam == rt.cam


def test_live_map_every_gates_densify_and_map(live_runs):
    """With map_every 2, frames 1 and 3 map and densify, frame 2 neither:
    the map after frame 2 is the map after frame 1 (the Gaussian counts
    above equal the JAX package's in both cases)."""
    _, trun, rt = live_runs
    added_at = set(np.load(trun / "params.npz")["timestep"].tolist())
    assert (2.0 in added_at) == (rt.config["map_every"] == 1), added_at


def test_live_keyframe_store_guard_matches_jax(tmp_path):
    """A keyframe is added only while the store has a slot before its
    scratch slot (scripts/iphone_demo.py:226); add_keyframe would grow the
    store instead. The store is cut to one keyframe slot in both packages:
    frames 0-2 (keyframe_every 1) keep keyframe 0 only."""
    frames = 3
    samples = [s for s in _samples() if s is not None and s.has_depth][:frames]
    runs = []
    for pkg, load, seed in (("jax", j_load_config, j_seed), ("port", load_experiment_config,
                                                               seed_everything)):
        config = _live_config(load, tmp_path / pkg, keyframe_every=1)
        config["tracking"]["num_iters"] = config["mapping"]["num_iters"] = 1
        decode = (j_demo if pkg == "jax" else iphone_demo)._decode_frame
        live = (j_demo._LiveDataset(H // 2, W // 2) if pkg == "jax"
                else iphone_demo._LiveDataset())
        first = None
        seed(0)
        for i, s in enumerate(samples):
            color, depth, k, pose = decode(s, W // 2, H // 2, 2.0)
            first = pose if first is None else first
            relative = (jbase if pkg == "jax" else tbase).relative_transformation_np
            live.append(color, depth, k, relative(first, pose).astype(np.float32))
            if i == 0:
                if pkg == "jax":
                    config = j_demo.backfill_defaults(config)
                    rt = j_demo.SLAMRuntime.__new__(j_demo.SLAMRuntime)
                    _jax_live_init([])(rt, config, live)
                else:
                    rt = SLAMRuntime(config, "cpu", datasets=(live, None, None))
                rt.kf_scratch_slot = 1
            if pkg == "jax":
                j_demo._step_frame(rt, config, live, i)
            else:
                iphone_demo._step_frame(rt, live, i)
        runs.append(rt)
    jrt, rt = runs
    jrt.shutdown()
    assert rt.keyframe_time_indices == jrt.keyframe_time_indices == [0]
    assert rt.kf_colors.shape[0] == FRAMES // 1 + 3  # not grown
    np.testing.assert_allclose(rt.cam_trans, jrt.cam_trans, atol=1e-4)


def test_dataset_capture_matches_jax(tmp_path):
    """Both packages capture the stream (4 frames); the rgb and depth PNGs
    decode equal, the manifests are equal, and the port's NeRFCapture
    loader reads the port's tree as the JAX loader reads the JAX tree."""
    samples = [s for s in _samples() if s is None or s.has_depth]
    j_capture.dataset_capture_loop(SampleReader(samples), tmp_path / "jax" / "capture", False,
                                   FRAMES, 10.0)
    nerfcapture2dataset.dataset_capture_loop(SampleReader(samples), tmp_path / "port" / "capture",
                                             False, FRAMES, 10.0)
    jtree, ttree = tmp_path / "jax" / "capture", tmp_path / "port" / "capture"
    assert (json.loads((ttree / "transforms.json").read_text())
            == json.loads((jtree / "transforms.json").read_text()))
    for sub in ("rgb", "depth"):
        for i in range(FRAMES):
            a = cv2.imread(str(ttree / sub / f"{i}.png"), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(jtree / sub / f"{i}.png"), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    kw = dict(start=0, end=-1, stride=1, desired_height=H // 2, desired_width=W // 2,
              relative_pose=True)
    mine = tdata.get_dataset({"dataset_name": "nerfcapture"}, str(tmp_path / "port"), "capture",
                             **kw)
    ref = jdata.get_dataset({"dataset_name": "nerfcapture"}, str(tmp_path / "jax"), "capture",
                            **kw)
    assert len(mine) == len(ref) == FRAMES
    for i in range(FRAMES):
        (c, d, k, p), (jc, jd, jk, jp) = mine[i], ref[i]
        np.testing.assert_allclose(c, jc, atol=1e-4)
        for a, b in ((d, jd), (k, jk), (p, jp)):
            np.testing.assert_allclose(a, b, atol=1e-6)
    # the capture read back: depth within the uint16 quantisation (10 m / 65535)
    served = iphone_demo._decode_frame(samples[2], W // 2, H // 2, 2.0)
    np.testing.assert_allclose(mine[1][1], served[1], atol=10.0 / 65535)


def test_make_reader_without_cyclonedds_raises_the_jax_text():
    import splatam_tpu.live.dds as j_dds

    assert not dds.HAVE_DDS and not j_dds.HAVE_DDS
    with pytest.raises(ImportError) as mine:
        dds.make_reader()
    with pytest.raises(ImportError) as ref:
        j_dds.make_reader()
    assert str(mine.value) == str(ref.value)
