"""The port's rgbd_slam against the JAX package's with map_every=2 and the
per-iteration loss history on (use_wandb, report_iter_progress).

4 frames of test_torch_slam.py's micro config in both packages, seeded at
0: frames 0, 1 and 3 densify and map, frame 2 only tracks. wandb is kept
from importing, so both packages write their JSON-lines fallback: the
streams must hold the same records in the same order, each per-iteration
loss (tracking: recorded in tracking_phase's preallocated buffer, read once
per phase; mapping: the same in mapping_phase) and each progress value
within 1e-4 relative, Gaussian counts equal. Poses within 1e-4, equal
keyframes and PSNR within 0.05 dB, as test_torch_rgbd_slam.py.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

from splatam_tpu.slam.config import seed_everything as j_seed
from splatam_tpu.slam.pipeline import rgbd_slam as j_rgbd_slam
from splatam_tpu_torch.slam.config import seed_everything
from splatam_tpu_torch.slam.pipeline import rgbd_slam
from test_torch_slam import _config

torch.set_num_threads(1)

FRAMES = 4


def _stream(config):
    path = os.path.join(config["workdir"], config["run_name"], "wandb_fallback.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "wandb", None)  # the JSON-lines fallback, never a network login
    try:
        out = []
        for name, seed, slam in (("jax", j_seed, j_rgbd_slam),
                                 ("port", seed_everything, lambda c: rgbd_slam(c, "cpu"))):
            cfg = _config(str(tmp_path_factory.mktemp(name)), data={"num_frames": FRAMES},
                          map_every=2, use_wandb=True, report_iter_progress=True)
            seed(0)
            out.append((cfg, slam(copy.deepcopy(cfg))))
    finally:
        mp.undo()
    return out


def test_map_every_matches_jax(runs):
    (jcfg, jm), (tcfg, tm) = runs
    load = lambda c: dict(np.load(os.path.join(c["workdir"], c["run_name"], "params.npz")))
    mine, ref = load(tcfg), load(jcfg)
    np.testing.assert_allclose(mine["cam_unnorm_rots"], ref["cam_unnorm_rots"], atol=1e-4)
    np.testing.assert_allclose(mine["cam_trans"], ref["cam_trans"], atol=1e-4)
    assert mine["keyframe_time_indices"].tolist() == ref["keyframe_time_indices"].tolist()
    assert mine["means3D"].shape == ref["means3D"].shape
    assert abs(tm["psnr"] - jm["psnr"]) <= 0.05
    assert abs(tm["ate_rmse"] - jm["ate_rmse"]) <= 1e-4


def test_loss_history_stream_matches_jax(runs):
    (jcfg, _), (tcfg, _) = runs
    mine, ref = _stream(tcfg), _stream(jcfg)
    assert [sorted(r) for r in mine] == [sorted(r) for r in ref]
    iters = [r for r in ref if "Per Iteration Tracking/Loss" in r]
    maps = [r for r in ref if "Per Iteration Mapping/Loss" in r]
    # tracking on frames 1-3 (6 iterations each), mapping on frames 0, 1, 3 (8 each)
    assert len(iters) == 3 * 6 and len(maps) == 3 * 8
    for a, b in zip(mine, ref):
        for k, v in b.items():
            if k.startswith(("Per Iteration", "Tracking/", "Mapping/")):
                assert a[k] == pytest.approx(v, rel=1e-4, abs=1e-6), (k, a[k], v)
