"""The repo's six offline configs (configs/{replica,scannetpp,iphone}/
{gaussian_splatting,post_splatam_opt}.py) read the same way by the port's
programs and the JAX package's.

Each program runs to its end on stand-in data with its work replaced by
recorders: the datasets (8x8 frames, the sizes and strides asked for
recorded), the silhouette densification, the training chunk, the densify
pass and the evaluation. What the recorders saw must be equal: every
dataset's size and stride, each chunk's length, start iteration, learning
rates, schedule (lr_init, lr_final, delay_mult, max_steps), loss weights
and statistics switch, every densify pass's DensifyConfig, iteration and
`final` flag and scene radius, and every evaluation's frame count,
directory, sil_thres, mapping_iters, add_new_gaussians and eval_every.
configs/iphone/gaussian_splatting.py is the reference's SLAM config (it
has no `train` section), so both programs stop at the same KeyError.
"""
import dataclasses
import inspect
import os
import sys

import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

from splatam_tpu.slam import steps as jsteps
from splatam_tpu.slam import steps_gs as jsteps_gs
from splatam_tpu.slam.config import load_experiment_config, seed_everything
from splatam_tpu_torch.scripts import gaussian_splatting as tgs
from splatam_tpu_torch.scripts import post_splatam_opt as tpo
from splatam_tpu_torch.slam import steps, steps_gs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = [f"configs/{d}/{p}.py" for d in ("replica", "scannetpp", "iphone")
           for p in ("gaussian_splatting", "post_splatam_opt")]
CHUNK_KEYS = ("start_iter", "num_iters", "lrs", "w_im", "w_depth", "lr_sched", "track_stats")


class _Frames:
    """Stand-in dataset: 40 frames of 8x8, recording the size and stride
    it was built for."""

    def __init__(self, log, h, w, stride):
        log.append(("dataset", h, w, stride))

    def __len__(self):
        return 40

    def __getitem__(self, i):
        k = np.eye(4, dtype=np.float32)
        k[0, 0] = k[1, 1] = 8.0
        k[0, 2] = k[1, 2] = 4.0
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.01 * i
        return (np.full((8, 8, 3), 128.0, np.float32), np.full((8, 8, 1), 2.0, np.float32), k,
                pose)


def _checkpoint(path):
    n, f = 32, 40
    rng = np.random.default_rng(0)
    np.savez(path, means3D=rng.normal(size=(n, 3)).astype(np.float32),
             rgb_colors=np.full((n, 3), 0.5, np.float32),
             unnorm_rotations=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
             logit_opacities=np.zeros((n, 1), np.float32),
             log_scales=np.full((n, 3), -3.0, np.float32),
             cam_unnorm_rots=np.tile(np.float32([1, 0, 0, 0])[None, :, None], (1, 1, f)),
             cam_trans=np.zeros((1, 3, f), np.float32), keyframe_time_indices=np.arange(4))


def _record(log, tag, fn, keys):
    sig = inspect.signature(fn)

    def rec(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        log.append((tag,) + tuple(_plain(bound.arguments[k]) for k in keys))
        return bound

    return rec


def _plain(x):
    if dataclasses.is_dataclass(x):
        return tuple(sorted(dataclasses.asdict(x).items()))
    if torch.is_tensor(x) or hasattr(x, "dtype"):
        return float(np.asarray(x))
    return x


def _run(mp, package, config, tmp_path):
    """Run one package's program on stand-in data; returns the log."""
    log = []
    post = "param_ckpt_path" in config["data"]
    if post:
        config["data"]["param_ckpt_path"] = str(tmp_path / "ckpt.npz")
    config["workdir"] = str(tmp_path / package)

    def build(cfg, h, w, stride=None):
        return _Frames(log, h, w, stride)

    def evaluate(dataset, params, num_frames, eval_dir, **kw):
        kw = {k: v for k, v in kw.items() if k not in ("rcfg", "device")}
        log.append(("eval", num_frames, os.path.basename(eval_dir), tuple(sorted(kw.items()))))
        return {"psnr": 0.0}

    if package == "jax":
        import gaussian_splatting as prog
        import post_splatam_opt as post_prog

        gs_mod, st_mod, fn = jsteps_gs, jsteps, (post_prog.post_opt if post else
                                                 prog.offline_splatting)
        mods = (prog, post_prog)
    else:
        gs_mod, st_mod, fn = steps_gs, steps, (tpo.post_opt if post else tgs.offline_splatting)
        mods = (tgs, tpo)
    for mod in mods:
        mp.setattr(mod, "_build_dataset", build, raising=False)
        mp.setattr(mod, "eval_sequence", evaluate)
    chunk = _record(log, "chunk", gs_mod.gs_mapping_chunk, CHUNK_KEYS)
    mp.setattr(gs_mod, "gs_mapping_chunk",
               lambda *a, **k: (lambda b: (b.arguments["gm"], b.arguments["gsvars"],
                                           b.arguments["opt_state"], 0.0))(chunk(*a, **k)))
    dense = _record(log, "densify", gs_mod.densify_3dgs_step,
                    ("cfg", "it", "final", "scene_radius"))
    overflow = (0,) if package == "jax" else ()
    mp.setattr(gs_mod, "densify_3dgs_step",
               lambda *a, **k: (lambda b: (b.arguments["gm"], b.arguments["gsvars"],
                                           b.arguments["opt_state"]) + overflow)(dense(*a, **k)))
    sil = _record(log, "silhouette", st_mod.densify_step, ("sil_thres",))

    def densify_step(*a, **k):
        b = sil(*a, **k)
        rest = (0, 0, 0, 0) if package == "jax" else (0, 0)
        return (b.arguments["gm"], b.arguments["timestep"]) + rest

    mp.setattr(st_mod, "densify_step", densify_step)
    seed_everything(0)
    fn(config) if package == "jax" else fn(config, "cpu")
    return log


@pytest.mark.parametrize("path", CONFIGS)
def test_offline_config_keys_match_jax(path, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    torch.set_num_threads(1)
    _checkpoint(tmp_path / "ckpt.npz")
    logs = []
    for package in ("jax", "port"):
        config = load_experiment_config(path)
        with pytest.MonkeyPatch.context() as mp:
            if "train" not in config:
                with pytest.raises(KeyError, match="train"):
                    _run(mp, package, config, tmp_path)
                continue
            logs.append(_run(mp, package, config, tmp_path))
    if not logs:
        return
    jax_log, port_log = logs
    kinds = {entry[0] for entry in jax_log}
    assert {"dataset", "chunk", "densify", "eval"} <= kinds, kinds
    assert port_log == jax_log
