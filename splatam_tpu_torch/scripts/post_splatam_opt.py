"""Refine a SplaTAM map after the run (counterpart of
scripts/post_splatam_opt.py; reference scripts/post_splatam_opt.py:
160-407).

    python -m splatam_tpu_torch.scripts.post_splatam_opt configs/replica/post_splatam_opt.py
    python -m splatam_tpu_torch.scripts.post_splatam_opt <config> --device cpu

Loads data.param_ckpt_path (a params.npz of either package), keeps its
camera poses fixed, and trains the map with the offline programs' chunked
trainer (gaussian_splatting.train_offline: 3DGS clone/split between
chunks) at the mapping size; then the evaluation into eval/, params.npz
(the checkpoint's poses, zero timesteps, its keyframe_time_indices) and a
copy of the config, in <workdir>/<run_name>/. Runs on the card unless
--device cpu is given; exits 2 when asked for the card and there is none.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from splatam_tpu_torch.core import gaussians as G
from splatam_tpu_torch.core.camera import setup_camera
from splatam_tpu_torch.eval.evaluate import eval_sequence
from splatam_tpu_torch.io.params_io import save_params
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.scripts.gaussian_splatting import (_build_dataset, _with_record,
                                                          train_offline)
from splatam_tpu_torch.slam.config import load_experiment_config, seed_everything
from splatam_tpu_torch.utils.device import require_device


def post_opt(config: dict, device="cuda") -> dict:
    """Run the refinement on `device` (the card unless the caller asks for
    the CPU); returns the evaluation's metrics with the trainer's record
    (gaussian_splatting._with_record)."""
    device = require_device(device, "post_opt")
    print("Loaded Config:")
    print(f"{config}")
    data, train = config["data"], config["train"]
    h, w = data["desired_image_height"], data["desired_image_width"]
    mapping_dataset = _build_dataset(config, h, w)
    eval_dataset = _build_dataset(config, h, w, stride=data.get("eval_stride",
                                                                 data.get("stride", 1)))
    num_frames = data.get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(mapping_dataset)
    eval_num_frames = data.get("eval_num_frames", -1)
    if eval_num_frames == -1:
        eval_num_frames = len(eval_dataset)

    ckpt = dict(np.load(data["param_ckpt_path"], allow_pickle=True))
    gm = G.from_params_dict(ckpt, device)
    cam_rots = np.asarray(ckpt["cam_unnorm_rots"])[0].T.astype(np.float32)  # [F, 4]
    cam_trans = np.asarray(ckpt["cam_trans"])[0].T.astype(np.float32)  # [F, 3]
    c0, d0, m_intr4, pose0 = mapping_dataset[0]
    map_intrinsics = m_intr4[:3, :3]
    map_cam = setup_camera(c0.shape[1], c0.shape[0], map_intrinsics, None)
    scene_radius = float(d0.max()) / 2.0
    timestep = torch.zeros((gm.capacity,), dtype=torch.float32, device=device)

    gm, _, record = train_offline(gm, timestep, mapping_dataset, map_cam, num_frames, cam_rots,
                                  cam_trans, config, scene_radius, "Post-SplaTAM mapping")

    output_dir = os.path.join(config["workdir"], config["run_name"])
    params = G.compact_to_numpy(gm)
    params["timestep"] = np.zeros(params["means3D"].shape[0], np.float32)
    params["cam_unnorm_rots"] = cam_rots.T[None]
    params["cam_trans"] = cam_trans.T[None]
    params["intrinsics"] = map_intrinsics
    params["w2c"] = np.linalg.inv(pose0)
    params["org_width"] = data["desired_image_width"]
    params["org_height"] = data["desired_image_height"]
    if "gt_w2c_all_frames" in ckpt:
        params["gt_w2c_all_frames"] = ckpt["gt_w2c_all_frames"]
    params["keyframe_time_indices"] = ckpt.get("keyframe_time_indices", np.array([]))
    num_iters = int(train["num_iters_mapping"])
    metrics = eval_sequence(eval_dataset, params, eval_num_frames,
                            os.path.join(output_dir, "eval"), sil_thres=train["sil_thres"],
                            mapping_iters=num_iters, add_new_gaussians=True,
                            eval_every=config.get("eval_every", 1), device=device)
    save_params(params, output_dir)
    return _with_record(metrics, record)


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("experiment", type=str, help="Path to experiment file")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "post_splatam_opt")
    config = load_experiment_config(args.experiment)
    seed_everything(seed=config["seed"])
    results_dir = os.path.join(config["workdir"], config["run_name"])
    os.makedirs(results_dir, exist_ok=True)
    shutil.copy(args.experiment, os.path.join(results_dir, "config.py"))
    return post_opt(config, device)


if __name__ == "__main__":
    main()
