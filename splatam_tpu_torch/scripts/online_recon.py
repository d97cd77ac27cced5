"""The online reconstruction replay: the map growing over time (counterpart
of viz_scripts/online_recon.py).

    python -m splatam_tpu_torch.scripts.online_recon <config> [--device cpu]

Reads <workdir>/<run_name>/params.npz; frame t renders the Gaussians
created at or before t (params["timestep"]) from frame t's estimated
camera, through the generic render with the config's `tpu.backend`. With
open3d installed it replays at the config's viz_fps; without it
(headless) it writes every stride-th frame (stride = frames // 200, at
least 1) to <run_dir>/online_replay/replay_####.png (data/png.py). Runs
on the card unless --device cpu is given; exits 2 when asked for the card
and there is none.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from splatam_tpu_torch.core.gaussians import from_params_dict
from splatam_tpu_torch.data.png import write_png
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.scripts.final_recon import open3d_or_none, to_uint8
from splatam_tpu_torch.slam.config import load_experiment_config
from splatam_tpu_torch.viz.scene import estimated_w2cs, load_camera, render_view


def device_map_and_timesteps(params: dict, device):
    """The whole final map on `device`, uploaded once, and each slot's
    creation time ([capacity] float32, inf on the padding slots, which so
    never activate): the replay masks `active` on the device."""
    gm = from_params_dict(params, device)
    ts = torch.full((gm.capacity,), float("inf"), dtype=torch.float32, device=gm.device)
    stamps = np.asarray(params["timestep"], np.float32)
    ts[:stamps.shape[0]] = torch.as_tensor(stamps, device=gm.device)
    return gm, ts


def replay(scene_path, viz_cfg, backend, device, out_dir=None) -> list:
    """Render the replay; headless (out_dir) write its frames. Returns the
    frames t rendered."""
    params = dict(np.load(scene_path, allow_pickle=True))
    all_w2cs = estimated_w2cs(params)
    _, k = load_camera(viz_cfg, scene_path)
    num_t = len(all_w2cs)
    fps = viz_cfg.get("viz_fps", 5)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    gm_full, ts = device_map_and_timesteps(params, device)
    stride = max(1, num_t // 200) if out_dir else 1
    frames = list(range(0, num_t, stride))
    for t in frames:
        gm_t = gm_full._replace(active=gm_full.active & (ts <= t))
        im, _, _ = render_view(gm_t, all_w2cs[t], k, viz_cfg, backend)
        if out_dir:
            write_png(os.path.join(out_dir, f"replay_{t:04d}.png"), to_uint8(im))
        else:
            time.sleep(1.0 / fps)
    if out_dir:
        print(f"Headless online replay written to {out_dir}")
    return frames


def main(argv=None) -> list:
    ap = harness.parser(__doc__)
    ap.add_argument("experiment", type=str, help="Path to experiment file")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "online_recon")
    config = load_experiment_config(args.experiment)
    run_dir = os.path.join(config["workdir"], config["run_name"])
    out_dir = None if open3d_or_none() is not None else os.path.join(run_dir, "online_replay")
    return replay(os.path.join(run_dir, "params.npz"), config["viz"],
                  config.get("tpu", {}).get("backend", "auto"), device, out_dir)


if __name__ == "__main__":
    main()
