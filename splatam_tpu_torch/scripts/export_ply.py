"""Export a run's params.npz to a .ply splat (counterpart of
scripts/export_ply.py).

    python -m splatam_tpu_torch.scripts.export_ply <config>

Reads <workdir>/<run_name>/params.npz and writes splat.ply beside it
(io/ply.py's layout: positions, zero normals, SH-DC colours, opacity
logit, three log-scales, wxyz rotation). It only reshapes numpy arrays on
the host, so it takes no --device.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from splatam_tpu_torch.io.ply import save_ply
from splatam_tpu_torch.slam.config import load_experiment_config


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", type=str, help="Path to config file.")
    args = ap.parse_args(argv)

    config = load_experiment_config(args.config)
    run_dir = os.path.join(config["workdir"], config["run_name"])
    params = dict(np.load(os.path.join(run_dir, "params.npz"), allow_pickle=True))
    path = os.path.join(run_dir, "splat.ply")
    save_ply(path, params["means3D"], params["log_scales"], params["unnorm_rotations"],
             params["rgb_colors"], params["logit_opacities"])
    return path


if __name__ == "__main__":
    main()
