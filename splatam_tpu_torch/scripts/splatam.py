"""The port's online SLAM entry point (counterpart of scripts/splatam.py).

    python -m splatam_tpu_torch.scripts.splatam configs/synthetic/splatam.py
    python -m splatam_tpu_torch.scripts.splatam <config> --device cpu

Seeds python and numpy from the config's `seed`, copies the config into
<workdir>/<run_name>/config.py (unless the run resumes from a checkpoint),
and runs rgbd_slam there: checkpoints, eval/ and params.npz land in the
same directory. Runs on the card unless --device cpu is given (the kernels'
plain versions); exits 2 when asked for the card and there is none.
"""
from __future__ import annotations

import os
import shutil

from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.slam.config import load_experiment_config, seed_everything
from splatam_tpu_torch.slam.pipeline import rgbd_slam


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("experiment", type=str, help="Path to experiment file")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "splatam")

    config = load_experiment_config(args.experiment)
    seed_everything(seed=config["seed"])
    if not config.get("load_checkpoint", False):
        results_dir = os.path.join(config["workdir"], config["run_name"])
        os.makedirs(results_dir, exist_ok=True)
        shutil.copy(args.experiment, os.path.join(results_dir, "config.py"))
    return rgbd_slam(config, device)


if __name__ == "__main__":
    main()
