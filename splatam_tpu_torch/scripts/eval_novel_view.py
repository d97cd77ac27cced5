"""Evaluate a saved params.npz on the train split or a held-out NVS split
(counterpart of scripts/eval_novel_view.py; the held-out split of
Replica-V2 and ScanNet++ with data.use_train_split=False).

    python -m splatam_tpu_torch.scripts.eval_novel_view <config> [--device cpu]

Reads <workdir>/<run_name>/params.npz (or the config's `scene_path`) and
writes eval_train/ (data.use_train_split, eval_sequence) or eval_nvs/
(eval_nvs) beside it, with a copy of the config. Runs on the card unless
--device cpu is given; exits 2 when asked for the card and there is none.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from splatam_tpu_torch.data import dataset_from_config
from splatam_tpu_torch.eval.evaluate import eval_nvs, eval_sequence
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.slam.config import (backfill_defaults, load_experiment_config,
                                           seed_everything)


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("experiment", type=str, help="Path to experiment file")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "eval_novel_view")

    config = backfill_defaults(load_experiment_config(args.experiment))
    seed_everything(seed=config["seed"])
    results_dir = os.path.join(config["workdir"], config["run_name"])
    os.makedirs(results_dir, exist_ok=True)
    shutil.copy(args.experiment, os.path.join(results_dir, "config.py"))

    data = config["data"]
    dataset = dataset_from_config(data)
    num_frames = data["num_frames"]
    if num_frames == -1:
        num_frames = len(dataset)
    params = dict(np.load(config.get("scene_path", os.path.join(results_dir, "params.npz")),
                          allow_pickle=True))
    common = dict(sil_thres=config["mapping"]["sil_thres"],
                  mapping_iters=config["mapping"]["num_iters"],
                  add_new_gaussians=config["mapping"]["add_new_gaussians"],
                  eval_every=config["eval_every"], device=device)
    if data["use_train_split"]:
        return eval_sequence(dataset, params, num_frames,
                             os.path.join(results_dir, "eval_train"), **common)
    return eval_nvs(dataset, params, num_frames, os.path.join(results_dir, "eval_nvs"),
                    **common)


if __name__ == "__main__":
    main()
