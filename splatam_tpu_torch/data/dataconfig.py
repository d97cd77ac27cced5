"""Dataset/camera YAML config loader with recursive inherit_from merging.

Counterpart of splatam_tpu/data/dataconfig.py (reference:
datasets/gradslam_datasets/dataconfig.py:5-55), reading the YAML through
yaml_subset: the GPU machine has no PyYAML.
"""
from __future__ import annotations

from splatam_tpu_torch.data import yaml_subset


def update_recursive(dict1: dict, dict2: dict) -> None:
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = dict()
        if isinstance(v, dict):
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_dataset_config(path: str, default_path: str | None = None) -> dict:
    cfg_special = yaml_subset.load(path)

    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None:
        cfg = load_dataset_config(inherit_from, default_path)
    elif default_path is not None:
        cfg = yaml_subset.load(default_path)
    else:
        cfg = dict()

    update_recursive(cfg, cfg_special)
    return cfg
