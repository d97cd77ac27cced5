"""ScanNet and AI2-THOR loaders. Counterpart of splatam_tpu/data/scannet.py
(reference: datasets/gradslam_datasets/scannet.py, ai2thor.py: identical
structure, different file extensions)."""
from __future__ import annotations

import glob
import os

import numpy as np

from splatam_tpu_torch.data.base import GradSLAMDataset, natsorted


class ScannetDataset(GradSLAMDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = None
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color_paths = natsorted(glob.glob(f"{self.input_folder}/color/*.jpg"))
        depth_paths = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color_paths, depth_paths, None

    def load_poses(self):
        posefiles = natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        return [np.loadtxt(p) for p in posefiles]


class Ai2thorDataset(GradSLAMDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color_paths = natsorted(glob.glob(f"{self.input_folder}/color/*.png"))
        depth_paths = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color_paths, depth_paths, None

    def load_poses(self):
        posefiles = natsorted(glob.glob(f"{self.input_folder}/pose/*.txt"))
        return [np.loadtxt(p) for p in posefiles]
