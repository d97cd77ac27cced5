"""Replica and Replica-V2 (vMAP split) loaders.

Counterpart of splatam_tpu/data/replica.py (reference:
datasets/gradslam_datasets/replica.py).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from splatam_tpu_torch.data.base import GradSLAMDataset, natsorted


class ReplicaDataset(GradSLAMDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, "traj.txt")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color_paths = natsorted(glob.glob(f"{self.input_folder}/results/frame*.jpg"))
        depth_paths = natsorted(glob.glob(f"{self.input_folder}/results/depth*.png"))
        return color_paths, depth_paths, None

    def load_poses(self):
        with open(self.pose_path, "r") as f:
            lines = f.readlines()
        poses = []
        for i in range(self.num_imgs):
            c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            poses.append(c2w)
        return poses


class ReplicaV2Dataset(GradSLAMDataset):
    def __init__(self, config_dict, basedir, sequence, use_train_split: bool = True, **kwargs):
        self.use_train_split = use_train_split
        if use_train_split:
            self.input_folder = os.path.join(basedir, sequence, "imap/00")
            self.pose_path = os.path.join(self.input_folder, "traj_w_c.txt")
        else:
            self.train_input_folder = os.path.join(basedir, sequence, "imap/00")
            self.train_pose_path = os.path.join(self.train_input_folder, "traj_w_c.txt")
            self.input_folder = os.path.join(basedir, sequence, "imap/01")
            self.pose_path = os.path.join(self.input_folder, "traj_w_c.txt")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        if self.use_train_split:
            color_paths = natsorted(glob.glob(f"{self.input_folder}/rgb/rgb_*.png"))
            depth_paths = natsorted(glob.glob(f"{self.input_folder}/depth/depth_*.png"))
        else:
            # NVS split prepends the first train frame (replica.py:108-120).
            color_paths = [f"{self.train_input_folder}/rgb/rgb_0.png"] + natsorted(
                glob.glob(f"{self.input_folder}/rgb/rgb_*.png")
            )
            depth_paths = [f"{self.train_input_folder}/depth/depth_0.png"] + natsorted(
                glob.glob(f"{self.input_folder}/depth/depth_*.png")
            )
        return color_paths, depth_paths, None

    def load_poses(self):
        poses = []
        if not self.use_train_split:
            with open(self.train_pose_path, "r") as f:
                first = f.readlines()[0]
            poses.append(np.array(list(map(float, first.split()))).reshape(4, 4))
        with open(self.pose_path, "r") as f:
            lines = f.readlines()
        num_poses = self.num_imgs if self.use_train_split else self.num_imgs - 1
        for i in range(num_poses):
            poses.append(np.array(list(map(float, lines[i].split()))).reshape(4, 4))
        return poses
