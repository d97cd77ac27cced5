"""ICL, Azure Kinect, Record3D, RealSense loaders.

Counterpart of splatam_tpu/data/misc_datasets.py (reference:
datasets/gradslam_datasets/{icl,azure,record3d,realsense}.py).
"""
from __future__ import annotations

import glob
import os

import numpy as np

from splatam_tpu_torch.data.base import GradSLAMDataset, natsorted
from splatam_tpu_torch.data.scannetpp import P_FLIP


class ICLDataset(GradSLAMDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        pose_candidates = glob.glob(os.path.join(self.input_folder, "*.gt.sim"))
        if not pose_candidates:
            raise ValueError("Need pose file ending in extension `*.gt.sim`")
        self.pose_path = pose_candidates[0]
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color_paths = natsorted(glob.glob(f"{self.input_folder}/rgb/*.png"))
        depth_paths = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color_paths, depth_paths, None

    def load_poses(self):
        with open(self.pose_path, "r") as f:
            lines = f.readlines()
        rows = []
        for line in lines:
            vals = line.strip().split()
            if len(vals) == 0:
                continue
            rows.append(np.asarray([float(v) for v in vals[:4]]))
        rows = np.stack(rows)
        poses = []
        for i in range(0, rows.shape[0], 3):
            pose = np.eye(4)
            pose[0], pose[1], pose[2] = rows[i], rows[i + 1], rows[i + 2]
            poses.append(pose)
        return poses


class AzureKinectDataset(GradSLAMDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = None
        if "odomfile" in kwargs:
            self.pose_path = os.path.join(self.input_folder, kwargs["odomfile"])
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color_paths = natsorted(glob.glob(f"{self.input_folder}/color/*.jpg"))
        depth_paths = natsorted(glob.glob(f"{self.input_folder}/depth/*.png"))
        return color_paths, depth_paths, None

    def load_poses(self):
        if self.pose_path is None:
            print("WARNING: Dataset does not contain poses. Returning identity transform.")
            return [np.eye(4) for _ in range(self.num_imgs)]
        if self.pose_path.endswith(".log"):
            with open(self.pose_path, "r") as f:
                lines = f.readlines()
            if len(lines) % 5 != 0:
                raise ValueError(
                    "Incorrect file format for .log odom file: "
                    "number of lines must be a multiple of 5"
                )
            poses = []
            for i in range(len(lines) // 5):
                rows = [list(map(float, lines[5 * i + r].split())) for r in range(1, 5)]
                poses.append(np.array(rows).reshape(4, 4))
            return poses
        poses = []
        with open(self.pose_path, "r") as f:
            for line in f.readlines():
                if len(line.split()) == 0:
                    continue
                poses.append(np.array(list(map(float, line.split()))).reshape(4, 4))
        return poses


class _NpyPoseDataset(GradSLAMDataset):
    """Shared Record3D/RealSense structure: rgb/ depth/ poses/*.npy + P flip."""

    color_ext = "png"

    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = os.path.join(self.input_folder, "poses")
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        color_paths = natsorted(
            glob.glob(os.path.join(self.input_folder, "rgb", f"*.{self.color_ext}"))
        )
        depth_paths = natsorted(glob.glob(os.path.join(self.input_folder, "depth", "*.png")))
        return color_paths, depth_paths, None

    def load_poses(self):
        posefiles = natsorted(glob.glob(os.path.join(self.pose_path, "*.npy")))
        return [P_FLIP @ np.load(p) @ P_FLIP.T for p in posefiles]


class Record3DDataset(_NpyPoseDataset):
    color_ext = "png"


class RealsenseDataset(_NpyPoseDataset):
    color_ext = "jpg"
