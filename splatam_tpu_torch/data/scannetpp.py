"""ScanNet++ loader: NeRFStudio transforms_undistorted.json metadata,
train/test split, OpenGL->CV pose flip P @ c2w @ P^T.

Counterpart of splatam_tpu/data/scannetpp.py (reference:
datasets/gradslam_datasets/scannetpp.py).
"""
from __future__ import annotations

import json
import os

import numpy as np

from splatam_tpu_torch.data.base import GradSLAMDataset

P_FLIP = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64
)


def create_filepath_index_mapping(frames):
    return {frame["file_path"]: index for index, frame in enumerate(frames)}


class ScannetPPDataset(GradSLAMDataset):
    def __init__(
        self,
        basedir,
        sequence,
        ignore_bad: bool = False,
        use_train_split: bool = True,
        **kwargs,
    ):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = None
        self.ignore_bad = ignore_bad
        self.use_train_split = use_train_split

        with open(f"{self.input_folder}/dslr/train_test_lists.json") as f:
            self.train_test_split = json.load(f)
        if use_train_split:
            self.image_names = self.train_test_split["train"]
        else:
            self.image_names = self.train_test_split["test"]
            self.train_image_names = self.train_test_split["train"]

        with open(f"{self.input_folder}/dslr/nerfstudio/transforms_undistorted.json") as f:
            self.cams_metadata = json.load(f)
        if use_train_split:
            self.frames_metadata = self.cams_metadata["frames"]
            self.filepath_index_mapping = create_filepath_index_mapping(self.frames_metadata)
        else:
            self.frames_metadata = self.cams_metadata["test_frames"]
            self.train_frames_metadata = self.cams_metadata["frames"]
            self.filepath_index_mapping = create_filepath_index_mapping(self.frames_metadata)
            self.train_filepath_index_mapping = create_filepath_index_mapping(
                self.train_frames_metadata
            )

        config_dict = {
            "dataset_name": "scannetpp",
            "camera_params": {
                "png_depth_scale": 1000.0,  # depth in mm
                "image_height": self.cams_metadata["h"],
                "image_width": self.cams_metadata["w"],
                "fx": self.cams_metadata["fl_x"],
                "fy": self.cams_metadata["fl_y"],
                "cx": self.cams_metadata["cx"],
                "cy": self.cams_metadata["cy"],
            },
        }
        kwargs.setdefault("desired_height", 1168)
        kwargs.setdefault("desired_width", 1752)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        base_path = f"{self.input_folder}/dslr"
        color_paths, depth_paths, self.tmp_poses = [], [], []
        if not self.use_train_split:
            # NVS mode prepends the first train frame (scannetpp.py:102-114).
            name = self.train_image_names[0]
            meta = self.train_frames_metadata[self.train_filepath_index_mapping.get(name)]
            color_paths.append(f"{base_path}/undistorted_images/{name}")
            depth_paths.append(
                f"{base_path}/undistorted_depths/{name.replace('.JPG', '.png')}"
            )
            c2w = np.array(meta["transform_matrix"], dtype=np.float64)
            self.tmp_poses.append(P_FLIP @ c2w @ P_FLIP.T)
        for name in self.image_names:
            meta = self.frames_metadata[self.filepath_index_mapping.get(name)]
            if self.ignore_bad and meta["is_bad"]:
                continue
            color_paths.append(f"{base_path}/undistorted_images/{name}")
            depth_paths.append(
                f"{base_path}/undistorted_depths/{name.replace('.JPG', '.png')}"
            )
            c2w = np.array(meta["transform_matrix"], dtype=np.float64)
            self.tmp_poses.append(P_FLIP @ c2w @ P_FLIP.T)
        return color_paths, depth_paths, None

    def load_poses(self):
        return self.tmp_poses
