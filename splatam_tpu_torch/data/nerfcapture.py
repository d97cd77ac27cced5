"""NeRFCapture (iPhone) loader: transforms.json + rgb/ depth/ dirs,
depth scale 6553.5, OpenGL->CV flip.

Counterpart of splatam_tpu/data/nerfcapture.py (reference:
datasets/gradslam_datasets/nerfcapture.py).
"""
from __future__ import annotations

import json
import os

import numpy as np

from splatam_tpu_torch.data.base import GradSLAMDataset, natsorted
from splatam_tpu_torch.data.scannetpp import P_FLIP, create_filepath_index_mapping


class NeRFCaptureDataset(GradSLAMDataset):
    def __init__(self, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = None

        with open(f"{self.input_folder}/transforms.json") as f:
            self.cams_metadata = json.load(f)
        self.frames_metadata = self.cams_metadata["frames"]
        self.filepath_index_mapping = create_filepath_index_mapping(self.frames_metadata)

        self.image_names = natsorted(os.listdir(f"{self.input_folder}/rgb"))
        self.image_names = [f"rgb/{n}" for n in self.image_names]

        config_dict = {
            "dataset_name": "nerfcapture",
            "camera_params": {
                "png_depth_scale": 6553.5,
                "image_height": self.cams_metadata["h"],
                "image_width": self.cams_metadata["w"],
                "fx": self.cams_metadata["fl_x"],
                "fy": self.cams_metadata["fl_y"],
                "cx": self.cams_metadata["cx"],
                "cy": self.cams_metadata["cy"],
            },
        }
        kwargs.setdefault("desired_height", 1440)
        kwargs.setdefault("desired_width", 1920)
        super().__init__(config_dict, **kwargs)

    def get_filepaths(self):
        base_path = self.input_folder
        color_paths, depth_paths, self.tmp_poses = [], [], []
        for name in self.image_names:
            meta = self.frames_metadata[self.filepath_index_mapping.get(name)]
            color_paths.append(f"{base_path}/{name}")
            depth_paths.append(f"{base_path}/{name.replace('rgb', 'depth')}")
            c2w = np.array(meta["transform_matrix"], dtype=np.float64)
            self.tmp_poses.append(P_FLIP @ c2w @ P_FLIP.T)
        return color_paths, depth_paths, None

    def load_poses(self):
        return self.tmp_poses
