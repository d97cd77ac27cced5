"""TUM RGB-D loader: timestamp association + 32fps thinning.

Counterpart of splatam_tpu/data/tum.py (reference:
datasets/gradslam_datasets/tum.py).
"""
from __future__ import annotations

import os

import numpy as np

from splatam_tpu_torch.data.base import GradSLAMDataset


class TUMDataset(GradSLAMDataset):
    def __init__(self, config_dict, basedir, sequence, **kwargs):
        self.input_folder = os.path.join(basedir, sequence)
        self.pose_path = None
        super().__init__(config_dict, **kwargs)

    def parse_list(self, filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)

    def associate_frames(self, tstamp_image, tstamp_depth, tstamp_pose, max_dt=0.08):
        associations = []
        for i, t in enumerate(tstamp_image):
            j = np.argmin(np.abs(tstamp_depth - t))
            k = np.argmin(np.abs(tstamp_pose - t))
            if (np.abs(tstamp_depth[j] - t) < max_dt) and (np.abs(tstamp_pose[k] - t) < max_dt):
                associations.append((i, j, k))
        return associations

    def pose_matrix_from_quaternion(self, pvec):
        from scipy.spatial.transform import Rotation

        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pvec[3:]).as_matrix()
        pose[:3, 3] = pvec[:3]
        return pose

    def _associated(self):
        if os.path.isfile(os.path.join(self.input_folder, "groundtruth.txt")):
            pose_list = os.path.join(self.input_folder, "groundtruth.txt")
        else:
            pose_list = os.path.join(self.input_folder, "pose.txt")
        image_data = self.parse_list(os.path.join(self.input_folder, "rgb.txt"))
        depth_data = self.parse_list(os.path.join(self.input_folder, "depth.txt"))
        pose_data = self.parse_list(pose_list, skiprows=1)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        tstamp_image = image_data[:, 0].astype(np.float64)
        tstamp_depth = depth_data[:, 0].astype(np.float64)
        tstamp_pose = pose_data[:, 0].astype(np.float64)
        associations = self.associate_frames(tstamp_image, tstamp_depth, tstamp_pose)

        # Thin to 32 fps (tum.py:101-106).
        frame_rate = 32
        indicies = [0]
        for i in range(1, len(associations)):
            t0 = tstamp_image[associations[indicies[-1]][0]]
            t1 = tstamp_image[associations[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indicies += [i]
        return image_data, depth_data, pose_vecs, associations, indicies

    def get_filepaths(self):
        image_data, depth_data, _, associations, indicies = self._associated()
        color_paths, depth_paths = [], []
        for ix in indicies:
            (i, j, _) = associations[ix]
            color_paths.append(os.path.join(self.input_folder, image_data[i, 1]))
            depth_paths.append(os.path.join(self.input_folder, depth_data[j, 1]))
        return color_paths, depth_paths, None

    def load_poses(self):
        _, _, pose_vecs, associations, indicies = self._associated()
        return [self.pose_matrix_from_quaternion(pose_vecs[associations[ix][2]]) for ix in indicies]
