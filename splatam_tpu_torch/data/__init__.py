"""Dataset loaders (host-side numpy), and a frame's move to the device.

Counterpart of splatam_tpu/data: the procedural synthetic sequence and the
eleven real formats (Replica, Replica-V2, TUM RGB-D, ScanNet, AI2-THOR,
ScanNet++, NeRFCapture, ICL, Azure Kinect, Record3D, RealSense). The GPU
machine has no cv2, imageio or PyYAML: dataset YAMLs are read by
yaml_subset, resizing and undistortion are numpy (imgproc), and images are
read through Pillow where it imports, else PNGs through png.read_png (a
JPEG then cannot be read; base.ImageReader says which reader it uses).
"""
import os

import torch

from splatam_tpu_torch.data.dataconfig import load_dataset_config
from splatam_tpu_torch.data.misc_datasets import (
    AzureKinectDataset,
    ICLDataset,
    Record3DDataset,
    RealsenseDataset,
)
from splatam_tpu_torch.data.nerfcapture import NeRFCaptureDataset
from splatam_tpu_torch.data.replica import ReplicaDataset, ReplicaV2Dataset
from splatam_tpu_torch.data.scannet import Ai2thorDataset, ScannetDataset
from splatam_tpu_torch.data.scannetpp import ScannetPPDataset
from splatam_tpu_torch.data.synthetic import SyntheticDataset
from splatam_tpu_torch.data.tum import TUMDataset
from splatam_tpu_torch.utils import spans

_BY_NAME = {"icl": ICLDataset, "replica": ReplicaDataset, "replicav2": ReplicaV2Dataset,
            "azure": AzureKinectDataset, "azurekinect": AzureKinectDataset,
            "scannet": ScannetDataset, "ai2thor": Ai2thorDataset,
            "record3d": Record3DDataset, "realsense": RealsenseDataset, "tum": TUMDataset}


def get_dataset(config_dict, basedir, sequence, **kwargs):
    """Dataset factory (splatam_tpu/data/__init__.py:18-56; reference:
    scripts/splatam.py:40-64, plus 'synthetic')."""
    name = config_dict["dataset_name"].lower()
    if name in _BY_NAME:
        return _BY_NAME[name](config_dict, basedir, sequence, **kwargs)
    if name == "scannetpp":
        return ScannetPPDataset(basedir, sequence, **kwargs)
    if name == "nerfcapture":
        return NeRFCaptureDataset(basedir, sequence, **kwargs)
    if name == "synthetic":
        return SyntheticDataset(
            num_frames=config_dict.get("num_frames", 30),
            height=kwargs.get("desired_height", 120),
            width=kwargs.get("desired_width", 160),
            seed=config_dict.get("synthetic_seed", 0),
            motion_scale=config_dict.get("motion_scale", 1.0),
            depth_noise_sigma=config_dict.get("depth_noise_sigma", 0.0),
            trajectory=config_dict.get("trajectory", "pan"),
            texture_octaves=config_dict.get("texture_octaves", 2),
        )
    raise ValueError(f"Unknown dataset name {config_dict['dataset_name']}")


def _dataset_maker(data: dict):
    """make(h, w, stride=None): the dataset an experiment config's `data`
    section names, at h x w and the given stride (the section's `stride`
    where None), as the reference package's runtime and offline programs
    build it (splatam_tpu/slam/pipeline.py _make_datasets,
    scripts/gaussian_splatting.py:40-60): the YAML named by
    gradslam_data_cfg, or the section's dataset_name (the synthetic
    sequence takes its knobs from the section)."""
    if "gradslam_data_cfg" not in data:
        gradslam_data_cfg = {"dataset_name": data["dataset_name"]}
    else:
        gradslam_data_cfg = load_dataset_config(data["gradslam_data_cfg"])
    if "synthetic" in gradslam_data_cfg.get("dataset_name", "").lower():
        gradslam_data_cfg.setdefault("num_frames", data.get("num_frames", 30))
        for knob in ("motion_scale", "depth_noise_sigma", "synthetic_seed", "trajectory"):
            if knob in data:
                gradslam_data_cfg.setdefault(knob, data[knob])

    def make(h, w, stride=None):
        return get_dataset(
            config_dict=gradslam_data_cfg,
            basedir=data.get("basedir", ""),
            sequence=os.path.basename(str(data.get("sequence", ""))),
            start=data.get("start", 0),
            end=data.get("end", -1),
            stride=data.get("stride", 1) if stride is None else stride,
            desired_height=h,
            desired_width=w,
            relative_pose=True,
            ignore_bad=data.get("ignore_bad", False),
            use_train_split=data.get("use_train_split", True),
        )

    return make


def make_datasets(config: dict):
    """(dataset, densify_dataset, tracking_dataset) of a backfilled config:
    the second and third only where their size differs from the main
    one's, else None (splatam_tpu/slam/pipeline.py:248-297)."""
    data = config["data"]
    make = _dataset_maker(data)
    size = (data["desired_image_height"], data["desired_image_width"])
    densify = (data["densification_image_height"], data["densification_image_width"])
    tracking = (data["tracking_image_height"], data["tracking_image_width"])
    return (make(*size), make(*densify) if densify != size else None,
            make(*tracking) if tracking != size else None)


def dataset_from_config(data: dict):
    """The main dataset of an experiment config's `data` section."""
    return _dataset_maker(data)(data["desired_image_height"], data["desired_image_width"])


def frame_to_tensors(color_np, depth_np, device):
    """Dataset frame (HWC 0-255 color, HW1 depth) -> ([3,H,W], [H,W]) on
    `device`, float32."""
    color = torch.as_tensor(color_np.transpose(2, 0, 1) / 255.0, dtype=torch.float32)
    depth = torch.as_tensor(depth_np[..., 0], dtype=torch.float32)
    with spans.waited("frame.upload"):  # blocking copies from pageable memory
        color = color.to(device)
    with spans.waited("frame.upload"):
        depth = depth.to(device)
    return color, depth
