"""Dataset loaders (host-side numpy), and a frame's move to the device.

Only the procedural synthetic sequence is served so far. The real-format
loaders of splatam_tpu/data read images through cv2/imageio and their
configs through yaml, none of which the GPU machine installs; they are
still to be ported (ROADMAP, module list item 1.7).
"""
import torch

from splatam_tpu_torch.data.synthetic import SyntheticDataset


def get_dataset(config_dict, basedir, sequence, **kwargs):
    """Dataset factory (same signature as splatam_tpu.data.get_dataset)."""
    name = config_dict["dataset_name"].lower()
    if name != "synthetic":
        raise NotImplementedError(
            f"dataset {name!r}: the real-format loaders are not ported yet "
            "(ROADMAP, module list item 1.7)"
        )
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


def dataset_from_config(data: dict):
    """The dataset an experiment config's `data` section names, as the
    reference package's runtime builds it (splatam_tpu/slam/pipeline.py
    _make_datasets): the synthetic sequence takes its knobs from the
    section."""
    return get_dataset(
        config_dict={"dataset_name": data["dataset_name"],
                     "num_frames": data.get("num_frames", 30),
                     **{k: data[k] for k in ("motion_scale", "depth_noise_sigma",
                                             "synthetic_seed", "trajectory") if k in data}},
        basedir=data.get("basedir", ""),
        sequence=str(data.get("sequence", "")),
        desired_height=data["desired_image_height"],
        desired_width=data["desired_image_width"],
    )


def frame_to_tensors(color_np, depth_np, device):
    """Dataset frame (HWC 0-255 color, HW1 depth) -> ([3,H,W], [H,W]) on
    `device`, float32."""
    color = torch.as_tensor(color_np.transpose(2, 0, 1) / 255.0, dtype=torch.float32)
    depth = torch.as_tensor(depth_np[..., 0], dtype=torch.float32)
    return color.to(device), depth.to(device)
