"""Dataset loaders (host-side numpy).

Only the procedural synthetic sequence is served so far. The real-format
loaders of splatam_tpu/data read images through cv2/imageio and their
configs through yaml, none of which the GPU machine installs; they are
still to be ported (ROADMAP, module list item 3).
"""
from splatam_tpu_torch.data.synthetic import SyntheticDataset


def get_dataset(config_dict, basedir, sequence, **kwargs):
    """Dataset factory (same signature as splatam_tpu.data.get_dataset)."""
    name = config_dict["dataset_name"].lower()
    if name != "synthetic":
        raise NotImplementedError(
            f"dataset {name!r}: the real-format loaders are not ported yet "
            "(ROADMAP, module list item 3)"
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
