"""Capture a NeRFCapture iPhone stream to an on-disk dataset, no SLAM
(counterpart of scripts/nerfcapture2dataset.py).

    python -m splatam_tpu_torch.scripts.nerfcapture2dataset [--config configs/iphone/dataset.py]

Receives samples over DDS (live/dds.py, which needs cyclonedds) and saves
rgb/{i}.png, depth/{i}.png (uint16, depth * 65535 / depth_scale, resized to
the colour image's size by nearest neighbour) and a transforms.json
manifest in the layout data/nerfcapture.py reads. Images go out through
data/png.py and depth is resized by data/imgproc.py (no cv2). It only
writes files on the host, so it takes no --device.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np

from splatam_tpu_torch.data.imgproc import resize_nearest
from splatam_tpu_torch.data.png import write_png
from splatam_tpu_torch.live.dds import make_reader
from splatam_tpu_torch.slam.config import load_experiment_config


def dataset_capture_loop(reader, save_path: Path, overwrite: bool, n_frames: int,
                         depth_scale: float) -> None:
    """Save n_frames samples of `reader` under save_path (exits 1 when
    save_path/rgb exists and overwrite is off)."""
    rgb_path = save_path.joinpath("rgb")
    if rgb_path.exists():
        if overwrite:
            shutil.rmtree(save_path)
        else:
            print(f"rgb_path {rgb_path} already exists. Use overwrite=True to replace.")
            sys.exit(1)

    print("Waiting for frames...")
    images_dir = save_path.joinpath("rgb")
    manifest = {
        "fl_x": 0.0, "fl_y": 0.0, "cx": 0.0, "cy": 0.0,
        "w": 0.0, "h": 0.0,
        "frames": [],
    }
    total_frames = 0
    depth_dir = None
    while total_frames < n_frames:
        sample = reader.read_next()
        if not sample:
            continue
        print(f"{total_frames + 1}/{n_frames} frames received")
        if total_frames == 0:
            save_path.mkdir(parents=True, exist_ok=True)
            images_dir.mkdir(exist_ok=True)
            manifest.update(
                w=sample.width, h=sample.height, cx=sample.cx, cy=sample.cy,
                fl_x=sample.fl_x, fl_y=sample.fl_y,
                integer_depth_scale=float(depth_scale) / 65535.0,
            )
            if sample.has_depth:
                depth_dir = save_path.joinpath("depth")
                depth_dir.mkdir(exist_ok=True)

        image = np.asarray(sample.image, dtype=np.uint8).reshape(
            (sample.height, sample.width, 3))
        write_png(str(images_dir.joinpath(f"{total_frames}.png")), image)
        frame = {
            "transform_matrix": np.asarray(
                sample.transform_matrix, dtype=np.float32
            ).reshape(4, 4).T.tolist(),
            "file_path": f"rgb/{total_frames}.png",
            "fl_x": sample.fl_x, "fl_y": sample.fl_y,
            "cx": sample.cx, "cy": sample.cy,
            "w": sample.width, "h": sample.height,
        }
        if sample.has_depth:
            depth = np.asarray(sample.depth_image, dtype=np.uint8).view("<f4").reshape(
                (sample.depth_height, sample.depth_width))
            depth = (depth * 65535 / float(depth_scale)).astype(np.uint16)
            depth = resize_nearest(depth, sample.height, sample.width)
            write_png(str(depth_dir.joinpath(f"{total_frames}.png")), depth)
            frame["depth_path"] = f"depth/{total_frames}.png"
        manifest["frames"].append(frame)
        total_frames += 1

    with open(save_path.joinpath("transforms.json"), "w") as f:
        json.dump(manifest, f, indent=4)
    print(f"Saved {total_frames} frames to {save_path}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="./configs/iphone/dataset.py", type=str)
    args = ap.parse_args(argv)
    config = load_experiment_config(args.config)
    _domain, reader = make_reader()
    dataset_capture_loop(
        reader,
        Path(config["workdir"]) / config["run_name"],
        config.get("overwrite", False),
        config["num_frames"],
        config.get("depth_scale", 10.0),
    )


if __name__ == "__main__":
    main()
