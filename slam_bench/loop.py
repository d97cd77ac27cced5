"""The online loop as a live user runs it, one sensor frame at a time.

A frame is splatam_tpu_torch.slam.pipeline's prepare_frame (the read of
the sensor's frame, the upload, the pose init) and run_frame (compact,
track, densify, keyframe selection, mapping, the keyframe append), closed
by a synchronize.
"""
from __future__ import annotations

import copy
import time

import torch

from slam_bench.traffic import Frames, Plan, SensorStream


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    def __init__(self, config: dict, plan: Plan, frames: Frames, device: torch.device,
                 workdir: str):
        from splatam_tpu_torch.slam.pipeline import SLAMRuntime

        self.config, self.plan, self.device = config, plan, device
        self.stream = SensorStream(plan, frames, config["camera"])
        cfg = copy.deepcopy(config["experiment"])
        cfg["workdir"] = workdir
        cfg["data"]["num_frames"] = plan.n_frames
        self.rt = SLAMRuntime(cfg, device, datasets=(self.stream, None, None))

    def frame(self, i: int, mark=None) -> float:
        """Run frame i of the traffic; returns its wall seconds."""
        from splatam_tpu_torch.slam.pipeline import prepare_frame, run_frame

        t0 = time.perf_counter()
        frame = prepare_frame(self.rt, i)
        run_frame(self.rt, i, frame, mark)
        sync(self.device)
        return time.perf_counter() - t0
