"""NeRFCapture samples from frames in memory, and a reader that serves them:
the live path and the dataset capture driven without a DDS peer (a
recorded or synthetic stream).

A sample has the fields of dds.SplatCaptureFrame as the phone fills them:
the RGB image as uint8 bytes (row-major [H, W, 3]), the depth image as the
bytes of little-endian float32 metres ([depth_height, depth_width]), and
transform_matrix as the 16 floats of the OpenGL-convention camera-to-world
matrix in column-major order.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from splatam_tpu_torch.data.scannetpp import P_FLIP  # OpenGL <-> OpenCV axes; its own inverse


def to_sample(frame_id: int, color: np.ndarray, depth: np.ndarray | None,
              intrinsics: np.ndarray, c2w: np.ndarray) -> SimpleNamespace:
    """A sample of one frame: color [H, W, 3] in 0-255, depth [H', W'] or
    [H', W', 1] in metres (None: a sample without depth), intrinsics [3, 3]
    or [4, 4] at the colour image's size, c2w [4, 4] in the OpenCV
    convention (the one the loaders return)."""
    h, w = color.shape[:2]
    gl = P_FLIP @ np.asarray(c2w, np.float64) @ P_FLIP
    sample = SimpleNamespace(
        id=frame_id, timestamp=float(frame_id),
        fl_x=float(intrinsics[0, 0]), fl_y=float(intrinsics[1, 1]),
        cx=float(intrinsics[0, 2]), cy=float(intrinsics[1, 2]),
        transform_matrix=gl.astype(np.float32).flatten(order="F"),
        width=w, height=h,
        image=np.floor(np.clip(color, 0, 255) + 0.5).astype(np.uint8).reshape(-1),
        has_depth=depth is not None, depth_width=0, depth_height=0, depth_scale=1.0,
        depth_image=np.zeros(0, np.uint8))
    if depth is not None:
        depth = np.ascontiguousarray(depth, "<f4").reshape(depth.shape[0], depth.shape[1])
        sample.depth_height, sample.depth_width = depth.shape
        sample.depth_image = depth.view(np.uint8).reshape(-1)
    return sample


class SampleReader:
    """A reader of the samples given, in order, with DataReader.read_next's
    contract: a sample, or a falsy value when none has arrived (a None in
    the list). Raises once the list is used up, where a DDS reader would
    wait."""

    def __init__(self, samples):
        self._samples = iter(samples)

    def read_next(self):
        try:
            return next(self._samples)
        except StopIteration:
            raise RuntimeError("SampleReader: no samples left") from None
