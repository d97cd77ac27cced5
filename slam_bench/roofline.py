"""The frozen work count of the port's compositing kernels, and the card's
peaks.

What a launch has to do is counted from its own inputs by the plain
reference's rules (slam_bench/reference/render.py), whatever kernel does
it: the (pixel, pair) evaluations that contribute (alpha >= 1/255 before
the pixel's transmittance ends, in the tile's front-to-back order), times
the operations one contributing evaluation needs by the reference's
formulas, plus, for the fused kernels, the per-pair projection they do
in-kernel; and the bytes of the inputs read once and the outputs written
once. Evaluations that a kernel tries and skips are work of that kernel,
not of the algorithm, and are not counted. Nothing of the program's own
bounds (splatam_tpu_torch/render/bounds.py) is read.

Operations are counted one per add, subtract, multiply, divide, compare,
min/max and exp:

forward, per contributing evaluation (30): d = xy - pixel (2); power =
-0.5 (a dx^2 + c dy^2) - b dx dy (9); the power > 0 test (1); exp (1);
alpha = opacity * G and its clamp at 0.99 (2); the alpha < 1/255 test (1);
T (1 - alpha) and its test against 1e-4 (3); the weight alpha T (1); five
channels accumulated, a multiply and an add each (10).

backward, per contributing evaluation (90): the forward's d, power, G,
alpha and tests again (16); T recovered as T / (1 - alpha) (2); the
channels' gradients alpha T g_k, five channels (11); the running
back-to-front colour of six channels (r, g, b, z, z^2 and the silhouette's
constant 1) (19); dL/dalpha = T sum_k (c_k - accum_k) g_k (19); the clamp
test and dL/dG (2); dL/dpower (1); dL/dx and dL/dy, -(a dx + b dy) and
-(b dx + c dy) times dL/dpower (8); dL/d(a, b, c) (5); the pair's running
sums of dxy, dconic and dopacity (7).

the fused kernels' per-pair projection (K4: 69): the world-to-camera
transform (18), NDC and pixel coordinates (16), the Jacobian's clamped
tx/tz and ty/tz (8), its four entries (6), the covariance s^2 J J^T + 0.3
(12), its determinant and inverse (4), the conic (5); K5 repeats it and
takes two operations for each of them in the chain rule (207).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from slam_bench.reference import render

PEAK_FLOPS_F32 = 67e12  # H100 SXM, float32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# kernel -> (operations per contributing evaluation, per pair)
OPS = {
    "fused_forward": (30, 69),
    "fused_backward": (90, 207),
    "composite_forward": (30, 0),
    "composite_backward": (90, 0),
}
FORWARD_OF = {"fused_backward": "fused_forward", "composite_backward": "composite_forward"}


class Work(NamedTuple):
    kernel: str
    evaluations: int  # contributing (pixel, pair) evaluations
    pairs: int
    ops: float
    bytes: float

    @property
    def bound_s(self) -> float:
        return max(self.ops / PEAK_FLOPS_F32, self.bytes / PEAK_BYTES)


class Launch(NamedTuple):
    """One recorded launch: the kernel's name and its inputs."""

    kernel: str
    rows: torch.Tensor  # world-8 rows (fused) or attribute rows (composite)
    pose: torch.Tensor | None  # the fused kernels' pose vector
    tile_start: torch.Tensor
    pair_gauss: torch.Tensor | None
    width: int
    height: int
    channels: int

    def key(self) -> tuple:
        """Identifies the render: a backward launch shares its forward's inputs."""
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        return (FORWARD_OF.get(self.kernel, self.kernel), ptr(self.rows), ptr(self.pose),
                ptr(self.tile_start), ptr(self.pair_gauss))


def _screen_rows(launch: Launch):
    """rows(pair indices) for render.composite: each pair's xy, conic and
    opacity as the launch's inputs give them (the fused rows projected by
    the reference's projection at the launch's pose)."""
    idx = launch.pair_gauss.long() if launch.pair_gauss is not None else None
    r = launch.rows
    if launch.kernel.startswith("fused"):
        pose = launch.pose
        k = render.Intrinsics(launch.width, launch.height, *(float(v) for v in pose[12:16]))
        s = render.project(r[:, 0:3], r[:, 3], r[:, 4], pose[0:9].reshape(3, 3), pose[9:12], k)
        xy, conic, opacity = s.xy, s.conic, s.opacity
    else:
        xy, conic, opacity = r[:, 0:2], r[:, 2:5], r[:, 5]
    zero = torch.zeros((1,), device=r.device)

    def rows(pidx):
        g = pidx if idx is None else idx[pidx]
        return xy[g], conic[g], opacity[g], zero.expand(*pidx.shape, 1)
    return rows


def evaluations(launch: Launch) -> int:
    """Contributing (pixel, pair) evaluations of the launch's render."""
    n_pairs = int(launch.tile_start[-1])
    bins = render.Bins(torch.arange(n_pairs, device=launch.rows.device),
                       launch.tile_start.long())
    k = render.Intrinsics(launch.width, launch.height, 1.0, 1.0, 0.0, 0.0)
    return render.contributing(bins, _screen_rows(launch), k)


def work(launch: Launch, n_contrib: int) -> Work:
    per_eval, per_pair = OPS[launch.kernel]
    n_pairs = int(launch.tile_start[-1])
    rows_read = (n_pairs if launch.pair_gauss is None
                 else int(torch.unique(launch.pair_gauss).numel()))
    row_bytes = launch.rows.shape[1] * 4
    pix = launch.width * launch.height
    ch = launch.channels
    read = rows_read * row_bytes + launch.tile_start.numel() * 4
    if launch.pair_gauss is not None:
        read += n_pairs * 4
    if launch.pose is not None:
        read += launch.pose.numel() * 4
    if launch.kernel.endswith("forward"):
        written = (ch + 2) * pix * 4
    else:
        read += ((ch + 2) + (ch + 1)) * pix * 4  # the forward's state and the cotangents
        written = n_pairs * row_bytes
    return Work(launch.kernel, n_contrib, n_pairs,
                float(n_contrib) * per_eval + float(n_pairs) * per_pair, float(read + written))
