"""The single-card entry check: one render of a random scene through the kernels.

Counterpart of __graft_entry__.py entry() (:29-47): the RGB-D-silhouette
render (tracking's forward pass) of a 2,048-Gaussian scene drawn from seed
0 with numpy (__graft_entry__.py _make_scene, the port's copy in
dryrun_multichip.make_scene) through a 160x128 camera with fx = fy = 120.
entry(device) returns (fn, args): fn(*args) is (im [3, H, W], depth
[H, W], silhouette [H, W]) from render_rgbd_sil, K1 on the card (its
plain version with device="cpu"). The JAX function's RenderConfig has no
counterpart (its pair buffer and tile lists are sized exactly here).

    python -m splatam_tpu_torch.scripts.entry [--device cpu]

prints the three shapes, whether they are finite, and K1's launches.
"""
from __future__ import annotations

import torch

from splatam_tpu_torch import kernels
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.render.api import render_rgbd_sil
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.scripts.dryrun_multichip import make_scene
from splatam_tpu_torch.utils.device import require_device

N_GAUSS = 2048
CAM = Camera(height=128, width=160, fx=120.0, fy=120.0, cx=80.0, cy=64.0)


def entry(device="cuda"):
    """(fn, args): fn(*args) renders the scene (means3d, rgb, rotations,
    opacity logits, log-scales, active) and returns (im, depth,
    silhouette). Raises when asked for the card and there is none."""
    device = require_device(device, "entry")
    args = tuple(torch.tensor(a, device=device) for a in make_scene(N_GAUSS).values())

    def fn(means3d, rgb, rots, logit_op, log_scales, active):
        out = render_rgbd_sil(CAM, means3d, rgb, rots, logit_op, log_scales, active)
        return out.im, out.depth, out.silhouette

    return fn, args


def main(argv=None) -> tuple:
    ap = harness.parser(__doc__)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "entry")
    fn, inputs = entry(device)
    kernels.reset_launch_counts()
    with torch.no_grad():
        outs = fn(*inputs)
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    print(f"entry on {harness.describe(device)}: im {tuple(outs[0].shape)}, depth "
          f"{tuple(outs[1].shape)}, silhouette {tuple(outs[2].shape)}, finite={finite}, "
          f"K1 launches {kernels.launch_counts()['composite_forward']}", flush=True)
    return outs


if __name__ == "__main__":
    main()
