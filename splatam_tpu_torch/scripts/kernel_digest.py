"""Digests of the SLAM loop's kernel outputs on one seeded map, to show that
two builds of the kernels give the same outputs bit for bit.

Prints one line per kernel, the sha256 of its output's bytes: K1, K2, K3 at
8 and 11 columns, K4, K5 and the probes fwd2 and math_only, each at five
channels on the profile map of scene.py (opacity logit 1.0, identity pose)
with seeded cotangents. Run it once against each tree, the same file with
each tree's package first on the path:

    PYTHONPATH=<tree> python <this file> [--n 950272]

It calls only wrappers whose signatures have not changed since the fused
kernels' two input modes.
"""
from __future__ import annotations

import hashlib

import torch

from splatam_tpu_torch.render import api, binning, composite, fused_iso, probes
from splatam_tpu_torch.scripts import harness, scene


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def outputs(n: int, w: int, h: int, device) -> dict:
    gm, q, t, cam = scene.synthetic_scene(n, w, h, 1.0, device)
    gen = torch.Generator(device).manual_seed(0)
    ps, pose = scene.fused_inputs(gm, q, t, cam)
    out = {"K4": fused_iso.fused_forward(ps.world8, pose, ps.tile_start, w, h)}
    g = torch.randn((6, h, w), device=device, generator=gen)
    out["K5"] = fused_iso.fused_backward(ps.world8, pose, ps.tile_start, w, h, out["K4"], g)
    out["K3-8"] = composite.segment_reduce(out["K5"], ps.dst, ps.offsets, ps.counts)
    out["fwd2"] = probes.fwd2(ps.world8, pose, ps.tile_start, w, h)
    out["math_only"] = probes.math_only(ps.world8, pose, ps.tile_start, w, h)
    proj, aux = api.project_gaussians(cam, gm.means3d, gm.unnorm_rotations, gm.logit_opacities,
                                      gm.log_scales, gm.active)
    b = binning.build_bins(proj, aux, w, h)
    d = proj.depth[:, None]
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], gm.rgb_colors, d, d * d],
                      1).contiguous()
    out["K1"] = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, w, h)
    g2 = torch.randn((6, h, w), device=device, generator=gen)
    out["K2"] = composite.composite_backward(attrs, b.pair_gauss, b.tile_start, w, h, out["K1"],
                                             g2)
    out["K3-11"] = composite.segment_reduce(out["K2"], b.dst, b.offsets, b.counts)
    return out


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--n", type=int, default=950272)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "kernel_digest")
    digests = {k: digest(v) for k, v in outputs(args.n, args.w, args.h, device).items()}
    print(f"device={harness.describe(device)} n={args.n} {args.w}x{args.h}", flush=True)
    for name, d in digests.items():
        print(f"digest {name}: {d}", flush=True)
    return digests


if __name__ == "__main__":
    main()
