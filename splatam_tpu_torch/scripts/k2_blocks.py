"""Time K2 (the composite backward) at every channel count under several
bounds of resident blocks per SM: the sweep that sets K2_MIN_BLOCKS in
csrc/composite_backward.cu.

For each bound B the kernels are built from a copy of csrc/ whose
K2_MIN_BLOCKS asks B blocks of every instance (a cap of 65536 / 256 / B
registers a thread), into a build directory of their own; then each
instance runs on the generic render's inputs of one map (the profile map
of scene.py at opacity logit 1.0, seeded channels and cotangents) and
prints its registers, spill bytes, resident blocks and time (CUDA events
over --iters launches, the smaller of two turns).

    python -m splatam_tpu_torch.scripts.k2_blocks [--blocks 2 3 4] [--n 950272]

Needs the card and nvcc: the kernels cannot be built or run elsewhere.
"""
from __future__ import annotations

import re
import shutil
import tempfile
from pathlib import Path

import torch

from splatam_tpu_torch.render import _cuda, api, binning, composite
from splatam_tpu_torch.scripts import harness, scene


def generic_inputs(gm, cam, ch: int, seed: int):
    """K2's inputs at ch channels: per-Gaussian attrs with seeded channels,
    the bins, K1's state and seeded cotangents."""
    proj, aux = api.project_gaussians(cam, gm.means3d, gm.unnorm_rotations, gm.logit_opacities,
                                      gm.log_scales, gm.active)
    b = binning.build_bins(proj, aux, cam.width, cam.height)
    gen = torch.Generator(gm.means3d.device).manual_seed(seed)
    chans = torch.rand((gm.means3d.shape[0], ch), device=gm.means3d.device, generator=gen)
    attrs = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], chans], 1).contiguous()
    state = composite.composite_forward(attrs, b.pair_gauss, b.tile_start, cam.width, cam.height)
    g = torch.randn((ch + 1, cam.height, cam.width), device=gm.means3d.device, generator=gen)
    return attrs, b, state, g


def use_sources(csrc: Path, build: Path) -> None:
    """Point the kernel library at the sources in csrc, built into build."""
    _cuda.CSRC, _cuda.BUILD_DIR = csrc, build
    _cuda.lib.cache_clear()


def with_blocks(blocks: int, work: Path) -> Path:
    """A copy of csrc/ whose K2 asks `blocks` resident blocks of every instance."""
    dst = work / f"csrc_b{blocks}"
    shutil.copytree(_cuda.CSRC, dst)
    src = dst / "composite_backward.cu"
    text, n = re.subn(r"(K2_MIN_BLOCKS\[MAX_CH \+ 1\] = \{0)[^}]*\}",
                      lambda m: m.group(1) + f", {blocks}" * composite.MAX_CH + "}",
                      src.read_text())
    if n != 1:
        raise RuntimeError("K2_MIN_BLOCKS not found in composite_backward.cu")
    src.write_text(text)
    return dst


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--blocks", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--n", type=int, default=950272)
    ap.add_argument("--h", type=int, default=680)
    ap.add_argument("--w", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "k2_blocks")
    if device.type != "cuda":
        raise SystemExit("k2_blocks: the sweep times kernels; it needs the card")
    gm, _, _, cam = scene.synthetic_scene(args.n, args.w, args.h, 1.0, device)
    csrc, build = _cuda.CSRC, _cuda.BUILD_DIR
    print(f"device={harness.describe(device)} n={args.n} {args.w}x{args.h}", flush=True)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for blocks in args.blocks:
                use_sources(with_blocks(blocks, Path(tmp)), Path(tmp) / f"build_b{blocks}")
                for ch in composite.CHANNELS:
                    attrs, b, state, g = generic_inputs(gm, cam, ch, seed=ch)

                    def k2(attrs=attrs, b=b, state=state, g=g):
                        return composite.composite_backward(attrs, b.pair_gauss, b.tile_start,
                                                            cam.width, cam.height, state, g)

                    ms = min(harness.time_calls(k2, device, args.iters, 1).event
                             for _ in range(2))
                    info = _cuda.kernel_info("composite_backward_info", ch)
                    results[blocks, ch] = (ms, info)
                    print(f"blocks {blocks} ch {ch}: {ms:.3f} ms, {info.registers} registers, "
                          f"{info.local_bytes} local bytes, {info.blocks_per_sm} blocks per SM "
                          f"({b.n_pairs} pairs)", flush=True)
        finally:
            use_sources(csrc, build)
    for ch in composite.CHANNELS:
        best = min(args.blocks, key=lambda bl: results[bl, ch][0])
        print(f"ch {ch}: fastest at {best} blocks", flush=True)
    return results


if __name__ == "__main__":
    main()
