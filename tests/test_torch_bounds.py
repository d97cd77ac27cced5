"""The bounds' operation counts (render/bounds.py) and the profiler check of
the measurement harness (scripts/harness.py), on the CPU.

Each per-evaluation or per-pair operation count in bounds.py was counted by
hand from a device function in csrc/. The test pins the text of each such
function: an edit to one fails here until its counts are checked again and
the digest below is updated with them.
"""
import hashlib
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.render import bounds, composite, fused_iso
from splatam_tpu_torch.scripts import harness, scene

CSRC = Path(bounds.__file__).resolve().parents[1] / "csrc"
# (file, device function) -> sha256 prefix of the text the counts were made from
COUNTED = {
    ("common.cuh", "composite_tile"): "4be9b73dca984eac",
    ("common.cuh", "project_iso"): "6ceb4c90acf8407e",
    ("composite_backward.cu", "composite_backward_kernel"): "598b5195a123f6b0",
    ("fused_backward.cu", "fused_backward_kernel"): "7bba1d755741fe64",
    ("fused_backward.cu", "chain_to_world"): "6660f7970abd6bb6",
}


def _definition(file: str, name: str) -> str:
    """The text of `name`'s definition in csrc/`file`, signature to closing brace."""
    text = (CSRC / file).read_text()
    for m in re.finditer(rf"\b{name}\s*\(", text):
        brace, semi = text.find("{", m.end()), text.find(";", m.end())
        if brace != -1 and (semi == -1 or brace < semi):
            depth = 0
            for i in range(brace, len(text)):
                depth += {"{": 1, "}": -1}.get(text[i], 0)
                if depth == 0:
                    return text[m.start():i + 1]
    raise LookupError(f"no definition of {name} in {file}")


def test_every_count_names_a_pinned_function():
    named = {src for srcs in bounds.OP_SOURCES.values() for src in srcs}
    assert named == set(COUNTED)
    counts = {k for k in vars(bounds) if k.endswith("_OPS")}
    assert counts == set(bounds.OP_SOURCES)


@pytest.mark.parametrize("src", sorted(COUNTED), ids=lambda s: s[1])
def test_counted_function_is_unchanged(src):
    digest = hashlib.sha256(_definition(*src).encode()).hexdigest()[:16]
    counts = [k for k, srcs in bounds.OP_SOURCES.items() if src in srcs]
    assert digest == COUNTED[src], (
        f"{src[1]} ({src[0]}) changed: count {', '.join(counts)} again in bounds.py, then "
        f"set its digest here to {digest}")


def _micro_inputs(n=300, seed=0):
    """A 48x32 isotropic scene (six tiles of ~70 pairs; a few pixels stop at
    T < 1e-4, a few alphas clamp at 0.99): per-pair xy, conic, opacity,
    tile_start, the camera and the forward's n_contrib image."""
    rng = np.random.default_rng(seed)
    f = dict(means3d=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                               rng.uniform(1.0, 4.0, n)], -1).astype(np.float32),
             rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
             unnorm_rotations=np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
             logit_opacities=rng.normal(4.0, 2.0, n).astype(np.float32),
             log_scales=np.log(rng.uniform(0.02, 0.1, (n, 1))).astype(np.float32),
             active=np.ones(n, bool))
    gm = GaussianMap(**{k: torch.tensor(v) for k, v in f.items()})
    cam = Camera(height=32, width=48, fx=40.0, fy=40.0, cx=24.0, cy=16.0)
    ps, pose = scene.fused_inputs(gm, torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), cam)
    xy, conic, op, _ = fused_iso.project_pairs_plain(ps.world8, pose, cam.width, cam.height)
    img = fused_iso.fused_forward_plain(ps.world8, pose, ps.tile_start, cam.width, cam.height)
    return xy, conic, op, ps.tile_start, cam, img[-1]


def test_bwd_warp_steps_match_a_brute_force_count():
    """bwd_warp_steps against a loop over every (tile, warp, pair): a step
    counts when some lane (pixel) of the warp has the pair below its
    n_contrib with power <= 0 and alpha >= 1/255, as K5's walk decides."""
    xy, conic, op, tile_start, cam, ncon = _micro_inputs()
    wc = bounds.walk_counts(xy, conic, op, tile_start, cam.width, cam.height)
    nc_tiles = composite.to_tiles(ncon[None])[0]  # [T, 256]; padding pixels 0
    gx = -(-cam.width // 16)
    lanes = torch.arange(32, dtype=torch.float32)
    steps, starts = 0, tile_start.tolist()
    for t in range(len(starts) - 1):
        ox, oy = float(t % gx * 16), float(t // gx * 16)
        for w in range(8):
            lx, ly = lanes % 16, (2 * w + lanes // 16).floor()
            nc = nc_tiles[t, 32 * w:32 * w + 32]
            for k in range(starts[t + 1] - starts[t]):
                i = starts[t] + k
                dx, dy = (xy[i, 0] - ox) - lx, (xy[i, 1] - oy) - ly
                a, b, c = conic[i]
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = torch.clamp(op[i] * torch.exp(power), max=composite.ALPHA_MAX)
                steps += bool(((k < nc) & (power <= 0) & (alpha >= composite.ALPHA_MIN)).any())
    assert wc.bwd_warp_steps == steps
    n_pairs = int(tile_start[-1])
    assert 0 < steps < 8 * n_pairs and wc.hits > wc.applied > wc.unclamped  # stops, clamps


def test_kernel_symbols_are_the_global_functions_of_csrc():
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    found = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text)
    assert sorted(found) == sorted(harness.KERNEL_SYMBOLS)


def test_port_launches_seen_counts_only_the_port_kernels():
    events = [SimpleNamespace(key="void splatam::segment_reduce_kernel<8>(float const*)", count=3),
              SimpleNamespace(key="splatam::fused_forward_kernel(float const*)", count=2),
              SimpleNamespace(key="splatam::fused_forward2_kernel(float const*)", count=1),
              SimpleNamespace(key="void at::native::vectorized_elementwise_kernel<4>()", count=50),
              SimpleNamespace(key="my_fused_forward_kernel_copy()", count=7)]
    assert harness.port_launches_seen(events) == 6
    assert harness.port_launches_seen([]) == 0
