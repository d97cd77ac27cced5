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

from splatam_tpu_torch import kernels
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.render import bounds, composite, fused_iso
from splatam_tpu_torch.scripts import harness, scene
from test_torch_cull import H as ROWS_H, W as ROWS_W, _projected_rows, _world_family

CSRC = Path(bounds.__file__).resolve().parents[1] / "csrc"
# (file, device function) -> sha256 prefix of the text the counts were made from
COUNTED = {
    ("common.cuh", "composite_pair"): "f5f431d8eb054e25",
    ("common.cuh", "walk_words"): "e723ffb24a4bd36d",
    ("common.cuh", "project_iso"): "6ceb4c90acf8407e",
    ("common.cuh", "ProjectedRows"): "d5c930dee7acb1ff",
    ("common.cuh", "stage_values"): "4528f9134b7d00ed",
    ("common.cuh", "stage_pair"): "7e13d6435c796ddd",
    ("composite_backward.cu", "composite_backward_kernel"): "bd33dcc8bf766e27",
    ("fused_backward.cu", "fused_backward_kernel"): "80fe3a0bf7d58e41",
    ("fused_backward.cu", "chain_to_world"): "6660f7970abd6bb6",
}
# The device code of K1's, K2's and K4's cull, whose plain version is written out
# again in render/composite.py (cull_rows_plain, cull_warp_mask, warp_pixels):
# the cull's kept-step counts and its CPU tests speak for the kernels only
# while the two say the same.
MIRRORED = {
    ("common.cuh", "pair_reach"): "136799131609be3f",
    ("common.cuh", "reach_warp_mask"): "8670aab1c2b9d4b9",
    ("common.cuh", "WarpShape"): "ee0a10f1f5ef17bf",
}
# constant in common.cuh -> its copy in render/composite.py
MIRRORED_CONSTANTS = ("WARP_W", "CULL_MAX_COND", "CULL_REL", "CULL_ABS", "CULL_MAX_COORD",
                      "CULL_MAX_TERM", "ALPHA_MIN", "ALPHA_MAX", "T_EPS", "TILE")


def _definition(file: str, name: str) -> str:
    """The text of `name`'s definition in csrc/`file` (a function or a struct),
    from its name to the closing brace."""
    text = (CSRC / file).read_text()
    for m in re.finditer(rf"\b{name}\s*[({{]", text):
        brace, semi = text.find("{", m.end() - 1), text.find(";", m.end() - 1)
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


@pytest.mark.parametrize("src", sorted(MIRRORED), ids=lambda s: s[1])
def test_mirrored_cull_function_is_unchanged(src):
    digest = hashlib.sha256(_definition(*src).encode()).hexdigest()[:16]
    assert digest == MIRRORED[src], (
        f"{src[1]} ({src[0]}) changed: make the same change to the cull's plain version in "
        f"render/composite.py, then set its digest here to {digest}")


@pytest.mark.parametrize("name", MIRRORED_CONSTANTS)
def test_cull_constant_is_the_same_in_both_languages(name):
    """One definition in common.cuh, and its value is the Python copy's to
    float32 (the kernels' cull and its plain version decide alike)."""
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    found = re.findall(rf"constexpr\s+(?:int|float)\s+{name}\s*=\s*([^;]+);", text)
    assert len(found) == 1, found
    value = eval(found[0].replace("f", ""), {"__builtins__": {}})  # e.g. "1.0f / 255.0f"
    assert np.float32(value) == np.float32(getattr(composite, name))


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


def _brute_force_steps(xy, conic, op, tile_start, cam, ncon, warp_w):
    """Loops over every (tile, warp, pair) of the forward and the backward
    walk: (forward steps with a hitting lane, forward steps the cull keeps,
    backward steps the cull keeps, forward and backward steps with no cull)."""
    box = composite.cull_rows_plain(xy, conic, op, tile_start, cam.width)
    keep = composite.cull_warp_mask(box, warp_w)
    nc_tiles = composite.to_tiles(ncon[None])[0]
    gx = -(-cam.width // 16)
    pix = composite.warp_pixels(warp_w)
    need = kept_f = kept_b = seen_f = seen_b = 0
    starts = tile_start.tolist()
    for t in range(len(starts) - 1):
        ox, oy = t % gx * 16, t // gx * 16
        for w in range(8):
            lx, ly = (pix[w] % 16).float(), (pix[w] // 16).float()
            inside = (ox + lx < cam.width) & (oy + ly < cam.height)
            trans, done = torch.ones(32), ~inside
            deepest = int(nc_tiles[t, pix[w]].max())
            for k in range(starts[t + 1] - starts[t]):
                i = starts[t] + k
                kept_b += bool(k < deepest and keep[i, w])
                seen_b += k < deepest
                if bool(done.all()):
                    continue
                seen_f += 1
                kept_f += bool(keep[i, w])
                dx, dy = (xy[i, 0] - ox) - lx, (xy[i, 1] - oy) - ly
                a, b, c = conic[i]
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = torch.clamp(op[i] * torch.exp(power), max=composite.ALPHA_MAX)
                hit = ~done & (power <= 0) & (alpha >= composite.ALPHA_MIN)
                need += bool(hit.any())
                test_t = trans * (1.0 - alpha)
                stop = hit & (test_t < composite.T_EPS)
                trans = torch.where(hit & ~stop, test_t, trans)
                done = done | stop
    return need, kept_f, kept_b, seen_f, seen_b


@pytest.mark.parametrize("warp_w", [16, 8])
def test_cull_step_counts_match_a_brute_force_count(warp_w):
    """fwd_warp_steps, fwd_kept_steps, bwd_kept_steps and the uncut step
    counts against a loop over every (tile, warp, pair), at both warp shapes;
    the cull keeps every necessary step and drops some."""
    xy, conic, op, tile_start, cam, ncon = _micro_inputs()
    wc = bounds.walk_counts(xy, conic, op, tile_start, cam.width, cam.height, warp_w=warp_w)
    need, kept_f, kept_b, seen_f, seen_b = _brute_force_steps(xy, conic, op, tile_start, cam,
                                                              ncon, warp_w)
    assert (wc.fwd_warp_steps, wc.fwd_kept_steps, wc.bwd_kept_steps) == (need, kept_f, kept_b)
    assert (wc.fwd_visited_steps, wc.bwd_visited_steps) == (seen_f, seen_b)
    assert 0 < wc.fwd_warp_steps <= wc.fwd_kept_steps < wc.fwd_visited_steps
    assert 0 < wc.bwd_warp_steps <= wc.bwd_kept_steps < wc.bwd_visited_steps


@pytest.mark.parametrize("family", ["random", "behind_near_plane", "det_zero", "clamped"])
def test_cull_step_counts_on_pairs_projected_from_world_rows(family):
    """K4's needed, kept and uncut (pair, warp) steps (what chip_smoke.py
    reports from walk_counts) against the loop over every (tile, warp, pair),
    on pairs projected from world rows that take the projection's other
    branches: behind the near plane, det == 0, clamped txtz / tytz."""
    w8, pose, tile_start = _world_family(family, seed=2)
    rows = _projected_rows(w8, pose)
    xy, conic, op = rows[:, 0:2], rows[:, 2:5], rows[:, 5]
    cam = SimpleNamespace(width=ROWS_W, height=ROWS_H)
    ncon = fused_iso.fused_forward_plain(w8, pose, tile_start, ROWS_W, ROWS_H)[-1]
    wc = bounds.walk_counts(xy, conic, op, tile_start, ROWS_W, ROWS_H, warp_w=composite.WARP_W)
    need, kept_f, kept_b, seen_f, seen_b = _brute_force_steps(xy, conic, op, tile_start, cam,
                                                              ncon, composite.WARP_W)
    assert (wc.fwd_warp_steps, wc.fwd_kept_steps, wc.bwd_kept_steps) == (need, kept_f, kept_b)
    assert (wc.fwd_visited_steps, wc.bwd_visited_steps) == (seen_f, seen_b)
    assert 0 < wc.fwd_warp_steps <= wc.fwd_kept_steps < wc.fwd_visited_steps


def test_kernel_symbols_are_the_global_functions_of_csrc():
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    found = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text)
    assert sorted(found) == sorted(kernels.SYMBOLS)


def test_port_launches_seen_counts_only_the_port_kernels():
    events = [SimpleNamespace(key="void splatam::segment_reduce_kernel<8>(float const*)", count=3),
              SimpleNamespace(key="splatam::fused_forward_kernel(float const*)", count=2),
              SimpleNamespace(key="splatam::fused_forward2_kernel(float const*)", count=1),
              SimpleNamespace(key="void at::native::vectorized_elementwise_kernel<4>()", count=50),
              SimpleNamespace(key="my_fused_forward_kernel_copy()", count=7)]
    assert harness.port_launches_seen(events) == 6
    assert harness.port_launches_seen([]) == 0
