"""The warp-granular cull of K1 and K2 (render/composite.py cull_rows_plain,
cull_warp_mask; the device functions pair_reach and reach_warp_mask in
csrc/common.cuh repeat them), on the CPU.

The cull may only skip what the walk skips anyway. Two properties, over
random and adversarial per-pair rows (numpy seeds), at both warp shapes
(16x2 and 8x4 pixels):
  - no pixel at which `_pair_alpha` gives power <= 0 and alpha >= 1/255 lies
    in a warp the cull excludes;
  - the plain forward and backward walks with the culled (pair, warp) steps
    masked out equal the unmasked ones exactly (torch.equal).
"""
import math

import numpy as np
import pytest
import torch

from splatam_tpu_torch.render import composite

W, H = 40, 28  # 3 x 2 tiles, ragged on the right and at the bottom
GX, GY = 3, 2
TILES = GX * GY
PER_TILE = 48


def _base(rng, n):
    """Benign rows: centres in and around the tile, round small conics."""
    rows = np.zeros((n, 11), np.float32)
    tile = np.repeat(np.arange(TILES), n // TILES)
    rows[:, 0] = (tile % GX) * 16 + rng.uniform(-4, 20, n)
    rows[:, 1] = (tile // GX) * 16 + rng.uniform(-4, 20, n)
    s = rng.uniform(0.05, 2.0, n)
    rows[:, 2], rows[:, 4] = s, s * rng.uniform(0.7, 1.4, n)
    rows[:, 3] = rng.uniform(-0.2, 0.2, n) * s
    rows[:, 5] = rng.uniform(0.02, 0.95, n)
    rows[:, 6:] = rng.uniform(0, 1, (n, 5))
    return rows


def _family(name, seed=0):
    rng = np.random.default_rng(seed)
    n = TILES * PER_TILE
    rows = _base(rng, n)
    k = np.arange(n)
    if name == "random":
        pass
    elif name == "opacity_edges":  # below 1/255, around it, at 0.99, above 1 before the clamp
        edge = np.float32(1.0 / 255.0)
        vals = [0.0, 1e-4, np.nextafter(edge, np.float32(0)), edge,
                np.nextafter(edge, np.float32(1)), 0.0040, 0.99, 0.9900001, 1.0, 1.7, 30.0, -0.5]
        rows[:, 5] = np.asarray(vals, np.float32)[k % len(vals)]
    elif name == "det_nonpositive":  # indefinite, degenerate and negative conics
        m = k % 4
        rows[m == 0, 3] = 3.0 * np.sqrt(rows[m == 0, 2] * rows[m == 0, 4])  # det < 0
        rows[m == 1, 3] = np.sqrt(rows[m == 1, 2] * rows[m == 1, 4])  # det ~ 0
        rows[m == 2, 2] *= -1.0  # a < 0
        rows[m == 3, 2:5] = 0.0  # a flat conic: power = 0 everywhere
    elif name == "anisotropic":  # b != 0, axis ratios up to 1e3 (condition up to 1e6)
        theta = rng.uniform(0, math.pi, n)
        l1 = rng.uniform(0.01, 0.5, n)
        l2 = l1 * 10.0 ** rng.uniform(0, 6, n)
        c_, s_ = np.cos(theta), np.sin(theta)
        rows[:, 2] = l1 * c_ * c_ + l2 * s_ * s_
        rows[:, 4] = l1 * s_ * s_ + l2 * c_ * c_
        rows[:, 3] = (l1 - l2) * c_ * s_
    elif name == "far_centres":  # outside the tile and far outside the image
        rows[:, 0] += rng.choice([-1e6, -300.0, -17.0, 0.0, 17.0, 300.0, 1e6], n)
        rows[:, 1] += rng.choice([-1e6, -300.0, -17.0, 0.0, 17.0, 300.0, 1e6], n)
        rows[:, 2:5] *= rng.choice([1.0, 1e-3, 1e-6, 1e-12], n)[:, None].astype(np.float32)
    elif name == "large_footprints":  # footprints larger than the tile
        rows[:, 2:5] *= np.float32(1e-3)
        rows[:, 5] = rng.uniform(0.5, 1.0, n)
    elif name == "grazing":  # the alpha = 1/255 ellipse passes within 1e-4 px of a row or column
        d = rng.integers(1, 9, n).astype(np.float64)  # pixels from the centre to the grazed line
        s = rng.uniform(0.1, 0.6, n)
        rows[:, 2], rows[:, 4], rows[:, 3] = s, s, 0.0
        op = np.exp(0.5 * s.astype(np.float32).astype(np.float64) * d * d) / 255.0
        ok = op < 0.98
        rows[:, 5] = np.where(ok, op * (1.0 + rng.uniform(-3e-7, 3e-7, n)), 0.5)
        tile = np.repeat(np.arange(TILES), PER_TILE)
        line = rng.integers(0, 16, n)  # the grazed row (or column) of the tile
        jitter = rng.uniform(-1e-4, 1e-4, n)
        side = rng.choice([-1.0, 1.0], n)
        along = rng.integers(0, 16, n)  # exactly on a pixel centre along the line
        vertical = k % 2 == 0
        cy = (tile // GX) * 16 + np.where(vertical, line + side * d + jitter, along)
        cx = (tile % GX) * 16 + np.where(vertical, along, line + side * d + jitter)
        rows[:, 0], rows[:, 1] = cx, cy
    elif name == "non_finite":
        col = k % 6
        bad = np.asarray([np.nan, np.inf, -np.inf], np.float32)[(k // 6) % 3]
        hit = k % 2 == 0
        rows[hit, col[hit]] = bad[hit]
    else:
        raise KeyError(name)
    tile_start = torch.arange(TILES + 1, dtype=torch.int32) * PER_TILE
    return torch.tensor(rows), tile_start


FAMILIES = ("random", "opacity_edges", "det_nonpositive", "anisotropic", "far_centres",
            "large_footprints", "grazing", "non_finite")
# Families whose rows the rule can bound: there the cull must also skip some steps.
BOUNDED = ("random", "opacity_edges", "grazing", "far_centres")


def _applies(rows, tile_start):
    """[P, 256] bool: the walk's own per-pixel test of each pair in its tile."""
    ox, oy, lx, ly = composite._tile_frame(tile_start, W)
    tile = torch.repeat_interleave(torch.arange(TILES), PER_TILE)
    idx = torch.arange(rows.shape[0])
    _, _, power, _, _, alpha, _ = composite._pair_alpha(
        rows[:, 0:2], rows[:, 2:5], rows[:, 5], idx, ox[tile], oy[tile], lx, ly)
    return (power <= 0.0) & (alpha >= composite.ALPHA_MIN)


@pytest.mark.parametrize("warp_w", [16, 8])
@pytest.mark.parametrize("family", FAMILIES)
def test_cull_never_excludes_a_pixel_the_walk_applies(family, warp_w):
    for seed in range(3):
        rows, tile_start = _family(family, seed)
        box = composite.cull_rows_plain(rows[:, 0:2], rows[:, 2:5], rows[:, 5], tile_start, W)
        visit = composite.cull_visit(box, warp_w)
        applies = _applies(rows, tile_start)
        missed = applies & ~visit
        assert not bool(missed.any()), (
            f"{family}: {int(missed.sum())} applied (pair, pixel) steps culled, first pair "
            f"{rows[int(missed.any(1).nonzero()[0])].tolist()}")
        if family in BOUNDED:
            assert int((~visit).sum()) > 0 and int(applies.sum()) > 0
        if family == "grazing":  # the margin is small: the cull still skips most far rows
            assert float(visit.float().mean()) < 0.9


def test_cull_marks_what_it_cannot_bound_as_everywhere():
    rows, tile_start = _family("random")
    rows[0, 3] = 10.0 * rows[0, 2]  # det < 0
    rows[1, 2] = float("nan")
    rows[2, 5] = float("nan")
    rows[3, 5] = 1e-4  # below 1/255: nowhere
    rows[4, 0] = float("inf")  # dx = inf: the walk's b * dx * dy is NaN where dy = 0
    box = composite.cull_rows_plain(rows[:, 0:2], rows[:, 2:5], rows[:, 5], tile_start, W)
    for w in (16, 8):
        mask = composite.cull_warp_mask(box, w)
        assert bool(mask[[0, 1, 2, 4]].all()) and not bool(mask[3].any())


@pytest.mark.parametrize("warp_w", [16, 8])
def test_warp_pixels_partition_the_tile(warp_w):
    pix = composite.warp_pixels(warp_w)
    assert pix.shape == (8, 32) and sorted(pix.reshape(-1).tolist()) == list(range(256))
    lx, ly = pix % 16, pix // 16
    assert bool(((lx.amax(1) - lx.amin(1)) == warp_w - 1).all())
    assert bool(((ly.amax(1) - ly.amin(1)) == 32 // warp_w - 1).all())


@pytest.mark.parametrize("family", FAMILIES)
def test_culled_walks_equal_the_unculled_ones(family):
    """Forward image (n_contrib included) and per-pair gradients, with the
    cull's (pair, warp) steps masked out of the plain walks: equal bit for
    bit to the unmasked walks, at both warp shapes and in both input modes."""
    rows, tile_start = _family(family, seed=5)
    finite = torch.nan_to_num(rows, nan=0.3, posinf=5.0, neginf=-5.0)
    rows = torch.where(torch.arange(11)[None] >= 6, finite, rows)  # channels stay finite
    gen = torch.Generator().manual_seed(1)
    g = torch.randn((6, H, W), generator=gen)
    ref = composite.composite_forward_plain(rows, None, tile_start, W, H)
    dref = composite.composite_backward_plain(rows, None, tile_start, W, H, ref, g)
    perm = torch.randperm(rows.shape[0], generator=gen).to(torch.int32)
    table = torch.empty_like(rows)
    table[perm.long()] = rows  # per-Gaussian rows, gathered back through pair_gauss
    for warp_w in (16, 8):
        got = composite.composite_forward_plain(rows, None, tile_start, W, H, cull=warp_w)
        assert torch.equal(got.nan_to_num(nan=-7.0), ref.nan_to_num(nan=-7.0)), (family, warp_w)
        dgot = composite.composite_backward_plain(rows, None, tile_start, W, H, ref, g,
                                                  cull=warp_w)
        assert torch.equal(dgot.nan_to_num(nan=-7.0), dref.nan_to_num(nan=-7.0)), (family, warp_w)
    got = composite.composite_forward_plain(table, perm, tile_start, W, H, cull=composite.WARP_W)
    assert torch.equal(got.nan_to_num(nan=-7.0), ref.nan_to_num(nan=-7.0))


def test_plain_backward_is_finite_on_indefinite_conics():
    """An indefinite conic gives power far above 0 at the pixels the walk
    skips, where exp(power) is inf: the skipped pixels must add 0, not
    0 * inf, to the pair's gradient."""
    rows, tile_start = _family("det_nonpositive", seed=11)
    ox, oy, lx, ly = composite._tile_frame(tile_start, W)
    tile = torch.repeat_interleave(torch.arange(TILES), PER_TILE)
    _, _, _, gval, _, _, skip = composite._pair_alpha(
        rows[:, 0:2], rows[:, 2:5], rows[:, 5], torch.arange(rows.shape[0]), ox[tile], oy[tile],
        lx, ly)
    assert bool((torch.isinf(gval) & skip).any())
    state = composite.composite_forward_plain(rows, None, tile_start, W, H)
    g = torch.randn((6, H, W), generator=torch.Generator().manual_seed(2))
    d = composite.composite_backward_plain(rows, None, tile_start, W, H, state, g)
    assert bool(torch.isfinite(d).all()) and float(d.abs().max()) > 0
