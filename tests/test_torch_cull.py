"""The warp-granular cull of K1, K2 and K4 (render/composite.py
cull_rows_plain, cull_warp_mask; the device functions pair_reach and
reach_warp_mask in csrc/common.cuh repeat them), on the CPU.

The cull may only skip what the walk skips anyway. Two properties, over
random and adversarial per-pair rows (numpy seeds), at both warp shapes
(16x2 and 8x4 pixels):
  - no pixel at which `_pair_alpha` gives power <= 0 and alpha >= 1/255 lies
    in a warp the cull excludes;
  - the plain forward and backward walks with the culled (pair, warp) steps
    masked out equal the unmasked ones exactly (torch.equal).
K4 culls the pairs it projects itself: the same two properties are held on
world rows whose projection takes every branch of project_pairs_plain
(behind the near plane, det == 0, clamped txtz / tytz, scales from 0 to
overflow, centres far off the screen).
"""
import math

import numpy as np
import pytest
import torch

from splatam_tpu_torch.render import composite, fused_iso

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


# ---------------------------------------------------------------------------
# K4: the cull on pairs projected inside the kernel
# ---------------------------------------------------------------------------

FX = 32.0  # fx = fy; the image centre is the principal point
WORLD_FAMILIES = ("random", "behind_near_plane", "det_zero", "clamped", "scales", "opacity_edges",
                  "far", "overflow")
# Families whose fused forward is finite everywhere (the card tests' choice).
WORLD_FINITE = tuple(f for f in WORLD_FAMILIES if f != "overflow")


def _world_family(name, seed=0):
    """(world8 [P, 8] per sorted pair, pose vector [24], tile_start) on the
    W x H image. Each pair's mean is placed in the camera frame so that it
    projects around its own tile, then moved to the world by the pose."""
    rng = np.random.default_rng(seed)
    n = TILES * PER_TILE
    k = np.arange(n)
    tile = np.repeat(np.arange(TILES), PER_TILE)
    u = (tile % GX) * 16 + rng.uniform(-4, 20, n)  # target pixel
    v = (tile // GX) * 16 + rng.uniform(-4, 20, n)
    z = rng.uniform(1.0, 4.0, n)
    s2 = rng.uniform(0.01, 0.15, n) ** 2
    op = rng.uniform(0.02, 0.95, n)
    identity = name == "det_zero"
    if name == "random":
        pass
    elif name == "behind_near_plane":  # tz <= 0.2 projects at safe_tz = 1 and composites there
        z = np.asarray([0.2, 0.19999, 0.0, -0.5, -3.0, 0.2001, 1.5], np.float32)[k % 7]
    elif name == "det_zero":  # c00 = c11 = 0 exactly: s2 j00^2 = -0.3 with j02 = j12 = 0
        hit = k % 3 == 0
        u, v = np.where(hit, W / 2 - 0.5, u), np.where(hit, H / 2 - 0.5, v)
        z = np.where(hit, 2.0, z)
        s2 = np.where(hit, np.float32(-0.3) / np.float32((FX / 2.0) ** 2),
                      np.where(k % 3 == 1, -s2, s2))  # and negative scales beside them
    elif name == "clamped":  # |x / z| and |y / z| past limx, limy: txtz, tytz clamp
        u = u + rng.choice([-400.0, -60.0, 60.0, 400.0], n)
        v = v + rng.choice([-300.0, -40.0, 0.0, 40.0, 300.0], n)
        s2 = s2 * rng.choice([1.0, 100.0], n)
    elif name == "scales":  # from a point to footprints far larger than the image
        s2 = np.asarray([0.0, 1e-12, 1e-2, 1.0, 1e4, 1e12], np.float32)[k % 6]
        op = rng.uniform(0.3, 1.0, n)
    elif name == "opacity_edges":
        edge = np.float32(1.0 / 255.0)
        vals = [0.0, 1e-4, np.nextafter(edge, np.float32(0)), edge,
                np.nextafter(edge, np.float32(1)), 0.0040, 0.99, 0.9900001, 1.0, 1.7, 30.0, -0.5]
        op = np.asarray(vals, np.float32)[k % len(vals)]
    elif name == "far":  # centres up to 1e8 pixels away, just in front of the near plane
        u = u * rng.choice([1.0, 1e3, -1e5, 1e8], n)
        z = np.where(k % 2 == 0, 0.2001, z)
    elif name == "overflow":  # s2 so large that det, the conic or power overflow
        s2 = np.asarray([1e20, 3e38, np.inf, np.nan, 1e30, 1.0], np.float32)[k % 6]
    else:
        raise KeyError(name)
    cam = np.stack([(u + 0.5 - W / 2) * z / FX, (v + 0.5 - H / 2) * z / FX, z], 1)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0] if identity else [0.99, 0.02, -0.03, 0.01])
    tr = torch.zeros(3) if identity else torch.tensor([0.02, -0.01, 0.03])
    rmat = fused_iso.build_rotation(fused_iso.normalize(q)[None])[0]
    world = (torch.tensor(cam, dtype=torch.float32) - tr) @ rmat  # R^T (p - t)
    w8 = torch.zeros((n, 8))
    w8[:, 0:3] = world
    w8[:, 3] = torch.tensor(np.asarray(s2, np.float32))
    w8[:, 4] = torch.tensor(np.asarray(op, np.float32))
    w8[:, 5:8] = torch.tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    limx, limy = 1.3 * W / (2 * FX), 1.3 * H / (2 * FX)
    pose = fused_iso.make_pose_vec(rmat, tr, W, H, FX, FX, W / 2.0, H / 2.0, limx, limy)
    return w8, pose, torch.arange(TILES + 1, dtype=torch.int32) * PER_TILE


def _projected_rows(w8, pose):
    xy, conic, op, chans = fused_iso.project_pairs_plain(w8, pose, W, H)
    return torch.cat([xy, conic, op[:, None], chans], 1)


def test_world_families_take_every_branch_of_the_projection():
    """The families mean what their names say: pairs at or behind the near
    plane, det == 0, clamped txtz / tytz, centres the rule calls not tame."""
    tz = lambda w8, pose: w8[:, 0:3] @ pose[6:9] + pose[11]  # noqa: E731
    w8, pose, _ = _world_family("behind_near_plane")
    assert bool((tz(w8, pose) <= 0.2).sum() > w8.shape[0] // 2)
    rows = _projected_rows(*_world_family("det_zero")[:2])
    flat = (rows[:, 2:5] == 0).all(1)  # inv_det = 1 and a zero covariance: power = 0 everywhere
    assert int(flat.sum()) == rows.shape[0] // 3
    assert bool((rows[~flat, 2] < 0).any())
    w8, pose, _ = _world_family("clamped")
    cam = w8[:, 0:3] @ pose[0:9].reshape(3, 3).T + pose[9:12]
    assert bool(((cam[:, 0] / cam[:, 2]).abs() > pose[16]).any())
    assert bool(((cam[:, 1] / cam[:, 2]).abs() > pose[17]).any())
    rows = _projected_rows(*_world_family("far")[:2])
    assert bool((rows[:, 0].abs() > composite.CULL_MAX_COORD).any())
    rows = _projected_rows(*_world_family("overflow")[:2])
    assert not bool(torch.isfinite(rows[:, 2:5]).all())


@pytest.mark.parametrize("family", WORLD_FAMILIES)
def test_cull_never_excludes_an_applied_pixel_of_a_projected_pair(family):
    for seed in range(3):
        w8, pose, tile_start = _world_family(family, seed)
        rows = _projected_rows(w8, pose)
        box = composite.cull_rows_plain(rows[:, 0:2], rows[:, 2:5], rows[:, 5], tile_start, W)
        applies = _applies(rows, tile_start)
        for warp_w in (16, 8):
            missed = applies & ~composite.cull_visit(box, warp_w)
            assert not bool(missed.any()), (family, warp_w, int(missed.sum()))
        if family in ("random", "behind_near_plane", "clamped", "opacity_edges"):
            assert int(applies.sum()) > 0
            assert int((~composite.cull_visit(box, composite.WARP_W)).sum()) > 0


@pytest.mark.parametrize("family", WORLD_FAMILIES)
def test_culled_fused_forward_equals_the_unculled_one(family):
    """K4's plain version with the cull's (pair, warp) steps masked out of
    its walk equals the unmasked walk bit for bit, n_contrib included, at
    both warp shapes and in both input modes."""
    w8, pose, tile_start = _world_family(family, seed=5)
    ref = fused_iso.fused_forward_plain(w8, pose, tile_start, W, H)
    for warp_w in (16, 8):
        got = fused_iso.fused_forward_plain(w8, pose, tile_start, W, H, cull=warp_w)
        assert torch.equal(got.nan_to_num(nan=-7.0), ref.nan_to_num(nan=-7.0)), (family, warp_w)
    perm = torch.randperm(w8.shape[0], generator=torch.Generator().manual_seed(1)).to(torch.int32)
    table = torch.empty_like(w8)
    table[perm.long()] = w8
    got = fused_iso.fused_forward_plain(table, pose, tile_start, W, H, perm, cull=composite.WARP_W)
    assert torch.equal(got.nan_to_num(nan=-7.0), ref.nan_to_num(nan=-7.0))
    if family in WORLD_FINITE:
        assert bool(torch.isfinite(ref).all()) and float(ref[5].max()) > 0
