"""The frozen work count: its contributing evaluations against a loop over
every pixel and pair, and its operations and bytes for a recorded launch."""
from __future__ import annotations

import torch

from slam_bench import roofline
from slam_bench.reference import render


def _scene(n=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    means = torch.rand((n, 3), generator=g) * torch.tensor([2.0, 2.0, 2.0]) + torch.tensor(
        [-1.0, -1.0, 1.5])
    s2 = (0.02 + 0.2 * torch.rand((n,), generator=g)) ** 2
    opacity = 0.05 + 0.9 * torch.rand((n,), generator=g)
    return means, s2, opacity


def _brute_force(screen, bins, k):
    """Count the (pixel, pair) evaluations that contribute, one pixel at a
    time, walking its tile's pairs front to back."""
    gx, _ = render.grid(k)
    count = 0
    xy, conic, op = screen.xy.tolist(), screen.conic.tolist(), screen.opacity.tolist()
    starts = bins.tile_start.tolist()
    pg = bins.pair_gauss.tolist()
    for tile in range(len(starts) - 1):
        for lane in range(render.PIX):
            px = (tile % gx) * render.TILE + lane % render.TILE
            py = (tile // gx) * render.TILE + lane // render.TILE
            t = 1.0
            for p in range(starts[tile], starts[tile + 1]):
                gi = pg[p]
                dx, dy = xy[gi][0] - px, xy[gi][1] - py
                a, b, c = conic[gi]
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                if power > 0.0:
                    continue
                alpha = min(render.ALPHA_MAX, op[gi] * torch.exp(torch.tensor(power)).item())
                if alpha < render.ALPHA_MIN:
                    continue
                if t * (1.0 - alpha) < render.T_EPS:
                    break
                t *= 1.0 - alpha
                count += 1
    return count


def test_contributing_evaluations_match_a_loop_over_pixels_and_pairs():
    k = render.Intrinsics(40, 24, 30.0, 30.0, 19.5, 11.5)
    means, s2, opacity = _scene()
    screen = render.project(means, s2, opacity, torch.eye(3), torch.zeros(3), k)
    bins = render.build_bins(screen, torch.ones(means.shape[0], dtype=torch.bool), k)
    assert int(bins.tile_start[-1]) > 20

    def rows(pidx):
        g = bins.pair_gauss[pidx]
        return screen.xy[g], screen.conic[g], screen.opacity[g], torch.zeros(*pidx.shape, 1)

    counted = render.contributing(bins, rows, k)
    assert counted > 0
    assert abs(counted - _brute_force(screen, bins, k)) <= 2  # float32 ties at the thresholds


def test_a_fused_launch_counts_its_evaluations_pairs_ops_and_bytes():
    k = render.Intrinsics(40, 24, 30.0, 30.0, 19.5, 11.5)
    means, s2, opacity = _scene(seed=3)
    screen = render.project(means, s2, opacity, torch.eye(3), torch.zeros(3), k)
    bins = render.build_bins(screen, torch.ones(means.shape[0], dtype=torch.bool), k)
    rows = torch.cat([means, s2[:, None], opacity[:, None], torch.rand((means.shape[0], 3))], 1)
    pose = torch.zeros(24)
    pose[0:9] = torch.eye(3).reshape(9)
    pose[12:16] = torch.tensor([k.fx, k.fy, k.cx, k.cy])
    launch = roofline.Launch("fused_backward", rows, pose, bins.tile_start.to(torch.int32),
                             bins.pair_gauss.to(torch.int32), k.width, k.height, 5)

    def plain_rows(pidx):
        g = bins.pair_gauss[pidx]
        return screen.xy[g], screen.conic[g], screen.opacity[g], torch.zeros(*pidx.shape, 1)

    n = roofline.evaluations(launch)
    assert n == render.contributing(bins, plain_rows, k)
    w = roofline.work(launch, n)
    pairs = int(bins.tile_start[-1])
    assert w.pairs == pairs and w.ops == n * 90 + pairs * 207
    rows_read = int(torch.unique(bins.pair_gauss).numel())
    assert w.bytes == (rows_read * 32 + (bins.tile_start.numel() + pairs + 24) * 4
                       + 13 * k.width * k.height * 4 + pairs * 32)
    assert w.bound_s == max(w.ops / 67e12, w.bytes / 3.35e12)
    assert launch.key() == launch._replace(kernel="fused_forward").key()
