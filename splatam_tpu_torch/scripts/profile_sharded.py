"""What row bands cost: the pairs per band and one banded fwd+bwd's time.

Counterpart of scripts/profile_sharded.py, with its arguments. For each
band count in --shards (1 = the unbanded path) on one seeded map:
  1. the work split: the (Gaussian, tile) pairs of each band's structure,
     max / mean / sum against the unbanded count; sum / unbanded is the
     boundary duplication (a Gaussian across a band edge has pairs in both
     bands), max / mean the imbalance;
  2. wall (host clock, ending in a synchronize) and CUDA-event ms of the
     tracking structure build (world-8 rows), one tracking fwd+bwd on it
     (pose gradients, the fused kernels) and one mapping fwd+bwd (every
     parameter's gradient), median of --reps runs of --iters (tracking) or
     --map_iters (mapping) calls.
The bands go round-robin over --cards of the visible cards (default: all,
parallel.spatial.make_bands). With all bands on one card they run in turn,
so the time is the total work over the bands; the latency of n bands on n
cards needs n cards. On the CPU only wall times are taken (the plain
versions).

    python -m splatam_tpu_torch.scripts.profile_sharded [--shards 1 2 4 8] [--cards 1]
    python -m splatam_tpu_torch.scripts.profile_sharded --device cpu --n 2000 --h 48 --w 64

The TPU script's --pair_cap is gone: the port's pair buffers are exact.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.parallel import spatial
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.slam import steps

TRACK_CFG = steps.PhaseConfig(True, 0.5, True, True, 0.5, 1.0)
MAP_CFG = steps.PhaseConfig(False, 0.5, True, False, 0.5, 1.0)


def make_scene(n: int, w: int, h: int, device, seed: int = 0):
    """scripts/profile_sharded.py's map, camera and target frame."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(1.5, 5.0, n)], -1).astype(np.float32)
    fields = dict(
        means3d=means,
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
        logit_opacities=rng.normal(1.0, 0.5, (n,)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.005, 0.02, (n, 1))).astype(np.float32),
        active=np.ones(n, bool),
    )
    gm = GaussianMap(**{k: torch.tensor(v, device=device) for k, v in fields.items()})
    cam = Camera(height=h, width=w, fx=0.9 * w, fy=0.9 * w, cx=w / 2.0, cy=h / 2.0)
    color = torch.tensor(rng.uniform(0, 1, (3, h, w)).astype(np.float32), device=device)
    depth = torch.tensor(rng.uniform(1.0, 4.0, (h, w)).astype(np.float32), device=device)
    return gm, cam, color, depth


def _track(gm, q, t, color, depth, cam, ps, bands):
    def fn():
        q_, t_ = q.clone().requires_grad_(True), t.clone().requires_grad_(True)
        loss, _ = steps.get_loss(gm, q_, t_, color, depth, cam, TRACK_CFG, True, False, ps,
                                 bands=bands)
        return torch.autograd.grad(loss, (q_, t_))
    return fn


def _map(gm, q, t, color, depth, cam, ps, bands):
    keys = [k for k in steps.MAP_PARAMS if not (gm.isotropic and k == "unnorm_rotations")]

    def fn():
        params = {k: getattr(gm, k).detach().requires_grad_(True) for k in keys}
        loss, _ = steps.get_loss(gm._replace(**params), q, t, color, depth, cam, MAP_CFG,
                                 False, True, ps, bands=bands)
        return torch.autograd.grad(loss, tuple(params.values()))
    return fn


def band_pairs(gm, q, t, cam, bands) -> list:
    """The pairs of each band's structure (one entry with bands None)."""
    ps = steps.loss_pair_structure(gm, q, t, cam, bands=bands)
    return [p.n_pairs for p in ps] if bands is not None else [ps.n_pairs]


def run(gm, cam, color, depth, shard_counts, device, iters: int, map_iters: int,
        reps: int, cards: int | None = None) -> list:
    """One row per band count: pairs and timings (harness.Timing)."""
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    t = torch.zeros(3, device=device)
    base = band_pairs(gm, q, t, cam, None)[0]
    print(f"scene: {gm.means3d.shape[0]} Gaussians, {cam.width}x{cam.height}, {base} unbanded "
          f"pairs, device={harness.describe(device)}", flush=True)
    rows = []
    for n in shard_counts:
        bands = spatial.make_bands(n, device, cards) if n > 1 else None
        pairs = band_pairs(gm, q, t, cam, bands)

        def build(bands=bands):
            return steps.loss_pair_structure(gm, q, t, cam, with_world16=True, bands=bands)

        ps_t = build()
        ps_m = steps.loss_pair_structure(gm, q, t, cam, bands=bands)
        tm = {"structure build": harness.time_calls(build, device, iters, reps),
              "tracking fwd+bwd": harness.time_calls(
                  _track(gm, q, t, color, depth, cam, ps_t, bands), device, iters, reps),
              "mapping fwd+bwd": harness.time_calls(
                  _map(gm, q, t, color, depth, cam, ps_m, bands), device, map_iters, reps)}
        row = dict(shards=n, pairs=pairs, pairs_max=max(pairs), pairs_mean=float(np.mean(pairs)),
                   pairs_total=sum(pairs), dup=sum(pairs) / base, imbalance=max(pairs) /
                   float(np.mean(pairs)), devices=sorted({str(d) for d in (bands or [device])}),
                   times=tm)
        rows.append(row)
        print(f"shards={n}: pairs per band {pairs}: max {row['pairs_max']} "
              f"({row['pairs_max'] / base:.3f}x of unbanded), mean {row['pairs_mean']:.0f}, "
              f"sum {row['pairs_total']} (duplication {row['dup']:.4f}, imbalance "
              f"{row['imbalance']:.4f}); on {', '.join(row['devices'])}", flush=True)
        for name, tmg in tm.items():
            print(f"  {name:<18s} wall {tmg.wall:9.3f} ms  events {harness.fmt_ms(tmg.event)}",
                  flush=True)
    first = rows[0]["times"]
    print("summary: time over the unbanded path's, per band count", flush=True)
    for row in rows:
        ratios = ", ".join(
            f"{name} {row['times'][name].wall / first[name].wall:.2f}x wall"
            + ("" if row['times'][name].event is None
               else f" / {row['times'][name].event / first[name].event:.2f}x events")
            for name in first)
        one = len(row["devices"]) == 1 and row["shards"] > 1
        note = (" (all bands on one device, in turn: the total work; the latency on "
                f"{row['shards']} cards is not measured here)" if one else "")
        print(f"  shards={row['shards']}: {ratios}{note}", flush=True)
    return rows


def main(argv=None) -> list:
    ap = harness.parser(__doc__)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--h", type=int, default=240)
    ap.add_argument("--w", type=int, default=320)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--map_iters", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cards", type=int, default=None)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "profile_sharded")
    gm, cam, color, depth = make_scene(args.n, args.w, args.h, device)
    return run(gm, cam, color, depth, args.shards, device, args.iters, args.map_iters,
               args.reps, args.cards)


if __name__ == "__main__":
    main()
