"""The banded SLAM phases end to end: a 2-frame track -> densify -> map loop.

Counterpart of __graft_entry__.py dryrun_multichip (:50-223): the real
phase functions (slam/steps.py) over n row bands (parallel/spatial.py) on
tiny shapes, 16 rows a band by 64 columns, on a 384-Gaussian map with 512
slots. Frame 0 bins anew every iteration; frame 1 reuses structures
(tracking rebin_every=2, mapping one structure for its keyframe). Between
the frames the map doubles its capacity through the port's own growth
(core/gaussians.py grow_with_timestep), as the JAX script crosses a rung
of its bucket ladder. Densification is densify_growing, which grows the
capacity until every candidate has a slot (the JAX densify_step drops
what does not fit). Checks: finite losses, Gaussians added, parameters
moved, capacity doubled; then prints `dryrun_multichip ok: ...`.

    python -m splatam_tpu_torch.scripts.dryrun_multichip [--bands 4]
    python -m splatam_tpu_torch.scripts.dryrun_multichip --device cpu --bands 2

The JAX script runs in a subprocess on a virtual CPU mesh; here the bands
run in one process, on the card by default (one after another on one
card, round-robin over several), or on the CPU with --device cpu.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap, grow_with_timestep
from splatam_tpu_torch.parallel import spatial
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.slam import steps

N_GAUSS, N_CAP, N_ITERS = 384, 512, 3


def make_scene(n: int, seed: int = 0) -> dict:
    """__graft_entry__.py _make_scene's map as numpy arrays (GaussianMap's
    field names)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(1.5, 5.0, n)], axis=-1).astype(np.float32)
    return dict(
        means3d=means,
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
        logit_opacities=rng.normal(1.0, 0.5, (n,)).astype(np.float32),
        log_scales=np.log(rng.uniform(0.01, 0.05, (n, 1))).astype(np.float32),
        active=np.ones(n, bool),
    )


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_bands: int, device) -> dict:
    """Run the loop over n_bands bands on `device`; returns its numbers
    (raises RuntimeError when a check fails)."""
    device = torch.device(device)
    bands = spatial.make_bands(n_bands, device)
    h, w = 16 * n_bands, 64
    cam = Camera(height=h, width=w, fx=60.0, fy=60.0, cx=32.0, cy=h / 2.0)
    scene = make_scene(N_GAUSS)
    pad = N_CAP - N_GAUSS
    fill = dict(unnorm_rotations=np.tile(np.asarray([[1.0, 0, 0, 0]], np.float32), (pad, 1)))
    gm = GaussianMap(**{
        k: torch.tensor(np.concatenate([v, fill.get(k, np.zeros((pad,) + v.shape[1:], v.dtype))]),
                        device=device)
        for k, v in scene.items()})
    rng = np.random.default_rng(1)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    t = torch.zeros(3, device=device)
    timestep = torch.zeros((N_CAP,), device=device)
    # sil_thres 0.5: at 0.99 the random scene's silhouette mask is empty
    # and the tracked loss is 0
    pcfg_t = steps.PhaseConfig(True, 0.5, True, True, 0.5, 1.0)
    pcfg_m = steps.PhaseConfig(False, 0.5, True, False, 0.5, 1.0)
    gm0_means = gm.means3d.clone()
    total_added, capacities = 0, []
    for frame in range(2):
        color = torch.tensor(rng.uniform(0, 1, (3, h, w)).astype(np.float32), device=device)
        depth = torch.tensor(rng.uniform(1.0, 4.0, (h, w)).astype(np.float32), device=device)
        reuse = frame == 1
        best_q, best_t, iters, loss_t, _ = steps.tracking_phase(
            gm, q, t, color, depth, cam, N_ITERS, False, 1e5, 2e-3, 1e-3, pcfg_t,
            rebin_every=2 if reuse else 1, bands=bands)
        _check(bool(torch.isfinite(loss_t)), "banded tracking: non-finite loss")
        n_before = gm.num_active()
        gm, timestep = steps.densify_growing(gm, timestep, color, depth, best_q, best_t,
                                             frame, cam, 0.5, bands)
        total_added += gm.num_active() - n_before
        kf_colors = (color.permute(1, 2, 0) * 255).to(torch.uint8)[None]
        gm, _, _, hist = steps.mapping_phase(
            gm, kf_colors, depth[None], [0] * N_ITERS, best_q[None].expand(N_ITERS, 4),
            best_t[None].expand(N_ITERS, 3), 2.0, cam, N_ITERS, pcfg_m,
            steps.PruneConfig(enabled=False), (1e-4, 2.5e-3, 1e-3, 5e-2, 1e-3),
            struct_qs=best_q[None] if reuse else None, struct_ts=best_t[None] if reuse else None,
            iter_struct_idx=[0] * N_ITERS if reuse else None, record_hist=True,
            track_stats=True, bands=bands)
        loss_m = float(hist[:, 0].sum())
        _check(np.isfinite(loss_m), "banded mapping: non-finite loss")
        q, t = best_q, best_t
        if frame == 0:
            capacities.append(gm.capacity)
            gm, timestep = grow_with_timestep(gm, timestep, 2 * gm.capacity)
            capacities.append(gm.capacity)
    _check(total_added > 0, "densify_step never added Gaussians")
    _check(capacities[1] == 2 * capacities[0], f"capacity {capacities} did not double")
    delta = float((gm.means3d[:N_GAUSS] - gm0_means[:N_GAUSS]).abs().max())
    _check(delta > 0.0, "mapping did not update the parameters")
    print(f"dryrun_multichip ok: {n_bands} bands on {', '.join(map(str, bands))}, 2-frame "
          f"track+densify+map loop, tracking loss {float(loss_t):.4f} ({iters} iters), "
          f"mapping loss {loss_m:.4f}, densified +{total_added}, max param delta={delta:.2e}",
          flush=True)
    return dict(tracking_loss=float(loss_t), mapping_loss=loss_m, added=total_added,
                delta=delta, capacities=capacities)


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("--bands", type=int, default=4)
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "dryrun_multichip")
    print(f"device={harness.describe(device)}", flush=True)
    return dryrun_multichip(args.bands, device)


if __name__ == "__main__":
    main()
