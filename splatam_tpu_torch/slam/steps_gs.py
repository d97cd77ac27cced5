"""3DGS training pieces: the chunked trainer and clone/split densification.

Counterpart of splatam_tpu/slam/steps_gs.py (reference:
scripts/gaussian_splatting.py get_loss_gs :199-235; utils/slam_external.py
densify :191-243 and the means3D lr schedule :246-288). The reference
package runs a chunk of densify_every iterations as one jitted loop; here a
chunk is a Python loop of autograd steps through the generic render (K1
forward, K2 -> K3 backward, whatever the map), and densification runs
between chunks on the masked buffers: clones and splits go to the lowest
free slots with no shape change, so both packages place every Gaussian in
the same slot.

Where the reference package drops the clones and splits it finds no free
slot for (and grows afterwards), the port's densify_pass counts them first
(densify_counts) and grows the capacity before the pass (capacity_for,
pad_state), so a pass drops nothing.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap, grow_with_timestep
from splatam_tpu_torch.core.losses import calc_ssim
from splatam_tpu_torch.core.transforms import build_rotation, normalize
from splatam_tpu_torch.render import api
from splatam_tpu_torch.slam import optim
from splatam_tpu_torch.slam.steps import MAP_PARAMS, accumulate_stats, transform_to_frame


@dataclass(frozen=True)
class DensifyConfig:
    """densify_dict (configs/replica/splatam.py:113-123). reset_opacities
    and reset_opacities_every are read and, as in the reference package,
    applied by neither the chunk nor the densify pass (from_dict warns)."""

    enabled: bool = True
    start_after: int = 500
    remove_big_after: int = 3000
    stop_after: int = 5000
    densify_every: int = 100
    grad_thresh: float = 0.0002
    num_to_split_into: int = 2
    removal_opacity_threshold: float = 0.005
    final_removal_opacity_threshold: float = 0.005
    reset_opacities: bool = False
    reset_opacities_every: int = 3000

    @classmethod
    def from_dict(cls, d: dict, enabled: bool = True) -> "DensifyConfig":
        """The config's densify_dict; keys the dataclass lacks are ignored."""
        cfg = cls(enabled=enabled, **{k: v for k, v in d.items()
                                      if k in cls.__dataclass_fields__})
        if cfg.enabled and cfg.reset_opacities:
            warnings.warn("densify_dict.reset_opacities is set and not applied: the 3DGS "
                          "trainer resets no opacities (as in the reference package)",
                          stacklevel=2)
        return cfg

    def due(self, it: int) -> bool:
        """A densify pass follows the chunk that ends at iteration it."""
        return self.start_after <= it <= self.stop_after and it % self.densify_every == 0


class GSVariables(NamedTuple):
    """3DGS densification statistics, [CAP] each. max_2d_radius is
    accumulated and read by nothing, as in the reference package."""

    means2d_grad_accum: torch.Tensor
    denom: torch.Tensor
    max_2d_radius: torch.Tensor

    @staticmethod
    def zeros(capacity: int, device) -> "GSVariables":
        return GSVariables(*(torch.zeros((capacity,), dtype=torch.float32, device=device)
                             for _ in range(3)))


def expon_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1000000) -> float:
    """get_expon_lr_func (utils/slam_external.py:255-288) in float32 step by
    step, as the reference package evaluates it on the device: IEEE float32
    arithmetic, with log, exp and sin rounded from float64 (XLA's float32
    exp is not correctly rounded, so the two may differ by one ulp)."""
    f32 = np.float32

    def fn(op, x):
        return f32(op(float(x)))

    t = np.clip(f32(step) / f32(max_steps), f32(0.0), f32(1.0))
    log_lerp = fn(math.exp, fn(math.log, lr_init) * (f32(1.0) - t)
                  + fn(math.log, lr_final) * t)
    delay = f32(1.0)
    if lr_delay_steps > 0:
        ramp = np.clip(f32(step) / f32(lr_delay_steps), f32(0.0), f32(1.0))
        delay = f32(lr_delay_mult) + (f32(1.0) - f32(lr_delay_mult)) * fn(
            math.sin, f32(0.5 * np.pi) * ramp)
    return float(delay * log_lerp)


def gs_loss(gm: GaussianMap, q, t, color, depth_gt, cam: Camera, w_im: float, w_depth: float,
            means2d_dummy=None):
    """get_loss_gs: 0.8 L1 + 0.2 (1 - SSIM) on the image, the plain mean of
    |depth * valid - depth_gt| on depth. Returns (loss, RenderOutput)."""
    means_cam, rots_cam = transform_to_frame(gm, q, t, True, False)
    out = api.render_rgbd_sil(cam, means_cam, gm.rgb_colors, rots_cam, gm.logit_opacities,
                              gm.log_scales, gm.active, means2d_dummy=means2d_dummy)
    depth = out.depth * (depth_gt != 0.0)
    im_loss = 0.8 * torch.abs(out.im - color).mean() + 0.2 * (1.0 - calc_ssim(out.im, color))
    depth_loss = torch.abs(depth - depth_gt).mean()
    return w_im * im_loss + w_depth * depth_loss, out


def gs_mapping_chunk(gm: GaussianMap, gsvars: GSVariables, opt_state: optim.AdamState,
                     colors, depths, iter_slots, iter_qs, iter_ts, start_iter: int,
                     cam: Camera, num_iters: int, lrs: tuple, w_im: float, w_depth: float,
                     lr_sched: tuple | None, track_stats: bool):
    """One chunk of the offline trainer: num_iters Adam steps (eps 1e-15)
    over all five parameter groups (MAP_PARAMS order, lrs likewise).

    colors [S, H, W, 3] uint8 and depths [S, H, W] hold the chunk's distinct
    frames; iteration i renders frame iter_slots[i] (a host sequence) at
    pose (iter_qs[i], iter_ts[i]). lr_sched = (lr_init, lr_final,
    delay_mult, max_steps) gives means3D the exponential schedule at step
    start_iter + i + 1 (no delay steps, as the reference programs call it);
    None keeps lrs[0]. With track_stats every iteration adds to gsvars
    (steps.accumulate_stats). Returns (map, gsvars, opt_state, summed loss
    as a device scalar)."""
    params = tuple(getattr(gm, k).detach() for k in MAP_PARAMS)
    dev = gm.device
    loss_sum = torch.zeros((), device=dev)
    for i in range(num_iters):
        slot = int(iter_slots[i])
        color = colors[slot].to(torch.float32).permute(2, 0, 1) / 255.0
        p = tuple(x.requires_grad_(True) for x in params)
        dummy = (torch.zeros((gm.capacity, 2), device=dev, requires_grad=True)
                 if track_stats else None)
        loss, out = gs_loss(gm._replace(**dict(zip(MAP_PARAMS, p))), iter_qs[i], iter_ts[i],
                            color, depths[slot], cam, w_im, w_depth, means2d_dummy=dummy)
        grads = torch.autograd.grad(loss, p + ((dummy,) if track_stats else ()))
        if track_stats:
            grads, d_dummy = grads[:-1], grads[-1]
            gsvars = GSVariables(*accumulate_stats(gsvars, d_dummy, out.radii))
        lr_means = lrs[0]
        if lr_sched is not None:
            lr_init, lr_final, delay_mult, max_steps = lr_sched
            lr_means = expon_lr(start_iter + i + 1, lr_init, lr_final,
                                lr_delay_mult=delay_mult, max_steps=max_steps)
        params, opt_state = optim.adam_step(opt_state, tuple(x.detach() for x in p), grads,
                                            (lr_means,) + tuple(lrs[1:]), eps=1e-15)
        loss_sum = loss_sum + loss.detach()
    return gm._replace(**dict(zip(MAP_PARAMS, params))), gsvars, opt_state, loss_sum


def _alloc_slots(active, want_mask):
    """Destination slots for new rows: the lowest free slots, in rank order.
    Returns (dest [CAP], CAP where not writing; write mask): rows past the
    free slots are not written (densify_pass grows first, so none are)."""
    cap = active.shape[0]
    free = ~active
    free_slots = torch.nonzero(free)[:, 0]
    slot_of_rank = torch.zeros((cap,), dtype=torch.int64, device=active.device)
    slot_of_rank[: free_slots.shape[0]] = free_slots
    want_rank = torch.cumsum(want_mask.to(torch.int64), 0) - 1
    write = want_mask & (want_rank < free.sum())
    dest = torch.where(write, slot_of_rank[want_rank.clamp(0, cap - 1)], cap)
    return dest, write


def _scatter_rows(gm: GaussianMap, opt_state, write, dest, means=None, log_scales=None):
    """Copy the rows marked in write to their dest slots (means and
    log_scales from the overrides where given), mark those slots active,
    and zero their Adam moments."""
    slots = dest[write]

    def put(arr, values):
        arr = arr.clone()
        arr[slots] = values[write]
        return arr

    gm = GaussianMap(
        means3d=put(gm.means3d, gm.means3d if means is None else means),
        rgb_colors=put(gm.rgb_colors, gm.rgb_colors),
        unnorm_rotations=put(gm.unnorm_rotations, gm.unnorm_rotations),
        logit_opacities=put(gm.logit_opacities, gm.logit_opacities),
        log_scales=put(gm.log_scales, gm.log_scales if log_scales is None else log_scales),
        active=put(gm.active, write),
    )
    if opt_state is not None:
        written = torch.zeros_like(gm.active)
        written[slots] = True
        opt_state = optim.reset_slots(opt_state, written)
    return gm, opt_state


def _f32_product(a: float, b: float) -> float:
    """a * b rounded in float32, as the reference package forms its
    thresholds from a float32 scene radius."""
    return float(np.float32(a) * np.float32(b))


def densify_masks(gm: GaussianMap, gsvars: GSVariables, scene_radius: float,
                  cfg: DensifyConfig):
    """(to_clone, to_split): active Gaussians whose averaged screen gradient
    reaches grad_thresh, cloned where their largest scale is at most
    0.01 scene_radius and split where it is above."""
    grads = gsvars.means2d_grad_accum / torch.clamp(gsvars.denom, min=1e-20)
    grads = torch.where(torch.isnan(grads), 0.0, grads)
    grads = torch.where(gsvars.denom > 0, grads, 0.0)
    max_scale = torch.exp(gm.log_scales).max(dim=1).values
    high_grad = (grads >= cfg.grad_thresh) & gm.active
    small = _f32_product(0.01, scene_radius)
    return high_grad & (max_scale <= small), high_grad & (max_scale > small)


def densify_counts(gm: GaussianMap, gsvars: GSVariables, scene_radius: float,
                   cfg: DensifyConfig) -> tuple[int, int]:
    """How many Gaussians the next pass clones and splits (one host sync)."""
    to_clone, to_split = densify_masks(gm, gsvars, scene_radius, cfg)
    n_clone, n_split = torch.stack([to_clone.sum(), to_split.sum()]).tolist()
    return n_clone, n_split


def capacity_for(gm: GaussianMap, n_new: int) -> int:
    """The capacity, doubled as often as needed, with n_new free slots."""
    cap, n_active = gm.capacity, gm.num_active()
    while cap - n_active < n_new:
        cap *= 2
    return cap


def pad_state(gsvars: GSVariables, opt_state: optim.AdamState, capacity: int):
    """Statistics and Adam moments zero-padded to capacity slots."""

    def pad(x):
        return torch.cat([x, x.new_zeros((capacity - x.shape[0],) + tuple(x.shape[1:]))])

    return (GSVariables(*map(pad, gsvars)),
            optim.AdamState(m=tuple(map(pad, opt_state.m)), v=tuple(map(pad, opt_state.v)),
                            step=opt_state.step))


def split_noise(gen: torch.Generator, n: int, capacity: int) -> torch.Tensor:
    """The pass's split samples: [n, capacity, 3] standard normals from gen
    (on the map's device), one [capacity, 3] draw per child."""
    return torch.randn((n, capacity, 3), generator=gen, device=gen.device)


@torch.no_grad()
def densify_3dgs_step(gm: GaussianMap, gsvars: GSVariables, opt_state: optim.AdamState,
                      scene_radius: float, gen: torch.Generator, it: int, cfg: DensifyConfig,
                      final: bool):
    """One clone/split/prune pass over the masked buffers
    (utils/slam_external.py:191-243): clone small high-gradient Gaussians
    in place, split large ones into num_to_split_into samples drawn from
    the Gaussian itself (split_noise; scales divided by 0.8 n) and remove
    the original, then prune by opacity (final_removal_opacity_threshold
    when final) and, from remove_big_after on, by size. Both masks are
    decided before the clones are written. The written slots' Adam moments
    are zeroed, and the statistics come back as zeros. Rows that find no
    free slot are dropped; densify_pass grows the capacity first.

    Returns (map, statistics, opt_state)."""
    to_clone, to_split = densify_masks(gm, gsvars, scene_radius, cfg)
    dest, write = _alloc_slots(gm.active, to_clone)
    gm, opt_state = _scatter_rows(gm, opt_state, write, dest)

    n = cfg.num_to_split_into
    stds = torch.exp(gm.log_scales).expand(-1, 3)
    new_log_scales = torch.log(torch.exp(gm.log_scales) / (0.8 * n))
    rot = build_rotation(normalize(gm.unnorm_rotations))
    noise = split_noise(gen, n, gm.capacity)
    for rep in range(n):
        offset = (rot * (noise[rep] * stds)[:, None, :]).sum(-1)
        dest, write = _alloc_slots(gm.active, to_split)
        gm, opt_state = _scatter_rows(gm, opt_state, write, dest, means=gm.means3d + offset,
                                      log_scales=new_log_scales)
    active = gm.active & ~to_split

    thresh = cfg.final_removal_opacity_threshold if final else cfg.removal_opacity_threshold
    to_remove = torch.sigmoid(gm.logit_opacities) < thresh
    if it >= cfg.remove_big_after:
        big = torch.exp(gm.log_scales).max(dim=1).values > _f32_product(0.1, scene_radius)
        to_remove = to_remove | big
    gm = gm._replace(active=active & ~to_remove)
    return gm, GSVariables.zeros(gm.capacity, gm.device), opt_state


def densify_pass(gm: GaussianMap, timestep, gsvars: GSVariables, opt_state: optim.AdamState,
                 scene_radius: float, gen: torch.Generator, it: int, cfg: DensifyConfig,
                 final: bool):
    """A 3DGS pass that drops nothing: count its clones and splits, double
    the capacity as often as the free slots fall short of them (timestep,
    statistics and moments zero-padded), then densify_3dgs_step at full
    capacity. Returns (map, timestep, statistics, opt_state, cloned,
    split)."""
    n_clone, n_split = densify_counts(gm, gsvars, scene_radius, cfg)
    cap = capacity_for(gm, n_clone + cfg.num_to_split_into * n_split)
    if cap > gm.capacity:
        gm, timestep = grow_with_timestep(gm, timestep, cap)
        gsvars, opt_state = pad_state(gsvars, opt_state, cap)
    gm, gsvars, opt_state = densify_3dgs_step(gm, gsvars, opt_state, scene_radius, gen, it, cfg,
                                              final)
    return gm, timestep, gsvars, opt_state, n_clone, n_split
