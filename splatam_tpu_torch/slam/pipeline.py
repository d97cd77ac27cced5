"""Online RGB-D SLAM pipeline: per-frame track -> densify -> map.

Counterpart of splatam_tpu/slam/pipeline.py (reference:
scripts/splatam.py:455-990): `rgbd_slam` is the full online entry point
(progress reports, checkpoints and resume, the final evaluation and
params.npz), `run_frame` the frame as bench.py drives it. Tracking and
densification may run at sizes of their own (data.tracking_image_* and
data.densification_image_*, each read from a dataset at that size), and
tracking may start coarse (tracking.coarse_to_fine). Host state
(trajectory, keyframe list) is numpy; the map and the keyframe store live
on `device`, the card unless the caller asks for the CPU. Keyframe draws
use np.random exactly as the reference package does, so both packages draw
the same schedule from the same seed.

Not carried over, because they exist only because XLA compiles one program
per shape: the background precompile threads, the capacity bucket ladder
and the compile cache. Pair buffers are sized exactly, so the pair budget
and its overflow retries have no counterpart either; phases run on the
active span of the map.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from splatam_tpu_torch.core import gaussians as G
from splatam_tpu_torch.core.camera import Camera, setup_camera
from splatam_tpu_torch.core.transforms import matrix_to_quaternion
from splatam_tpu_torch.data import frame_to_tensors, make_datasets
from splatam_tpu_torch.eval.evaluate import eval_sequence, render_at_pose, report_progress
from splatam_tpu_torch.io.params_io import save_params, save_params_ckpt
from splatam_tpu_torch.parallel import spatial
from splatam_tpu_torch.render.binning import BinOptions
from splatam_tpu_torch.slam import optim, steps, steps_gs
from splatam_tpu_torch.slam.config import backfill_defaults
from splatam_tpu_torch.slam.keyframes import keyframe_selection_overlap
from splatam_tpu_torch.utils import spans
from splatam_tpu_torch.utils.device import require_device
from splatam_tpu_torch.viz.panels import PanelFigure


def _phase_cfg(section: dict) -> steps.PhaseConfig:
    return steps.PhaseConfig(
        use_sil_for_loss=section["use_sil_for_loss"],
        sil_thres=section["sil_thres"],
        use_l1=section["use_l1"],
        ignore_outlier_depth_loss=section["ignore_outlier_depth_loss"],
        w_im=section["loss_weights"]["im"],
        w_depth=section["loss_weights"]["depth"],
        depth_unc_thres=float(section.get("depth_uncertainty_thres", 0.0)),
        outlier_floor=float(section.get("outlier_floor_m", 0.0)),
    )


def _prune_cfg(mapping: dict) -> steps.PruneConfig:
    if not mapping.get("prune_gaussians", False):
        return steps.PruneConfig(enabled=False)
    d = mapping["pruning_dict"]
    return steps.PruneConfig(enabled=True, **{
        k: d[k] for k in (
            "start_after", "remove_big_after", "stop_after", "prune_every",
            "removal_opacity_threshold", "final_removal_opacity_threshold",
            "reset_opacities", "reset_opacities_every")
    })


def _mapping_budget(cfg_m: dict, time_idx: int) -> int:
    """Per-frame mapping iterations, with the front-loaded bootstrap budget
    for the first bootstrap_frames frames."""
    num_iters = int(cfg_m["num_iters"])
    if time_idx < int(cfg_m.get("bootstrap_frames", 0)):
        num_iters = int(cfg_m.get("bootstrap_num_iters", num_iters))
    return num_iters


def _downscale_camera(cam: Camera, factor: int, pool: bool = False) -> Camera:
    """Camera for the factor-`factor` downsample of the image (coarse-to-fine
    tracking), through the renderer's half-pixel convention (u = fx X/Z +
    cx - 0.5); splatam_tpu/slam/pipeline.py:105-140.

    pool=False (stride): coarse pixel (i, j) is full pixel (i*f, j*f), so
    cx_c = (cx - 0.5)/f + 0.5 and the size rounds up.
    pool=True (_pool_target): coarse pixel (i, j) is the mean of the f x f
    block starting at (i*f, j*f), centred at full pixel i*f + (f-1)/2, so
    cx_c = (cx - 0.5 - (f-1)/2)/f + 0.5 and the size rounds down."""
    if pool:
        half = (factor - 1) / 2.0
        return cam._replace(height=cam.height // factor, width=cam.width // factor,
                            fx=cam.fx / factor, fy=cam.fy / factor,
                            cx=(cam.cx - 0.5 - half) / factor + 0.5,
                            cy=(cam.cy - 0.5 - half) / factor + 0.5)
    return cam._replace(height=-(-cam.height // factor), width=-(-cam.width // factor),
                        fx=cam.fx / factor, fy=cam.fy / factor,
                        cx=(cam.cx - 0.5) / factor + 0.5, cy=(cam.cy - 0.5) / factor + 0.5)


def _pool_target(color: torch.Tensor, depth: torch.Tensor, factor: int):
    """Mask-aware factor x factor average pooling of a tracking target
    (splatam_tpu/slam/pipeline.py:143-159): colour is the block mean; depth
    the mean over the block's valid (> 0) pixels, 0 where it has none (a
    hole stays masked out of the loss instead of becoming phantom
    geometry). The image is cropped to the largest multiple of factor."""
    h, w = depth.shape
    hc, wc = h // factor, w // factor
    c = color[:, : hc * factor, : wc * factor]
    c = c.reshape(3, hc, factor, wc, factor).mean(dim=(2, 4))
    d = depth[: hc * factor, : wc * factor].reshape(hc, factor, wc, factor)
    valid = (d > 0).to(d.dtype)
    cnt = valid.sum(dim=(1, 3))
    dsum = (d * valid).sum(dim=(1, 3))
    d = torch.where(cnt > 0, dsum / cnt.clamp_min(1.0), torch.zeros_like(dsum))
    return c, d


def _w2c_from_qt(q: np.ndarray, t: np.ndarray) -> np.ndarray:
    w2c = np.eye(4, dtype=np.float32)
    w, x, y, z = (q / np.linalg.norm(q)).astype(np.float64)
    w2c[:3, :3] = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )
    w2c[:3, 3] = t
    return w2c


def _upload(a, device, site: str) -> torch.Tensor:
    """torch.as_tensor(a, device=device): onto the card, a blocking copy
    from pageable host memory, which waits for the card's queue first."""
    with spans.waited(site):
        return torch.as_tensor(a, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SLAMRuntime:
    """Mutable state of one SLAM run, on one device: the card unless the
    caller asks for the CPU (`device="cpu"` runs the kernels' plain
    versions). Asking for the card where there is none raises; nothing
    falls back to the CPU. With tpu.spatial_shards = n > 1 (0 or 1: one
    image) tracking, densification and mapping render in n bands of rows
    (parallel/spatial.py), placed round-robin over the visible cards from
    `device`'s.

    `datasets` = (dataset, densify_dataset, tracking_dataset) takes the
    place of the config's (make_datasets); the live path passes its
    in-memory frame list, with no densification or tracking dataset. The
    map starts from frame 0 of the densification dataset (else the main
    one), which must exist when the runtime is built.

    tpu.tile_cull and tpu.direct_j (bin_opts) reach tracking's, mapping's
    and densification's structure builds and renders, and rgbd_slam's
    final evaluation, as the JAX runtime's phase render config does
    (splatam_tpu/slam/pipeline.py:569-654); direct_j is 0 with bands."""

    def __init__(self, config: dict, device="cuda", datasets=None):
        self.config = config = backfill_defaults(config)
        self.device = device = require_device(device, "SLAMRuntime")
        self.output_dir = os.path.join(config["workdir"], config["run_name"])
        self.eval_dir = os.path.join(self.output_dir, "eval")
        os.makedirs(self.eval_dir, exist_ok=True)
        self.dataset, self.densify_dataset, self.tracking_dataset = (
            make_datasets(config) if datasets is None else datasets)
        num_frames = config["data"].get("num_frames", -1)
        self.num_frames = len(self.dataset) if num_frames == -1 else num_frames
        self.rebin_every = int(config["tpu"]["rebin_every"])
        self.isotropic = config["gaussian_distribution"] == "isotropic"
        self.pcfg_track = _phase_cfg(config["tracking"])
        self.pcfg_map = _phase_cfg(config["mapping"])
        self.prune_cfg = _prune_cfg(config["mapping"])
        # Per-iteration (loss, w_depth, w_im) rows, kept only for the two
        # consumers of them: wandb's per-iteration stream and
        # report_iter_progress. Off, the phases add no launch or host sync.
        self.record_hist = bool(config["use_wandb"] or config["report_iter_progress"])

        color_np, depth_np, intrinsics_np, pose_np = self.dataset[0]
        self.intrinsics = intrinsics_np[:3, :3]
        self.first_frame_w2c = np.linalg.inv(pose_np)
        h, w = color_np.shape[0], color_np.shape[1]
        self.cam = setup_camera(w, h, self.intrinsics, None)
        shards = int(config["tpu"]["spatial_shards"])
        self.bands = spatial.make_bands(shards, device) if shards > 1 else None
        self.bin_opts = BinOptions.from_config(config["tpu"], banded=self.bands is not None)
        if self.bands is not None:
            print(f"[splatam-torch] rendering in {shards} row bands of "
                  f"{spatial.band_rows(h, shards)} rows on "
                  f"{', '.join(map(str, self.bands))}")
        # Densification and tracking cameras (splatam_tpu/slam/pipeline.py:
        # 367-392); the map starts from the densification frame.
        init_color, init_depth = color_np, depth_np
        self.densify_cam = self.tracking_cam = self.cam
        if self.densify_dataset is not None:
            init_color, init_depth, d_intr, _ = self.densify_dataset[0]
            self.densify_cam = setup_camera(init_color.shape[1], init_color.shape[0],
                                            d_intr[:3, :3], None)
        if self.tracking_dataset is not None:
            t_color, _, t_intr, _ = self.tracking_dataset[0]
            self.tracking_cam = setup_camera(t_color.shape[1], t_color.shape[0],
                                             t_intr[:3, :3], None)

        capacity = int(config["tpu"]["capacity"])
        color, depth = frame_to_tensors(init_color, init_depth, device)
        pts, cols, mean_sq, valid = steps.first_frame_pointcloud(color, depth, self.densify_cam)
        while capacity < pts.shape[0]:
            capacity *= 2
        self.gm = G.from_pointcloud(pts, cols, mean_sq, valid, capacity, self.isotropic)
        self.timestep = torch.zeros((capacity,), dtype=torch.float32, device=device)
        self.scene_radius = float(init_depth.max()) / config["scene_radius_depth_ratio"]

        self.cam_rots = np.tile(np.array([1, 0, 0, 0], np.float32), (self.num_frames, 1))
        self.cam_trans = np.zeros((self.num_frames, 3), np.float32)

        kf_cap = self.num_frames // max(config["keyframe_every"], 1) + 3
        self.kf_colors = torch.zeros((kf_cap, h, w, 3), dtype=torch.uint8, device=device)
        self.kf_depths = torch.zeros((kf_cap, h, w), dtype=torch.float32, device=device)
        self.kf_scratch_slot = kf_cap - 1
        self.keyframe_list = []  # dicts: id, slot, q, t
        self.keyframe_time_indices = []
        self.gt_w2c_all = []
        self.iters_run = 0  # the last tracking phase's iterations
        self.tracking_hist = self.mapping_hist = None  # numpy [iters, 3] when recorded
        # One record per in-loop 3DGS pass (mapping.use_gaussian_splatting_
        # densification): frame, iteration, cloned, split, active after it.
        self.gs_passes = []

    def compact(self) -> None:
        """Re-pack active Gaussians into a dense prefix, unless the holes
        are few (the reference package's threshold)."""
        n = self.gm.num_active()
        holes = self.gm.span() - n
        if holes <= max(4096, n >> 6):
            return
        self.gm, self.timestep = G.compact(self.gm, self.timestep)

    def _report_growth(self, old_capacity: int) -> None:
        if self.gm.capacity > old_capacity:
            print(f"[splatam-torch] grew gaussian capacity to {self.gm.capacity}")

    def _grow_kf_store(self, extra: int = 8) -> None:
        """Grow the device keyframe store. The initial capacity
        (num_frames // keyframe_every + 3) is an estimate that the extra
        keyframe at num_frames - 2 or a resume's replay can run past;
        growing keeps every keyframe. The scratch (current-frame) slot
        stays the last one, with its contents."""
        old_cap = self.kf_colors.shape[0]
        new_cap = old_cap + extra
        kc = self.kf_colors.new_zeros((new_cap,) + tuple(self.kf_colors.shape[1:]))
        kd = self.kf_depths.new_zeros((new_cap,) + tuple(self.kf_depths.shape[1:]))
        kc[: old_cap - 1] = self.kf_colors[: old_cap - 1]
        kd[: old_cap - 1] = self.kf_depths[: old_cap - 1]
        kc[new_cap - 1] = self.kf_colors[self.kf_scratch_slot]
        kd[new_cap - 1] = self.kf_depths[self.kf_scratch_slot]
        self.kf_colors, self.kf_depths = kc, kd
        self.kf_scratch_slot = new_cap - 1
        print(f"[splatam-torch] grew keyframe store to {new_cap} slots")

    def _stage_keyframe(self, slot: int, color_np: np.ndarray, depth_np: np.ndarray) -> None:
        with spans.waited("kf.upload"):
            self.kf_colors[slot] = torch.as_tensor(np.clip(color_np, 0, 255).astype(np.uint8))
        with spans.waited("kf.upload"):
            self.kf_depths[slot] = torch.as_tensor(depth_np[..., 0], dtype=torch.float32)

    def add_keyframe(self, time_idx: int, color_np: np.ndarray, depth_np: np.ndarray) -> None:
        """Stage the frame into the next store slot (growing the store when
        it reaches the scratch slot) and append it to the keyframe list."""
        slot = len(self.keyframe_list)
        while slot >= self.kf_scratch_slot:
            self._grow_kf_store()
        self._stage_keyframe(slot, color_np, depth_np)
        self.keyframe_list.append({"id": time_idx, "slot": slot,
                                   "q": self.cam_rots[time_idx].copy(),
                                   "t": self.cam_trans[time_idx].copy()})
        self.keyframe_time_indices.append(time_idx)

    def init_pose(self, time_idx: int) -> None:
        """The frame's starting pose (scripts/splatam.py:423-442): constant
        velocity with tracking.forward_prop, else the previous pose."""
        if time_idx > 1 and self.config["tracking"]["forward_prop"]:
            p1 = self.cam_rots[time_idx - 1] / np.linalg.norm(self.cam_rots[time_idx - 1])
            p2 = self.cam_rots[time_idx - 2] / np.linalg.norm(self.cam_rots[time_idx - 2])
            nr = p1 + (p1 - p2)
            self.cam_rots[time_idx] = nr / np.linalg.norm(nr)
            self.cam_trans[time_idx] = self.cam_trans[time_idx - 1] + (
                self.cam_trans[time_idx - 1] - self.cam_trans[time_idx - 2])
        elif time_idx > 0:
            self.cam_rots[time_idx] = self.cam_rots[time_idx - 1]
            self.cam_trans[time_idx] = self.cam_trans[time_idx - 1]

    def set_gt_pose(self, time_idx: int, gt_w2c: np.ndarray) -> None:
        """tracking.use_gt_poses: the frame's pose is the ground truth's."""
        rot = torch.as_tensor(gt_w2c[:3, :3], dtype=torch.float32)
        self.cam_rots[time_idx] = matrix_to_quaternion(rot).numpy()
        self.cam_trans[time_idx] = gt_w2c[:3, 3]

    def load_checkpoint(self, checkpoint_time_idx: int) -> None:
        """Resume from params{t}.npz (parity: scripts/splatam.py:604-638):
        reload the map and trajectory, take per-Gaussian auxiliaries
        (timestep) as zeros, replay the ground-truth poses, and rebuild
        the keyframe list and store from the saved keyframe indices by
        re-reading those frames."""
        print(f"Loading Checkpoint for Frame {checkpoint_time_idx}")
        ckpt = dict(np.load(os.path.join(self.output_dir, f"params{checkpoint_time_idx}.npz"),
                            allow_pickle=True))
        self.gm = G.from_params_dict(ckpt, self.device, capacity=self.gm.capacity)
        self.timestep = torch.zeros((self.gm.capacity,), dtype=torch.float32,
                                    device=self.device)
        cam_rots = np.asarray(ckpt["cam_unnorm_rots"])[0].T.astype(np.float32)
        cam_trans = np.asarray(ckpt["cam_trans"])[0].T.astype(np.float32)
        n = min(len(cam_rots), len(self.cam_rots))
        self.cam_rots[:n] = cam_rots[:n]
        self.cam_trans[:n] = cam_trans[:n]
        kf_indices = np.load(os.path.join(
            self.output_dir, f"keyframe_time_indices{checkpoint_time_idx}.npy")).tolist()
        for time_idx in range(checkpoint_time_idx):
            color_np, depth_np, _, gt_pose = self.dataset[time_idx]
            self.gt_w2c_all.append(np.linalg.inv(gt_pose))
            if time_idx in kf_indices:
                self.add_keyframe(time_idx, color_np, depth_np)

    def _c2f_levels(self) -> list:
        """The coarse-to-fine schedule, [(downscale factor, iterations),
        ...], run before the full-resolution phase; empty unless
        tracking.coarse_to_fine is enabled (the JAX package's extension,
        splatam_tpu/slam/pipeline.py:1096-1112)."""
        c2f = self.config["tracking"].get("coarse_to_fine") or {}
        if not c2f.get("enabled", False):
            return []
        return [(int(f), int(n)) for f, n in c2f.get("levels", []) if int(n) > 0]

    def _c2f_pool(self) -> bool:
        c2f = self.config["tracking"].get("coarse_to_fine") or {}
        return c2f.get("downsample", "pool") != "stride"

    def track_frame(self, time_idx: int, tr_color, tr_depth) -> None:
        """Tracking at tracking_cam on the tracking frame: the coarse levels
        first, each from the pose the previous one reached, then the
        full-resolution phase (splatam_tpu/slam/pipeline.py:1114-1210).
        Coarse iterations come out of num_iters (at least 1 full-resolution
        iteration stays) unless tracking.c2f_extra_iters; the depth-loss
        threshold applies at full resolution only."""
        cfg_t = self.config["tracking"]
        view = G.slice_prefix(self.gm, self.gm.span())
        q = _upload(self.cam_rots[time_idx], self.device, "track.pose_upload")
        t = _upload(self.cam_trans[time_idx], self.device, "track.pose_upload")
        lr_q, lr_t = float(cfg_t["lrs"]["cam_unnorm_rots"]), float(cfg_t["lrs"]["cam_trans"])
        levels = self._c2f_levels()
        full_iters = int(cfg_t["num_iters"])
        if levels and not cfg_t.get("c2f_extra_iters", False):
            full_iters = max(full_iters - sum(n for _, n in levels), 1)
        iters, hists = 0, []
        pool = self._c2f_pool()
        for factor, n_it in levels:
            cam_c = _downscale_camera(self.tracking_cam, factor, pool=pool)
            if pool:
                col_c, dep_c = _pool_target(tr_color, tr_depth, factor)
            else:
                col_c, dep_c = tr_color[:, ::factor, ::factor], tr_depth[::factor, ::factor]
            q, t, it_c, _, hist = steps.tracking_phase(
                view, q, t, col_c, dep_c, cam_c, n_it, False, 0.0, lr_q, lr_t,
                self.pcfg_track, self.rebin_every, record_hist=self.record_hist,
                bands=self.bands, bin_opts=self.bin_opts)
            iters += it_c
            hists.append(hist)
        best_q, best_t, it_f, _, hist = steps.tracking_phase(
            view, q, t, tr_color, tr_depth, self.tracking_cam, full_iters,
            bool(cfg_t["use_depth_loss_thres"]), float(cfg_t["depth_loss_thres"]),
            lr_q, lr_t, self.pcfg_track, self.rebin_every,
            lr_decay_frac=float(cfg_t.get("lr_decay_frac", 1.0)),
            record_hist=self.record_hist, bands=self.bands, bin_opts=self.bin_opts,
        )
        self.iters_run = iters + it_f
        self.tracking_hist = None
        with spans.span("readback"):
            with spans.waited("track.readback"):
                self.cam_rots[time_idx] = best_q.cpu().numpy()
            with spans.waited("track.readback"):
                self.cam_trans[time_idx] = best_t.cpu().numpy()
            if hist is not None:
                with spans.waited("track.hist_readback"):
                    self.tracking_hist = torch.cat(hists + [hist]).cpu().numpy()

    def frame_at(self, dataset, time_idx: int, color, depth):
        """Frame time_idx of the tracking or densification dataset on the
        device; (color, depth), the main frame, where that dataset is None
        (its size is the main one's)."""
        if dataset is None:
            return color, depth
        c, d, _, _ = dataset[time_idx]
        return frame_to_tensors(c, d, self.device)

    def densify_frame(self, time_idx: int, d_color, d_depth) -> None:
        q = _upload(self.cam_rots[time_idx], self.device, "densify.pose_upload")
        t = _upload(self.cam_trans[time_idx], self.device, "densify.pose_upload")
        cap = self.gm.capacity
        self.gm, self.timestep = steps.densify_growing(
            self.gm, self.timestep, d_color, d_depth, q, t, time_idx, self.densify_cam,
            float(self.config["mapping"]["sil_thres"]), self.bands, self.bin_opts)
        self._report_growth(cap)

    def select_keyframes(self, time_idx: int, depth_np: np.ndarray) -> list:
        """The reference's selected_keyframes list (keyframe indices, -1 =
        the current frame); scripts/splatam.py:800-819."""
        curr_w2c = _w2c_from_qt(self.cam_rots[time_idx], self.cam_trans[time_idx])
        num_keyframes = self.config["mapping_window_size"] - 2
        kf_w2cs = [_w2c_from_qt(kf["q"], kf["t"]) for kf in self.keyframe_list[:-1]]
        selected = keyframe_selection_overlap(
            depth_np[..., 0], curr_w2c, self.intrinsics, kf_w2cs, num_keyframes,
            rng=np.random,
        )
        if len(self.keyframe_list) > 0:
            selected.append(len(self.keyframe_list) - 1)
        selected.append(-1)
        return selected

    def _mapping_inputs(self, time_idx: int, selected: list, num_iters: int):
        """Per-iteration keyframe draws (uniform, or the current frame with
        probability mapping.current_frame_prob) and the distinct-keyframe
        pose table the mapping structures are built for."""
        cur_prob = float(self.config["mapping"].get("current_frame_prob", 0.0))
        slots, frame_ids = [], []
        for _ in range(num_iters):
            if cur_prob > 0.0 and np.random.random() < cur_prob:
                sel = -1
            else:
                sel = selected[np.random.randint(0, len(selected))]
            if sel == -1:
                frame_ids.append(time_idx)
                slots.append(self.kf_scratch_slot)
            else:
                frame_ids.append(self.keyframe_list[sel]["id"])
                slots.append(self.keyframe_list[sel]["slot"])
        uniq: dict = {}
        iter_idx = [uniq.setdefault(f, len(uniq)) for f in frame_ids]
        dev, site = self.device, "map.pose_upload"
        qs = _upload(np.stack([self.cam_rots[f] for f in frame_ids]), dev, site)
        ts = _upload(np.stack([self.cam_trans[f] for f in frame_ids]), dev, site)
        struct_qs = _upload(np.stack([self.cam_rots[f] for f in uniq]), dev, site)
        struct_ts = _upload(np.stack([self.cam_trans[f] for f in uniq]), dev, site)
        return slots, qs, ts, struct_qs, struct_ts, iter_idx

    def map_frame(self, time_idx: int, selected: list) -> None:
        cfg_m = self.config["mapping"]
        num_iters = _mapping_budget(cfg_m, time_idx)
        self.mapping_hist = None
        if num_iters == 0:
            return
        lrs_d = cfg_m["lrs"]
        lrs = tuple(float(lrs_d[k]) for k in (
            "means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales"))
        if cfg_m.get("use_gaussian_splatting_densification", False):
            self._map_frame_3dgs(time_idx, selected, num_iters, lrs)
            return
        _, _, _, hist = self._mapping_chunk(time_idx, selected, num_iters, lrs,
                                            G.slice_prefix(self.gm, self.gm.span()))
        if hist is not None:
            with spans.waited("map.hist_readback"):
                self.mapping_hist = hist.cpu().numpy()

    def _mapping_chunk(self, time_idx: int, selected: list, num_iters: int, lrs: tuple, view,
                       opt_state=None, gsvars=None, start_iter: int = 0,
                       track_stats: bool = False):
        """mapping_phase on the view for num_iters iterations, with this
        chunk's keyframe draws (and, at rebin_every > 1, its structures).
        The view is a prefix of self.gm's storage, handed over: the phase
        writes every step into it (in_place), so self.gm holds the result
        with no copy."""
        with spans.span("draw"):
            slots, qs, ts, struct_qs, struct_ts, iter_idx = self._mapping_inputs(
                time_idx, selected, num_iters)
        if self.rebin_every <= 1:  # every iteration bins anew
            struct_qs = struct_ts = iter_idx = None
        return steps.mapping_phase(
            view, self.kf_colors, self.kf_depths, slots, qs, ts, self.scene_radius,
            self.cam, num_iters, self.pcfg_map, self.prune_cfg, lrs, struct_qs, struct_ts,
            iter_idx, record_hist=self.record_hist, opt_state=opt_state, gsvars=gsvars,
            start_iter=start_iter, track_stats=track_stats, bands=self.bands,
            bin_opts=self.bin_opts, in_place=True)

    def _map_frame_3dgs(self, time_idx: int, selected: list, num_iters: int, lrs: tuple):
        """Mapping with 3DGS clone/split between chunks (splatam_tpu/slam/
        pipeline.py:1405-1498; reference scripts/splatam.py:862-867): chunks
        of densify_every iterations on the active span, each with its own
        keyframe draws, carrying the Adam state and the statistics; after a
        chunk that ends on the densify schedule, a pass at full capacity
        (grown first if the clones and splits would not all find a free
        slot: steps_gs.densify_pass), then compact_with, and the next chunk
        runs on the new span. Split noise comes from a generator seeded
        seed * 9973 + time_idx."""
        dcfg = steps_gs.DensifyConfig.from_dict(self.config["mapping"]["densify_dict"])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.config["seed"]) * 9973 + time_idx)
        view = G.slice_prefix(self.gm, self.gm.span())
        opt_state = gsvars = None
        it, hists = 0, []
        while it < num_iters:
            n = min(dcfg.densify_every, num_iters - it)
            view, opt_state, gsvars, hist = self._mapping_chunk(
                time_idx, selected, n, lrs, view, opt_state, gsvars, it, track_stats=True)
            hists.append(hist)
            it += n
            if not dcfg.due(it):
                continue
            full_gsv, full_opt = steps_gs.pad_state(steps_gs.GSVariables(*gsvars), opt_state,
                                                    self.gm.capacity)
            cap = self.gm.capacity
            self.gm, self.timestep, full_gsv, full_opt, n_clone, n_split = (
                steps_gs.densify_pass(self.gm, self.timestep, full_gsv, full_opt,
                                      self.scene_radius, gen, it, dcfg,
                                      final=it == dcfg.stop_after))
            self._report_growth(cap)
            # Re-prefix (pruning can punch holes that splits only partly
            # refill), the moments and statistics through the same order.
            self.gm, self.timestep, (m, v, gsv) = G.compact_with(
                self.gm, self.timestep, (full_opt.m, full_opt.v, tuple(full_gsv)))
            span = self.gm.span()
            view = G.slice_prefix(self.gm, span)
            opt_state = optim.AdamState(m=tuple(x[:span] for x in m),
                                        v=tuple(x[:span] for x in v), step=full_opt.step)
            gsvars = tuple(x[:span] for x in gsv)
            self.gs_passes.append(dict(frame=time_idx, iteration=it, cloned=n_clone,
                                       split=n_split, active=span))
            print(f"[splatam-torch] frame {time_idx} 3DGS densify at iteration {it}: cloned "
                  f"{n_clone}, split {n_split}, {span} Gaussians active", flush=True)
        if hists[0] is not None:
            self.mapping_hist = torch.cat(hists).cpu().numpy()

    def export_params(self) -> dict:
        """The reference-schema params dict for saving and eval
        (tests/test_slam_pipeline.py:58-64 lists its keys)."""
        params = G.compact_to_numpy(self.gm)
        active = self.gm.active.cpu().numpy()
        params["timestep"] = self.timestep.cpu().numpy()[active]
        params["cam_unnorm_rots"] = self.cam_rots.T[None].copy()  # [1,4,F]
        params["cam_trans"] = self.cam_trans.T[None].copy()  # [1,3,F]
        params["intrinsics"] = np.asarray(self.intrinsics)
        params["w2c"] = np.asarray(self.first_frame_w2c)
        params["org_width"] = self.config["data"]["desired_image_width"]
        params["org_height"] = self.config["data"]["desired_image_height"]
        if self.gt_w2c_all:
            params["gt_w2c_all_frames"] = np.stack(self.gt_w2c_all)
        params["keyframe_time_indices"] = np.array(self.keyframe_time_indices)
        return params


class FrameInput(NamedTuple):
    """A frame as prepare_frame reads it."""

    color_np: np.ndarray  # [H, W, 3] as the dataset gives it
    depth_np: np.ndarray  # [H, W, 1]
    gt_w2c: np.ndarray  # [4, 4] ground-truth world-to-camera
    color: torch.Tensor  # [3, H, W] on the runtime's device
    depth: torch.Tensor  # [H, W]


def prepare_frame(rt: SLAMRuntime, time_idx: int) -> FrameInput:
    """The part of a frame that bench.py leaves out of its timed window
    (bench.py:92-111): the dataset read (the synthetic sequence's host ray
    cast), the ground-truth pose appended to rt.gt_w2c_all, the upload to
    the device, and the pose init (rt.init_pose): the span `prepare`."""
    with spans.span("prepare", time_idx):
        color_np, depth_np, _, gt_pose = rt.dataset[time_idx]
        gt_w2c = np.linalg.inv(gt_pose)
        rt.gt_w2c_all.append(gt_w2c)
        color, depth = frame_to_tensors(color_np, depth_np, rt.device)
        rt.init_pose(time_idx)
    return FrameInput(color_np, depth_np, gt_w2c, color, depth)


def run_frame(rt: SLAMRuntime, time_idx: int, frame: FrameInput | None = None,
              mark=None) -> None:
    """One frame of the online loop as bench.py drives it (bench.py:92-148):
    prepare_frame (unless the caller passes its `frame`), compact, track
    (or, with tracking.use_gt_poses, take the ground-truth pose), densify
    (unless mapping.add_new_gaussians is off), keyframe selection, stage the
    current frame, map, and append a keyframe every keyframe_every frames.
    Tracking and densification read their frames from their own datasets
    where their sizes differ.

    mark(stage), when given, is called as each stage ends: "compact",
    "track" and "densify" (frames after the first), "select_kf",
    "stage_kf" and "map" (bench.py's BENCH_STAGES split; the keyframe
    append comes after "map"). Each stage is a span of its name
    (utils/spans.py), the keyframe append the span "append_kf"; mark is
    called as the stage's span closes.

    rgbd_slam's frame differs in three places: it adds a keyframe at
    num_frames - 2, adds keyframes only for a finite ground-truth pose, and
    densifies and maps only every map_every frames."""
    if frame is None:
        frame = prepare_frame(rt, time_idx)
    mark = mark or (lambda stage: None)
    color_np, depth_np, color, depth = frame.color_np, frame.depth_np, frame.color, frame.depth
    with spans.span("compact", time_idx):
        rt.compact()
    mark("compact")
    if time_idx > 0:
        with spans.span("track", time_idx):
            if rt.config["tracking"].get("use_gt_poses", False):
                rt.set_gt_pose(time_idx, frame.gt_w2c)
            else:
                rt.track_frame(time_idx,
                               *rt.frame_at(rt.tracking_dataset, time_idx, color, depth))
        mark("track")
        with spans.span("densify", time_idx):
            if rt.config["mapping"]["add_new_gaussians"]:
                rt.densify_frame(time_idx,
                                 *rt.frame_at(rt.densify_dataset, time_idx, color, depth))
        mark("densify")
    with spans.span("select_kf", time_idx):
        selected = rt.select_keyframes(time_idx, depth_np)
    mark("select_kf")
    with spans.span("stage_kf", time_idx):
        rt._stage_keyframe(rt.kf_scratch_slot, color_np, depth_np)
    mark("stage_kf")
    with spans.span("map", time_idx):
        rt.map_frame(time_idx, selected)
    mark("map")
    if time_idx == 0 or (time_idx + 1) % rt.config["keyframe_every"] == 0:
        with spans.span("append_kf", time_idx):
            rt.add_keyframe(time_idx, color_np, depth_np)


def _replay_iter_progress(hist, phase: str, frame: int) -> None:
    """report_iter_progress (utils/eval_helpers.py:246-254): the phase's
    recorded per-iteration losses, replayed into a tqdm bar where tqdm
    imports, else summed up in one line."""
    if hist is None or len(hist) == 0:
        return
    try:
        from tqdm import tqdm
    except ImportError:
        print(f"{phase} Time Step: {frame}: {len(hist)} iterations, loss {hist[0, 0]:.6f} -> "
              f"{hist[-1, 0]:.6f} (depth {hist[-1, 1]:.4f}, im {hist[-1, 2]:.4f})")
        return
    bar = tqdm(hist, desc=f"{phase} Time Step: {frame}", leave=False, total=len(hist))
    for row in bar:
        bar.set_postfix({"Loss": f"{float(row[0]):.6f}", "Depth": f"{float(row[1]):.4f}",
                         "Im": f"{float(row[2]):.4f}"})
    bar.close()


def tracking_loss_panels(gm, q, t, cam: Camera, color, depth, sil_thres: float) -> list:
    """The tracking-loss figure's eight panels at pose (q, t), as (numpy
    image, title, colour map) (splatam_tpu/slam/pipeline.py:1518-1591):
    GT RGB, GT depth, the render's RGB and depth (K1 through render_at_pose),
    the RGB L1 inside the silhouette mask, the depth L1 inside the mask
    where the depth is valid, the mask (silhouette > sil_thres) and the
    valid-depth mask."""
    out = render_at_pose(gm, q, t, cam)
    mask = (out.silhouette > sil_thres).cpu().numpy()
    im = np.clip(out.im.cpu().numpy().transpose(1, 2, 0), 0, 1)
    gt_im = color.cpu().numpy().transpose(1, 2, 0)
    rd, gd = out.depth.cpu().numpy(), depth.cpu().numpy()
    return [
        (gt_im, "GT RGB", None),
        (gd, "GT Depth", "jet"),
        (im, "Rastered RGB", None),
        (rd, "Rastered Depth", "jet"),
        (np.abs(gt_im - im).mean(-1) * mask, "Diff RGB L1 (masked)", "jet"),
        (np.abs(gd - rd) * mask * (gd > 0), "Diff Depth L1 (masked)", "jet"),
        (mask.astype(np.float32), f"Silhouette > {sil_thres}", "gray"),
        ((gd > 0).astype(np.float32), "Valid Depth", "gray"),
    ]


def _save_tracking_loss_viz(rt: SLAMRuntime, figure: PanelFigure, time_idx: int, tr_color,
                            tr_depth) -> None:
    """tracking.visualize_tracking_loss (scripts/splatam.py:292-337): after
    the frame's tracking, the panels at the tracked pose on the tracking
    frame and camera, saved to <output_dir>/tracking_loss_viz/{t:04d}.png.
    The reference redraws its window every tracking iteration; here, as in
    the JAX package, once per frame."""
    panels = tracking_loss_panels(
        G.slice_prefix(rt.gm, rt.gm.span()), rt.cam_rots[time_idx], rt.cam_trans[time_idx],
        rt.tracking_cam, tr_color, tr_depth, rt.config["tracking"]["sil_thres"])
    figure.save(panels, os.path.join(rt.output_dir, "tracking_loss_viz", f"{time_idx:04d}.png"),
                f"Tracking Loss Visualization — Frame {time_idx}")


def rgbd_slam(config: dict, device="cuda") -> dict:
    """Run the full online SLAM (splatam_tpu/slam/pipeline.py:1585-1853);
    returns the final evaluation's metric dict with the runtime averages.

    Per frame: pose init, compact, tracking (or the ground-truth pose;
    with tracking.visualize_tracking_loss, the tracked frame's panel
    figure), a progress report at frame 0 and every report_global_progress_every
    frames (at the tracking size), densify (at the densification size) and
    map every map_every frames, a keyframe every
    keyframe_every frames and at num_frames - 2 (only for a finite
    ground-truth pose), and a checkpoint every checkpoint_interval frames
    (save_checkpoints). Then eval_sequence on the final map and
    params.npz. With load_checkpoint the run resumes at
    checkpoint_time_idx. Progress prints one line per frame; errors are not
    caught (a failed render or launch ends the run)."""
    from splatam_tpu_torch.utils.logging import MetricsLogger, report_loss

    print("Loaded Config:")
    print(f"{config}")
    rt = SLAMRuntime(config, device)
    config = rt.config
    cfg_t, cfg_m = config["tracking"], config["mapping"]
    use_gt_poses = cfg_t["use_gt_poses"]
    report_iter = bool(config["report_iter_progress"])
    stats = dict.fromkeys(("tracking_iter_time_sum", "tracking_frame_time_sum",
                           "mapping_iter_time_sum", "mapping_frame_time_sum"), 0.0)
    stats.update(dict.fromkeys(("tracking_iter_time_count", "tracking_frame_time_count",
                                "mapping_iter_time_count", "mapping_frame_time_count"), 0))
    logger = MetricsLogger(bool(config["use_wandb"]), config, rt.output_dir)
    wandb_time_step = wandb_mapping_step = 0
    loss_figure = PanelFigure() if cfg_t["visualize_tracking_loss"] else None

    checkpoint_time_idx = 0
    if config["load_checkpoint"]:
        checkpoint_time_idx = int(config["checkpoint_time_idx"])
        rt.load_checkpoint(checkpoint_time_idx)

    for time_idx in range(checkpoint_time_idx, rt.num_frames):
        frame_start = time.time()
        color_np, depth_np, _, gt_pose = rt.dataset[time_idx]
        gt_w2c = np.linalg.inv(gt_pose)
        rt.gt_w2c_all.append(gt_w2c)
        color, depth = frame_to_tensors(color_np, depth_np, rt.device)
        tr_color, tr_depth = rt.frame_at(rt.tracking_dataset, time_idx, color, depth)
        rt.compact()
        rt.init_pose(time_idx)

        tracking_start = time.time()
        if time_idx > 0 and not use_gt_poses:
            rt.track_frame(time_idx, tr_color, tr_depth)
            stats["tracking_iter_time_count"] += rt.iters_run
            stats["tracking_frame_time_count"] += 1
            if logger.enabled and rt.tracking_hist is not None:
                for row in rt.tracking_hist:
                    wandb_time_step = report_loss(
                        logger, {"loss": row[0], "depth": row[1], "im": row[2]},
                        wandb_time_step, tracking=True)
            if report_iter:
                _replay_iter_progress(rt.tracking_hist, "Tracking", time_idx)
            if loss_figure is not None:
                _save_tracking_loss_viz(rt, loss_figure, time_idx, tr_color, tr_depth)
        elif time_idx > 0:
            rt.set_gt_pose(time_idx, gt_w2c)
            stats["tracking_frame_time_count"] += 1
        tracking_time = time.time() - tracking_start
        stats["tracking_frame_time_sum"] += tracking_time
        if time_idx > 0 and not use_gt_poses:
            stats["tracking_iter_time_sum"] += tracking_time

        if time_idx == 0 or (time_idx + 1) % config["report_global_progress_every"] == 0:
            m = report_progress(
                G.slice_prefix(rt.gm, rt.gm.span()), rt.cam_rots[time_idx],
                rt.cam_trans[time_idx], tr_color, tr_depth, rt.tracking_cam, cfg_t["sil_thres"],
                tracking=True, gt_w2c_list=rt.gt_w2c_all,
                est_w2c_list=[_w2c_from_qt(rt.cam_rots[i], rt.cam_trans[i])
                              for i in range(time_idx + 1)])
            print(f"[progress] frame {time_idx}: psnr={m['psnr']:.2f} "
                  f"depth_l1={m['depth_l1']:.4f} ate_cm={m['ate_rmse'] * 100:.2f}")
            logger.log({"Tracking/PSNR": m["psnr"], "Tracking/Depth RMSE": m["depth_rmse"],
                        "Tracking/Depth L1": m["depth_l1"],
                        "Tracking/ATE RMSE (cm)": m["ate_rmse"] * 100,
                        "Tracking/step": time_idx})

        if time_idx == 0 or (time_idx + 1) % config["map_every"] == 0:
            if cfg_m["add_new_gaussians"] and time_idx > 0:
                rt.densify_frame(time_idx, *rt.frame_at(rt.densify_dataset, time_idx, color,
                                                         depth))
            selected = rt.select_keyframes(time_idx, depth_np)
            rt._stage_keyframe(rt.kf_scratch_slot, color_np, depth_np)
            mapping_start = time.time()
            rt.map_frame(time_idx, selected)
            _sync(rt.device)
            mapping_time = time.time() - mapping_start
            stats["mapping_frame_time_sum"] += mapping_time
            stats["mapping_frame_time_count"] += 1
            stats["mapping_iter_time_sum"] += mapping_time
            stats["mapping_iter_time_count"] += _mapping_budget(cfg_m, time_idx)
            if report_iter:
                _replay_iter_progress(rt.mapping_hist, "Mapping", time_idx)
            if logger.enabled:
                for row in (rt.mapping_hist if rt.mapping_hist is not None else []):
                    wandb_mapping_step = report_loss(
                        logger, {"loss": row[0], "depth": row[1], "im": row[2]},
                        wandb_mapping_step, mapping=True)
                logger.log({"Mapping/Number of Gaussians": rt.gm.num_active(),
                            "Mapping/step": time_idx})

        # Keyframing (scripts/splatam.py:911-925).
        if ((time_idx == 0 or (time_idx + 1) % config["keyframe_every"] == 0
             or time_idx == rt.num_frames - 2) and np.isfinite(gt_w2c).all()):
            rt.add_keyframe(time_idx, color_np, depth_np)

        if config["save_checkpoints"] and time_idx % config["checkpoint_interval"] == 0:
            save_params_ckpt(rt.export_params(), rt.output_dir, time_idx)
            np.save(os.path.join(rt.output_dir, f"keyframe_time_indices{time_idx}.npy"),
                    np.array(rt.keyframe_time_indices))
        print(f"[splatam-torch] frame {time_idx + 1}/{rt.num_frames}: "
              f"{time.time() - frame_start:.3f} s, {rt.gm.num_active()} Gaussians", flush=True)

    # Runtime averages (scripts/splatam.py:939-953).
    s = stats
    tic, tfc = max(s["tracking_iter_time_count"], 1), max(s["tracking_frame_time_count"], 1)
    mic, mfc = max(s["mapping_iter_time_count"], 1), max(s["mapping_frame_time_count"], 1)
    runtime = {
        "tracking_iter_ms": s["tracking_iter_time_sum"] / tic * 1000,
        "tracking_frame_s": s["tracking_frame_time_sum"] / tfc,
        "mapping_iter_ms": s["mapping_iter_time_sum"] / mic * 1000,
        "mapping_frame_s": s["mapping_frame_time_sum"] / mfc,
    }
    print(f"\nAverage Tracking/Iteration Time: {runtime['tracking_iter_ms']} ms")
    print(f"Average Tracking/Frame Time: {runtime['tracking_frame_s']} s")
    print(f"Average Mapping/Iteration Time: {runtime['mapping_iter_ms']} ms")
    print(f"Average Mapping/Frame Time: {runtime['mapping_frame_s']} s")

    final_params = rt.export_params()
    metrics = eval_sequence(
        rt.dataset, final_params, rt.num_frames, rt.eval_dir,
        sil_thres=cfg_m["sil_thres"], mapping_iters=cfg_m["num_iters"],
        add_new_gaussians=cfg_m["add_new_gaussians"], eval_every=config["eval_every"],
        device=rt.device, bin_opts=rt.bin_opts)
    save_params(final_params, rt.output_dir)
    metrics["runtime"] = runtime
    logger.log({
        "Final Stats/Average Tracking Iteration Time (ms)": runtime["tracking_iter_ms"],
        "Final Stats/Average Tracking Frame Time (s)": runtime["tracking_frame_s"],
        "Final Stats/Average Mapping Iteration Time (ms)": runtime["mapping_iter_ms"],
        "Final Stats/Average Mapping Frame Time (s)": runtime["mapping_frame_s"],
        "Final Stats/step": 1,
    })
    logger.log({f"Final/{k}": v for k, v in metrics.items() if isinstance(v, float)})
    logger.finish()
    return metrics
