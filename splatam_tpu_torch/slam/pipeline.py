"""Online RGB-D SLAM pipeline: per-frame track -> densify -> map.

Counterpart of splatam_tpu/slam/pipeline.py for the online loop as
bench.py drives it (reference: scripts/splatam.py:455-990). Host state
(trajectory, keyframe list) is numpy; the map and the keyframe store live
on `device`. Keyframe draws use np.random exactly as the reference package
does, so both packages draw the same schedule from the same seed.

Not carried over, because they exist only because XLA compiles one program
per shape: the background precompile threads, the capacity bucket ladder
and the compile cache. Pair buffers are sized exactly, so the pair budget
and its overflow retries have no counterpart either; phases run on the
active span of the map.
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_tpu_torch.core import gaussians as G
from splatam_tpu_torch.core.camera import setup_camera
from splatam_tpu_torch.data import get_dataset
from splatam_tpu_torch.slam import steps
from splatam_tpu_torch.slam.config import backfill_defaults
from splatam_tpu_torch.slam.keyframes import keyframe_selection_overlap


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


def frame_to_tensors(color_np, depth_np, device):
    """Dataset frame (HWC 0-255 color, HW1 depth) -> ([3,H,W], [H,W])."""
    color = torch.as_tensor(color_np.transpose(2, 0, 1) / 255.0, dtype=torch.float32)
    depth = torch.as_tensor(depth_np[..., 0], dtype=torch.float32)
    return color.to(device), depth.to(device)


def _unported(config: dict) -> None:
    """Raise for every configuration this slice does not run."""
    tpu, data = config["tpu"], config["data"]
    checks = [
        (int(tpu.get("rebin_every", 1)) <= 1,
         "tpu.rebin_every=1 needs the composite-backward kernel (ROADMAP, TPU kernel list item 5)"),
        (config["gaussian_distribution"] != "isotropic",
         "anisotropic maps need the composite-backward kernel (ROADMAP, TPU kernel list item 5)"),
        ((config["tracking"].get("coarse_to_fine") or {}).get("enabled", False),
         "coarse-to-fine tracking is not ported yet (ROADMAP, module list item 5)"),
        (int(tpu.get("spatial_shards", 0)) > 1,
         "row-sharded rendering is not ported yet (ROADMAP, module list item 9)"),
        (config["mapping"].get("use_gaussian_splatting_densification", False),
         "3DGS densification is not ported yet (ROADMAP, module list item 7)"),
        ("gradslam_data_cfg" in data,
         "dataset YAML configs are not ported yet (ROADMAP, module list item 3)"),
        (data["densification_image_height"] != data["desired_image_height"]
         or data["densification_image_width"] != data["desired_image_width"]
         or data["tracking_image_height"] != data["desired_image_height"]
         or data["tracking_image_width"] != data["desired_image_width"],
         "separate tracking/densification resolutions are not ported yet "
         "(ROADMAP, module list item 5)"),
    ]
    for bad, msg in checks:
        if bad:
            raise NotImplementedError(msg)


class SLAMRuntime:
    """Mutable state of one SLAM run, on one device."""

    def __init__(self, config: dict, device):
        self.config = config = backfill_defaults(config)
        _unported(config)
        self.device = device = torch.device(device)
        data = config["data"]
        self.dataset = get_dataset(
            config_dict={"dataset_name": data["dataset_name"],
                         "num_frames": data.get("num_frames", 30),
                         **{k: data[k] for k in ("motion_scale", "depth_noise_sigma",
                                                 "synthetic_seed", "trajectory")
                            if k in data}},
            basedir=data.get("basedir", ""),
            sequence=str(data.get("sequence", "")),
            desired_height=data["desired_image_height"],
            desired_width=data["desired_image_width"],
        )
        num_frames = data.get("num_frames", -1)
        self.num_frames = len(self.dataset) if num_frames == -1 else num_frames
        self.rebin_every = int(config["tpu"]["rebin_every"])
        self.pcfg_track = _phase_cfg(config["tracking"])
        self.pcfg_map = _phase_cfg(config["mapping"])
        self.prune_cfg = _prune_cfg(config["mapping"])

        color_np, depth_np, intrinsics_np, _ = self.dataset[0]
        self.intrinsics = intrinsics_np[:3, :3]
        h, w = color_np.shape[0], color_np.shape[1]
        self.cam = setup_camera(w, h, self.intrinsics, None)

        capacity = int(config["tpu"]["capacity"])
        color, depth = frame_to_tensors(color_np, depth_np, device)
        pts, cols, mean_sq, valid = steps.first_frame_pointcloud(color, depth, self.cam)
        while capacity < pts.shape[0]:
            capacity *= 2
        self.gm = G.from_pointcloud(pts, cols, mean_sq, valid, capacity, True)
        self.timestep = torch.zeros((capacity,), dtype=torch.float32, device=device)
        self.scene_radius = float(depth_np.max()) / config["scene_radius_depth_ratio"]

        self.cam_rots = np.tile(np.array([1, 0, 0, 0], np.float32), (self.num_frames, 1))
        self.cam_trans = np.zeros((self.num_frames, 3), np.float32)

        kf_cap = self.num_frames // max(config["keyframe_every"], 1) + 3
        self.kf_colors = torch.zeros((kf_cap, h, w, 3), dtype=torch.uint8, device=device)
        self.kf_depths = torch.zeros((kf_cap, h, w), dtype=torch.float32, device=device)
        self.kf_scratch_slot = kf_cap - 1
        self.keyframe_list = []  # dicts: id, slot, q, t
        self.gt_w2c_all = []

    def compact(self) -> None:
        """Re-pack active Gaussians into a dense prefix, unless the holes
        are few (the reference package's threshold)."""
        n = self.gm.num_active()
        holes = self.gm.span() - n
        if holes <= max(4096, n >> 6):
            return
        self.gm, self.timestep = G.compact(self.gm, self.timestep)

    def _grow(self, new_capacity: int) -> None:
        self.gm = G.grow_capacity(self.gm, new_capacity)
        pad = new_capacity - self.timestep.shape[0]
        self.timestep = torch.cat([self.timestep, self.timestep.new_zeros(pad)])
        print(f"[splatam-torch] grew gaussian capacity to {new_capacity}")

    def _stage_keyframe(self, slot: int, color_np: np.ndarray, depth_np: np.ndarray) -> None:
        self.kf_colors[slot] = torch.as_tensor(np.clip(color_np, 0, 255).astype(np.uint8))
        self.kf_depths[slot] = torch.as_tensor(depth_np[..., 0], dtype=torch.float32)

    def track_frame(self, time_idx: int, tr_color, tr_depth) -> None:
        cfg_t = self.config["tracking"]
        view = G.slice_prefix(self.gm, self.gm.span())
        q0 = torch.as_tensor(self.cam_rots[time_idx], device=self.device)
        t0 = torch.as_tensor(self.cam_trans[time_idx], device=self.device)
        best_q, best_t, _, _ = steps.tracking_phase(
            view, q0, t0, tr_color, tr_depth, self.cam, int(cfg_t["num_iters"]),
            bool(cfg_t["use_depth_loss_thres"]), float(cfg_t["depth_loss_thres"]),
            float(cfg_t["lrs"]["cam_unnorm_rots"]), float(cfg_t["lrs"]["cam_trans"]),
            self.pcfg_track, self.rebin_every,
            lr_decay_frac=float(cfg_t.get("lr_decay_frac", 1.0)),
        )
        self.cam_rots[time_idx] = best_q.cpu().numpy()
        self.cam_trans[time_idx] = best_t.cpu().numpy()

    def densify_frame(self, time_idx: int, d_color, d_depth) -> None:
        q = torch.as_tensor(self.cam_rots[time_idx], device=self.device)
        t = torch.as_tensor(self.cam_trans[time_idx], device=self.device)
        while True:
            gm2, ts2, _, n_dropped = steps.densify_step(
                self.gm, self.timestep, d_color, d_depth, q, t, time_idx, self.cam,
                float(self.config["mapping"]["sil_thres"]))
            if n_dropped == 0:
                break
            new_cap = self.gm.capacity
            while new_cap < self.gm.capacity + n_dropped:
                new_cap *= 2
            self._grow(new_cap)
        self.gm, self.timestep = gm2, ts2

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
        dev = self.device
        qs = torch.as_tensor(np.stack([self.cam_rots[f] for f in frame_ids]), device=dev)
        ts = torch.as_tensor(np.stack([self.cam_trans[f] for f in frame_ids]), device=dev)
        struct_qs = torch.as_tensor(np.stack([self.cam_rots[f] for f in uniq]), device=dev)
        struct_ts = torch.as_tensor(np.stack([self.cam_trans[f] for f in uniq]), device=dev)
        return slots, qs, ts, struct_qs, struct_ts, iter_idx

    def map_frame(self, time_idx: int, selected: list) -> None:
        cfg_m = self.config["mapping"]
        num_iters = _mapping_budget(cfg_m, time_idx)
        if num_iters == 0:
            return
        lrs_d = cfg_m["lrs"]
        lrs = tuple(float(lrs_d[k]) for k in (
            "means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales"))
        slots, qs, ts, struct_qs, struct_ts, iter_idx = self._mapping_inputs(
            time_idx, selected, num_iters)
        view = G.slice_prefix(self.gm, self.gm.span())
        view = steps.mapping_phase(
            view, self.kf_colors, self.kf_depths, slots, qs, ts, self.scene_radius,
            self.cam, num_iters, self.pcfg_map, self.prune_cfg, lrs, struct_qs, struct_ts,
            iter_idx)
        self.gm = G.write_prefix(self.gm, view)


def run_frame(rt: SLAMRuntime, time_idx: int) -> None:
    """One frame of the online loop in bench.py's order: constant-velocity
    pose init, compact, track, densify, keyframe selection, stage the
    current frame, map, and append a keyframe every keyframe_every frames."""
    color_np, depth_np, _, gt_pose = rt.dataset[time_idx]
    rt.gt_w2c_all.append(np.linalg.inv(gt_pose))
    color, depth = frame_to_tensors(color_np, depth_np, rt.device)
    if time_idx > 1:
        p1 = rt.cam_rots[time_idx - 1] / np.linalg.norm(rt.cam_rots[time_idx - 1])
        p2 = rt.cam_rots[time_idx - 2] / np.linalg.norm(rt.cam_rots[time_idx - 2])
        nr = p1 + (p1 - p2)
        rt.cam_rots[time_idx] = nr / np.linalg.norm(nr)
        rt.cam_trans[time_idx] = rt.cam_trans[time_idx - 1] + (
            rt.cam_trans[time_idx - 1] - rt.cam_trans[time_idx - 2])
    elif time_idx == 1:
        rt.cam_rots[1] = rt.cam_rots[0]
        rt.cam_trans[1] = rt.cam_trans[0]
    rt.compact()
    if time_idx > 0:
        rt.track_frame(time_idx, color, depth)
        rt.densify_frame(time_idx, color, depth)
    selected = rt.select_keyframes(time_idx, depth_np)
    rt._stage_keyframe(rt.kf_scratch_slot, color_np, depth_np)
    rt.map_frame(time_idx, selected)
    if time_idx == 0 or (time_idx + 1) % rt.config["keyframe_every"] == 0:
        slot = len(rt.keyframe_list)
        rt._stage_keyframe(slot, color_np, depth_np)
        rt.keyframe_list.append({"id": time_idx, "slot": slot,
                                 "q": rt.cam_rots[time_idx].copy(),
                                 "t": rt.cam_trans[time_idx].copy()})
