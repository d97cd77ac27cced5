"""Offline 3D Gaussian Splatting with ground-truth poses (counterpart of
scripts/gaussian_splatting.py; reference scripts/gaussian_splatting.py:
318-613).

    python -m splatam_tpu_torch.scripts.gaussian_splatting configs/replica/gaussian_splatting.py
    python -m splatam_tpu_torch.scripts.gaussian_splatting <config> --device cpu

Silhouette densification of every frame at its ground-truth pose at the
init size, then num_iters_mapping iterations over random frames at the
mapping size in chunks (train_offline), with 3DGS clone/split between
chunks and the exponential means3D schedule; an evaluation at each of
train.eval_intermediate_at (default [7000]) into eval_{k}k/, the final one
into eval/, then params.npz and a copy of the config, in
<workdir>/<run_name>/. Runs on the card unless --device cpu is given (the
kernels' plain versions); exits 2 when asked for the card and there is
none.
"""
from __future__ import annotations

import os
import random
import shutil
import time

import numpy as np
import torch

from splatam_tpu_torch.core import gaussians as G
from splatam_tpu_torch.core.camera import setup_camera
from splatam_tpu_torch.core.transforms import matrix_to_quaternion
from splatam_tpu_torch.data import _dataset_maker, frame_to_tensors
from splatam_tpu_torch.eval.evaluate import eval_sequence
from splatam_tpu_torch.io.params_io import save_params
from splatam_tpu_torch.scripts import harness
from splatam_tpu_torch.slam import optim, steps, steps_gs
from splatam_tpu_torch.slam.config import load_experiment_config, seed_everything
from splatam_tpu_torch.utils.device import require_device

PARAM_GROUPS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")


def _build_dataset(config: dict, h: int, w: int, stride=None):
    """The config's dataset at h x w (and stride; the data section's where
    None)."""
    return _dataset_maker(config["data"])(h, w, stride)


def _quat_from_w2c(w2c: np.ndarray) -> np.ndarray:
    return matrix_to_quaternion(torch.as_tensor(w2c[:3, :3], dtype=torch.float32)).numpy()


def draw_frames(rng: random.Random, n: int, num_frames: int) -> list:
    """One chunk's frames, uniform over [0, num_frames): after
    seed_everything(seed), random.Random(seed) draws the sequence the
    reference programs draw from the global random module."""
    return [rng.randint(0, num_frames - 1) for _ in range(n)]


class _Progress:
    """A tqdm bar where tqdm imports, else one printed line per chunk."""

    def __init__(self, total: int, desc: str):
        self.desc = desc
        try:
            from tqdm import tqdm
        except ImportError:
            self.bar = None
        else:
            self.bar = tqdm(total=total, desc=desc)

    def chunk(self, it: int, n: int, total: int, loss: float, n_active: int) -> None:
        if self.bar is None:
            print(f"{self.desc}: iteration {it}/{total}, loss {loss:.4f}, {n_active} Gaussians",
                  flush=True)
        else:
            self.bar.update(n)
            self.bar.set_postfix(loss=f"{loss:.4f}", n_gauss=n_active)

    def close(self) -> None:
        if self.bar is not None:
            self.bar.close()


def train_offline(gm: G.GaussianMap, timestep, mapping_dataset, cam, num_frames: int,
                  cam_rots: np.ndarray, cam_trans: np.ndarray, config: dict,
                  scene_radius: float, desc: str, after_chunk=None):
    """The chunked trainer the offline programs share
    (scripts/gaussian_splatting.py:163-287, scripts/post_splatam_opt.py:
    90-160): chunks of densify_every iterations (200 without
    densification), each over frames drawn by draw_frames from
    random.Random(config["seed"]) at the fixed poses (cam_rots, cam_trans),
    read once into a host cache at the mapping size; after each chunk
    after_chunk(it, gm, timestep), then, on the densify schedule, a 3DGS
    pass (steps_gs.densify_pass; split noise from a generator seeded
    config["seed"]), grown first when the clones and splits would not all
    find a free slot (the reference programs instead drop the surplus and
    restart Adam at the new size).

    Returns (map, timestep, record): record["passes"] has one entry per
    pass (iteration, cloned, split, active after it); record["iter_ms"] and
    record["pass_ms"] are the wall ms per training iteration and per pass
    (each chunk and pass ends in a host sync; the evaluations are not
    counted)."""
    train = config["train"]
    device = gm.device
    num_iters = int(train["num_iters_mapping"])
    lrs_map = train["lrs_mapping"]
    lrs = tuple(float(lrs_map[k]) for k in PARAM_GROUPS)
    lr_sched = (float(lrs_map["means3D"]), float(train["lrs_mapping_means3D_final"]),
                float(train.get("lr_delay_mult", 1.0)), float(num_iters))
    use_densify = train.get("use_gaussian_splatting_densification", False)
    dcfg = steps_gs.DensifyConfig.from_dict(train.get("densify_dict", {}), enabled=use_densify)
    chunk_size = dcfg.densify_every if use_densify else 200
    w_im, w_depth = float(train["loss_weights"]["im"]), float(train["loss_weights"]["depth"])

    frame_cache = {}

    def get_frame(idx):
        if idx not in frame_cache:
            c, d, _, _ = mapping_dataset[idx]
            frame_cache[idx] = (np.clip(c, 0, 255).astype(np.uint8), d[..., 0].astype(np.float32))
        return frame_cache[idx]

    gsvars = steps_gs.GSVariables.zeros(gm.capacity, device)
    opt_state = optim.adam_init(tuple(getattr(gm, k) for k in steps.MAP_PARAMS))
    rng = random.Random(config.get("seed", 0))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config.get("seed", 0)))
    passes = []
    train_s = pass_s = 0.0
    progress = _Progress(num_iters, desc)
    it = 0
    while it < num_iters:
        t0 = time.time()
        n = min(chunk_size, num_iters - it)
        frame_ids = draw_frames(rng, n, num_frames)
        distinct = sorted(set(frame_ids))
        slot_of = {f: s for s, f in enumerate(distinct)}
        colors = torch.as_tensor(np.stack([get_frame(f)[0] for f in distinct]), device=device)
        depths = torch.as_tensor(np.stack([get_frame(f)[1] for f in distinct]), device=device)
        qs = torch.as_tensor(np.stack([cam_rots[f] for f in frame_ids]), device=device)
        ts = torch.as_tensor(np.stack([cam_trans[f] for f in frame_ids]), device=device)
        gm, gsvars, opt_state, loss_sum = steps_gs.gs_mapping_chunk(
            gm, gsvars, opt_state, colors, depths, [slot_of[f] for f in frame_ids], qs, ts, it,
            cam, n, lrs, w_im, w_depth, lr_sched, use_densify)
        it += n
        loss = float(loss_sum) / n
        train_s += time.time() - t0
        progress.chunk(it, n, num_iters, loss, gm.num_active())
        if after_chunk is not None:
            after_chunk(it, gm, timestep)
        if use_densify and dcfg.due(it):
            t0 = time.time()
            cap = gm.capacity
            gm, timestep, gsvars, opt_state, n_clone, n_split = steps_gs.densify_pass(
                gm, timestep, gsvars, opt_state, scene_radius, gen, it, dcfg,
                final=it == dcfg.stop_after)
            if gm.capacity > cap:
                print(f"{desc}: grew capacity to {gm.capacity} for the densify pass", flush=True)
            passes.append(dict(iteration=it, cloned=n_clone, split=n_split,
                               active=gm.num_active()))
            pass_s += time.time() - t0
            print(f"{desc}: densify at iteration {it}: cloned {n_clone}, split {n_split}, "
                  f"{passes[-1]['active']} Gaussians active", flush=True)
    progress.close()
    return gm, timestep, dict(passes=passes, iter_ms=1e3 * train_s / max(num_iters, 1),
                              pass_ms=1e3 * pass_s / max(len(passes), 1))


def offline_splatting(config: dict, device="cuda") -> dict:
    """Run the offline program on `device` (the card unless the caller asks
    for the CPU); returns the final evaluation's metrics with
    train_offline's record (_with_record)."""
    device = require_device(device, "offline_splatting")
    print("Loaded Config:")
    config.setdefault("gaussian_distribution", "anisotropic")
    print(f"{config}")
    data, train = config["data"], config["train"]
    init_h = data.get("desired_image_height_init", data["desired_image_height"])
    init_w = data.get("desired_image_width_init", data["desired_image_width"])
    h, w = data["desired_image_height"], data["desired_image_width"]
    dataset = _build_dataset(config, init_h, init_w)
    mapping_dataset = _build_dataset(config, h, w)
    eval_dataset = _build_dataset(config, h, w, stride=data.get("eval_stride",
                                                                 data.get("stride", 1)))
    num_frames = data.get("num_frames", -1)
    if num_frames == -1:
        num_frames = len(dataset)
    eval_num_frames = data.get("eval_num_frames", -1)
    if eval_num_frames == -1:
        eval_num_frames = len(eval_dataset)
    isotropic = config["gaussian_distribution"] == "isotropic"

    # Frame 0 at the init size.
    color_np, depth_np, intr4, pose0 = dataset[0]
    cam = setup_camera(color_np.shape[1], color_np.shape[0], intr4[:3, :3], None)
    m_color, _, m_intr4, _ = mapping_dataset[0]
    map_intrinsics = m_intr4[:3, :3]
    map_cam = setup_camera(m_color.shape[1], m_color.shape[0], map_intrinsics, None)
    color, depth = frame_to_tensors(color_np, depth_np, device)
    pts, cols, mean_sq, valid = steps.first_frame_pointcloud(color, depth, cam)
    capacity = config.get("tpu", {}).get(
        "capacity", 1 << int(np.ceil(np.log2(max(pts.shape[0] * 2, 4096)))))
    while capacity < pts.shape[0]:
        capacity *= 2
    gm = G.from_pointcloud(pts, cols, mean_sq, valid, capacity, isotropic)
    timestep = torch.zeros((capacity,), dtype=torch.float32, device=device)
    scene_radius = float(depth_np.max()) / 2.0

    # Every frame's ground-truth pose and silhouette densification.
    gt_w2c_all = []
    cam_rots = np.tile(np.array([1, 0, 0, 0], np.float32), (num_frames, 1))
    cam_trans = np.zeros((num_frames, 3), np.float32)
    for time_idx in range(num_frames):
        color_np, depth_np, _, gt_pose = dataset[time_idx]
        gt_w2c = np.linalg.inv(gt_pose)
        gt_w2c_all.append(gt_w2c)
        cam_rots[time_idx] = _quat_from_w2c(gt_w2c)
        cam_trans[time_idx] = gt_w2c[:3, 3]
        if time_idx == 0:
            continue
        color, depth = frame_to_tensors(color_np, depth_np, device)
        q = torch.as_tensor(cam_rots[time_idx], device=device)
        t = torch.as_tensor(cam_trans[time_idx], device=device)
        gm, timestep = steps.densify_growing(gm, timestep, color, depth, q, t, time_idx, cam,
                                             float(train["sil_thres"]))
    print(f"Initialized {gm.num_active()} gaussians", flush=True)

    num_iters = int(train["num_iters_mapping"])
    output_dir = os.path.join(config["workdir"], config["run_name"])

    def export_params(gm, timestep):
        p = G.compact_to_numpy(gm)
        p["timestep"] = timestep.cpu().numpy()[gm.active.cpu().numpy()]
        p["cam_unnorm_rots"] = cam_rots.T[None]
        p["cam_trans"] = cam_trans.T[None]
        p["intrinsics"] = map_intrinsics
        p["w2c"] = np.linalg.inv(pose0)
        p["org_width"] = data["desired_image_width"]
        p["org_height"] = data["desired_image_height"]
        p["gt_w2c_all_frames"] = np.stack(gt_w2c_all)
        p["keyframe_time_indices"] = np.array([])
        return p

    def evaluate(gm, timestep, eval_dir):
        return eval_sequence(eval_dataset, export_params(gm, timestep), eval_num_frames,
                             eval_dir, sil_thres=train["sil_thres"], mapping_iters=num_iters,
                             add_new_gaussians=True, eval_every=config.get("eval_every", 1),
                             device=device)

    # The reference evaluates at exactly 7000 iterations into eval_7k/
    # (scripts/gaussian_splatting.py:539-553).
    eval_at = sorted(int(x) for x in train.get("eval_intermediate_at", [7000]))
    eval_at = [x for x in eval_at if 0 < x < num_iters]

    def after_chunk(it, gm, timestep):
        while eval_at and it >= eval_at[0]:
            k_iters = eval_at.pop(0)
            print(f"Evaluating Params at {k_iters} Iterations")
            evaluate(gm, timestep, os.path.join(output_dir, f"eval_{k_iters // 1000}k"))

    gm, timestep, record = train_offline(gm, timestep, mapping_dataset, map_cam, num_frames,
                                         cam_rots, cam_trans, config, scene_radius,
                                         "Offline mapping", after_chunk)
    metrics = evaluate(gm, timestep, os.path.join(output_dir, "eval"))
    save_params(export_params(gm, timestep), output_dir)
    return _with_record(metrics, record)


def _with_record(metrics: dict, record: dict) -> dict:
    """The evaluation's metrics with the trainer's record: "densify_passes"
    and "training" (wall ms per iteration and per pass)."""
    metrics["densify_passes"] = record["passes"]
    metrics["training"] = {"iter_ms": record["iter_ms"], "pass_ms": record["pass_ms"]}
    return metrics


def main(argv=None) -> dict:
    ap = harness.parser(__doc__)
    ap.add_argument("experiment", type=str, help="Path to experiment file")
    args = ap.parse_args(argv)
    device = harness.resolve_device(args.device, "gaussian_splatting")
    config = load_experiment_config(args.experiment)
    seed_everything(seed=config["seed"])
    results_dir = os.path.join(config["workdir"], config["run_name"])
    os.makedirs(results_dir, exist_ok=True)
    shutil.copy(args.experiment, os.path.join(results_dir, "config.py"))
    return offline_splatting(config, device)


if __name__ == "__main__":
    main()
