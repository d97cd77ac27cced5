"""Final evaluation: PSNR / MS-SSIM / LPIPS / depth RMSE & L1 / ATE RMSE.

Counterpart of splatam_tpu/eval/evaluate.py (reference:
utils/eval_helpers.py:408-623 for eval, :626+ for eval_nvs): the same
masks, metric definitions, per-frame .txt files and
valid_nvs_frames.npy. Every view renders through the generic render
(render/api.py render_rgbd_sil: K1 on the card) under torch.no_grad(), on
the device the caller names; each frame's images move there once.

The reference package's `_render_checked` (render, and retry with grown
pair buffers on overflow) has no counterpart: the port's pair buffers are
sized exactly by each binning, so a render cannot overflow.

Plots (the per-frame 2x3 panels, metrics.png) need matplotlib; where it
does not import, one line says so and no plot is written.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from splatam_tpu_torch.core.camera import Camera, setup_camera
from splatam_tpu_torch.core.gaussians import GaussianMap, from_params_dict
from splatam_tpu_torch.core.losses import calc_psnr, ms_ssim
from splatam_tpu_torch.core.transforms import build_rotation, matrix_to_quaternion
from splatam_tpu_torch.data import frame_to_tensors
from splatam_tpu_torch.eval.ate import evaluate_ate
from splatam_tpu_torch.eval.lpips import lpips_fn
from splatam_tpu_torch.render.api import CLASSIC, RenderOutput, render_rgbd_sil
from splatam_tpu_torch.render.binning import BinOptions
from splatam_tpu_torch.slam.steps import transform_to_frame


def _lpips_metrics(lpips, value) -> dict:
    """Self-describing LPIPS entries for a metrics dict: the canonical key
    `lpips` only for pretrained weights, `lpips_synthetic` for the
    synthesized calibration (not comparable to the paper's values), and
    `lpips_calibration` saying which one was used."""
    v = float(value)
    if lpips is None or np.isnan(v):
        return {"lpips_calibration": "unavailable"}
    if getattr(lpips, "synthetic", False):
        return {"lpips_synthetic": v, "lpips_calibration": "synthetic"}
    return {"lpips": v, "lpips_calibration": "pretrained"}


def _lpips_txt_name(lpips) -> str:
    return "lpips_synthetic" if getattr(lpips, "synthetic", False) else "lpips"


def _pyplot(save_plots: bool):
    """matplotlib.pyplot on the Agg backend, or None (with one line saying
    so) when plots are off or matplotlib does not import."""
    if not save_plots:
        return None
    try:
        import matplotlib
    except ImportError:
        print("[splatam-torch] matplotlib is not installed: no plots are written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _map_from_params(params: dict, device) -> GaussianMap:
    """The saved map on `device`, its rows exactly the saved ones."""
    return from_params_dict(params, device, capacity=len(params["means3D"]))


@torch.no_grad()
def render_at_pose(gm: GaussianMap, q, t, cam: Camera, backend: str = "auto",
                   bin_opts: BinOptions = CLASSIC) -> RenderOutput:
    """Render the map at pose (q, t) (wxyz quaternion, translation) with
    the generic render's `backend` and binning variants `bin_opts`
    (render.api.render_gaussians)."""
    q = torch.as_tensor(q, dtype=torch.float32, device=gm.device)
    t = torch.as_tensor(t, dtype=torch.float32, device=gm.device)
    means_cam, rots_cam = transform_to_frame(gm, q, t, False, False)
    return render_rgbd_sil(cam, means_cam, gm.rgb_colors, rots_cam, gm.logit_opacities,
                           gm.log_scales, gm.active, backend=backend, bin_opts=bin_opts)


def est_w2c_list_from_params(params: dict, num_frames: int, gt_w2c_list):
    """Rebuild the estimated trajectory, skipping nan-gt frames.

    Parity: utils/eval_helpers.py:545-566. Returns (valid_gt, est) lists.
    """
    valid_gt = [np.asarray(gt_w2c_list[0])]
    est = [np.eye(4, dtype=np.float32)]
    cam_rots = np.asarray(params["cam_unnorm_rots"])
    cam_trans = np.asarray(params["cam_trans"])
    for idx in range(1, num_frames):
        if np.isnan(np.asarray(gt_w2c_list[idx])).sum() > 0:
            continue
        q = cam_rots[..., idx].reshape(4)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = build_rotation(torch.as_tensor(q / np.linalg.norm(q))[None])[0].numpy()
        w2c[:3, 3] = cam_trans[..., idx].reshape(3)
        est.append(w2c)
        valid_gt.append(np.asarray(gt_w2c_list[idx]))
    return valid_gt, est


def _plot_rgbd_silhouette(plt, color, depth, rastered_color, rastered_depth, sil_mask,
                          diff_depth_l1, psnr, depth_l1, fig_title, plot_dir, plot_name):
    """Parity: plot_rgbd_silhouette (utils/eval_helpers.py:109-149)."""
    np_ = lambda x: x.detach().cpu().numpy()
    aspect_ratio = color.shape[2] / color.shape[1]
    fig, axs = plt.subplots(2, 3, figsize=(14 / 1.55 * aspect_ratio, 8))
    axs[0, 0].imshow(np.transpose(np_(color), (1, 2, 0)))
    axs[0, 0].set_title("Ground Truth RGB")
    axs[0, 1].imshow(np_(depth), cmap="jet", vmin=0, vmax=6)
    axs[0, 1].set_title("Ground Truth Depth")
    axs[1, 0].imshow(np.clip(np.transpose(np_(rastered_color), (1, 2, 0)), 0, 1))
    axs[1, 0].set_title("Rasterized RGB, PSNR: {:.2f}".format(psnr))
    axs[1, 1].imshow(np_(rastered_depth), cmap="jet", vmin=0, vmax=6)
    axs[1, 1].set_title("Rasterized Depth, L1: {:.2f}".format(depth_l1))
    axs[0, 2].imshow(np_(sil_mask), cmap="gray")
    axs[0, 2].set_title("Rasterized Silhouette")
    axs[1, 2].imshow(np_(diff_depth_l1), cmap="jet", vmin=0, vmax=6)
    axs[1, 2].set_title("Diff Depth L1")
    for ax in axs.flatten():
        ax.axis("off")
    fig.suptitle(fig_title, y=0.95, fontsize=16)
    fig.tight_layout()
    os.makedirs(plot_dir, exist_ok=True)
    plt.savefig(os.path.join(plot_dir, f"{plot_name}.png"), bbox_inches="tight")
    plt.close()


def _depth_errors(diff: torch.Tensor, valid: torch.Tensor) -> tuple[float, float]:
    """(rmse, l1) as the reference computes them: both sum |diff| over the
    valid count (the reference's "rmse" is sqrt(diff^2) summed)."""
    cnt = torch.clamp(valid.sum(), min=1)
    return float(torch.sqrt(diff**2).sum() / cnt), float(torch.abs(diff).sum() / cnt)


@torch.no_grad()
def report_progress(gm: GaussianMap, q, t, color, depth_gt, cam: Camera, sil_thres: float,
                    tracking: bool = False, gt_w2c_list=None, est_w2c_list=None) -> dict:
    """Per-frame progress metrics (PSNR, depth RMSE/L1, tracking ATE).

    Parity: report_progress (utils/eval_helpers.py:152-277) minus the
    wandb/tqdm plumbing; returns the metric dict instead. Only a failed
    trajectory alignment (evaluate_ate's SVD) is caught: its ATE is nan."""
    out = render_at_pose(gm, q, t, cam)
    valid = depth_gt > 0
    sil_mask = out.silhouette > sil_thres
    if tracking:
        psnr = float(calc_psnr(out.im * sil_mask[None], color * sil_mask[None]).mean())
        diff = (out.depth - depth_gt) * sil_mask * valid
    else:
        psnr = float(calc_psnr(out.im, color).mean())
        diff = (out.depth - depth_gt) * valid
    rmse, l1 = _depth_errors(diff, valid)
    metrics = {"psnr": psnr, "depth_rmse": rmse, "depth_l1": l1}
    if tracking and gt_w2c_list is not None and est_w2c_list is not None:
        try:
            metrics["ate_rmse"] = evaluate_ate(gt_w2c_list, est_w2c_list)
        except np.linalg.LinAlgError:
            metrics["ate_rmse"] = float("nan")
    return metrics


def eval_online(dataset, all_params: list, num_frames: int, eval_online_dir: str,
                sil_thres: float, mapping_iters: int, add_new_gaussians: bool,
                eval_every: int = 1, device="cuda") -> dict:
    """Per-timestep online evaluation over saved parameter snapshots.

    Parity: eval_online (utils/eval_helpers.py:279-405): frame t is
    evaluated against the params as they were at time t.
    """
    print("Evaluating Online Final Parameters...")
    os.makedirs(eval_online_dir, exist_ok=True)
    psnr_list, rmse_list, l1_list = [], [], []
    cam = None
    tracking_only = mapping_iters == 0 and not add_new_gaussians
    for time_idx in range(num_frames):
        if time_idx != 0 and (time_idx + 1) % eval_every != 0:
            continue
        params = all_params[time_idx]
        color_np, depth_np, intrinsics_np, _ = dataset[time_idx]
        if cam is None:
            cam = setup_camera(color_np.shape[1], color_np.shape[0], intrinsics_np[:3, :3], None)
        gm = _map_from_params(params, device)
        q = np.asarray(params["cam_unnorm_rots"])[0][:, time_idx]
        t = np.asarray(params["cam_trans"])[0][:, time_idx]
        color, depth = frame_to_tensors(color_np, depth_np, device)
        m = report_progress(gm, q, t, color, depth, cam, sil_thres, tracking=tracking_only)
        psnr_list.append(m["psnr"])
        rmse_list.append(m["depth_rmse"])
        l1_list.append(m["depth_l1"])
    result = {
        "psnr": float(np.mean(psnr_list)),
        "depth_rmse": float(np.mean(rmse_list)),
        "depth_l1": float(np.mean(l1_list)),
    }
    print("Online Average PSNR: {:.2f}".format(result["psnr"]))
    print("Online Average Depth RMSE: {:.2f}".format(result["depth_rmse"]))
    print("Online Average Depth L1: {:.2f}".format(result["depth_l1"]))
    np.savetxt(os.path.join(eval_online_dir, "online_psnr.txt"), np.array(psnr_list))
    np.savetxt(os.path.join(eval_online_dir, "online_rmse.txt"), np.array(rmse_list))
    np.savetxt(os.path.join(eval_online_dir, "online_l1.txt"), np.array(l1_list))
    return result


def _quat_from_w2c_np(w2c: np.ndarray) -> np.ndarray:
    q = matrix_to_quaternion(torch.as_tensor(w2c[:3, :3], dtype=torch.float32)).numpy()
    return q / np.linalg.norm(q)


def render_at_w2c(gm: GaussianMap, w2c: np.ndarray, cam: Camera,
                  backend: str = "auto") -> RenderOutput:
    """Render at an arbitrary pose given as a 4x4 w2c matrix (NVS eval path:
    utils/eval_helpers.py:672-691)."""
    return render_at_pose(gm, _quat_from_w2c_np(w2c), w2c[:3, 3].astype(np.float32), cam,
                          backend)


def _view_metrics(out: RenderOutput, color, depth, sil_thres: float, tracking_only: bool,
                  lpips, sil_in_depth: bool):
    """One view's (psnr, ms-ssim, lpips, rmse, l1, sil_mask, |diff|) as the
    reference's eval and eval_nvs compute them: images weighted by the
    valid-depth mask (and the silhouette in tracking-only mode); depth
    error over valid pixels (times the silhouette where `sil_in_depth`)."""
    valid = depth > 0
    sil_mask = out.silhouette > sil_thres
    if tracking_only:
        weighted_im = out.im * sil_mask[None] * valid[None]
        weighted_gt = color * sil_mask[None] * valid[None]
    else:
        weighted_im = out.im * valid[None]
        weighted_gt = color * valid[None]
    psnr = float(calc_psnr(weighted_im, weighted_gt).mean())
    ssim = float(ms_ssim(weighted_im, weighted_gt))
    lp = (float(lpips(torch.clamp(weighted_im, 0, 1), torch.clamp(weighted_gt, 0, 1)))
          if lpips is not None else float("nan"))
    diff = out.depth * valid - depth
    if sil_in_depth:
        diff = diff * sil_mask
    diff = diff * valid
    rmse, l1 = _depth_errors(diff, valid)
    return psnr, ssim, lp, rmse, l1, sil_mask, torch.abs(diff)


def _save_lists(eval_dir, lpips, psnr_list, rmse_list, l1_list, ssim_list, lpips_list):
    """The per-frame .txt files of eval and eval_nvs."""
    for name, vals in [("psnr", psnr_list), ("rmse", rmse_list), ("l1", l1_list),
                       ("ssim", ssim_list), (_lpips_txt_name(lpips), lpips_list)]:
        np.savetxt(os.path.join(eval_dir, f"{name}.txt"), np.array(vals))


@torch.no_grad()
def eval_nvs(dataset, final_params: dict, num_frames: int, eval_dir: str, sil_thres: float,
             mapping_iters: int, add_new_gaussians: bool, eval_every: int = 1, device="cuda",
             save_plots: bool = True, lpips_weights: str | None = None) -> dict:
    """Novel-view-synthesis evaluation on a held-out split.

    Parity: utils/eval_helpers.py:626-841 (eval_nvs): frame 0 is the first
    train frame (skipped), test views render at gt poses, frames with >0.1%
    holes (neither silhouette-present nor invalid-depth) are excluded from
    the averages.
    """
    print("Evaluating Final Parameters for Novel View Synthesis ...")
    os.makedirs(eval_dir, exist_ok=True)
    plot_dir = os.path.join(eval_dir, "plots")
    plt = _pyplot(save_plots)
    gm = _map_from_params(final_params, device)
    lpips = lpips_fn(lpips_weights, device=device)
    tracking_only = mapping_iters == 0 and not add_new_gaussians

    psnr_list, rmse_list, l1_list, ssim_list, lpips_list, valid_nvs = [], [], [], [], [], []
    cam = None
    for time_idx in range(num_frames):
        color_np, depth_np, intrinsics_np, pose_np = dataset[time_idx]
        gt_w2c = np.linalg.inv(pose_np)
        if time_idx == 0:
            cam = setup_camera(color_np.shape[1], color_np.shape[0], intrinsics_np[:3, :3], None)
            continue  # first train frame is not a test view
        test_time_idx = time_idx - 1
        if test_time_idx != 0 and (test_time_idx + 1) % eval_every != 0:
            continue
        color, depth = frame_to_tensors(color_np, depth_np, device)
        out = render_at_w2c(gm, gt_w2c, cam)
        # Hole-validity check (eval_helpers.py:710-716).
        valid = depth > 0
        valid_region = (out.silhouette > sil_thres) | ~valid
        percent_holes = float((~valid_region).float().mean()) * 100
        valid_nvs.append(percent_holes <= 0.1)
        psnr, ssim, lp, rmse, depth_l1, sil_mask, adiff = _view_metrics(
            out, color, depth, sil_thres, tracking_only, lpips, sil_in_depth=False)
        psnr_list.append(psnr)
        ssim_list.append(ssim)
        lpips_list.append(lp)
        rmse_list.append(rmse)
        l1_list.append(depth_l1)
        if plt is not None:
            _plot_rgbd_silhouette(plt, color, depth, out.im, out.depth, sil_mask, adiff, psnr,
                                  depth_l1, f"Time Step: {time_idx}", plot_dir,
                                  "%04d" % time_idx)

    valid_nvs = np.array(valid_nvs, bool)
    if valid_nvs.sum() == 0:
        print("WARNING: no valid NVS frames (all exceeded the hole threshold)")
        valid_nvs = np.ones_like(valid_nvs)
    metrics = {
        "psnr": float(np.array(psnr_list)[valid_nvs].mean()),
        "depth_rmse": float(np.array(rmse_list)[valid_nvs].mean()),
        "depth_l1": float(np.array(l1_list)[valid_nvs].mean()),
        "ms_ssim": float(np.array(ssim_list)[valid_nvs].mean()),
        "num_valid_frames": int(valid_nvs.sum()),
    }
    metrics.update(_lpips_metrics(lpips, np.array(lpips_list)[valid_nvs].mean()))
    print("Average PSNR: {:.2f}".format(metrics["psnr"]))
    print("Average Depth RMSE: {:.2f} cm".format(metrics["depth_rmse"] * 100))
    print("Average Depth L1: {:.2f} cm".format(metrics["depth_l1"] * 100))
    print("Average MS-SSIM: {:.3f}".format(metrics["ms_ssim"]))
    _save_lists(eval_dir, lpips, psnr_list, rmse_list, l1_list, ssim_list, lpips_list)
    np.save(os.path.join(eval_dir, "valid_nvs_frames.npy"), valid_nvs)
    return metrics


@torch.no_grad()
def eval_sequence(dataset, final_params: dict, num_frames: int, eval_dir: str,
                  sil_thres: float, mapping_iters: int, add_new_gaussians: bool,
                  eval_every: int = 1, device="cuda", save_plots: bool = True,
                  lpips_weights: str | None = None, bin_opts: BinOptions = CLASSIC) -> dict:
    """The reference's eval(): renders each evaluated frame at its
    estimated pose (binning with `bin_opts`, as the JAX runtime's final
    eval takes its phases' render config); returns the summary metric
    dict. Only a failed trajectory alignment (evaluate_ate's SVD, or
    evaluated frames that do not cover the trajectory) is caught, and gives
    the reference's ATE of 100.0; a failed render ends the evaluation."""
    print("Evaluating Final Parameters ...")
    os.makedirs(eval_dir, exist_ok=True)
    plot_dir = os.path.join(eval_dir, "plots")
    plt = _pyplot(save_plots)
    gm = _map_from_params(final_params, device)
    cam_rots = np.asarray(final_params["cam_unnorm_rots"])
    cam_trans = np.asarray(final_params["cam_trans"])
    lpips = lpips_fn(lpips_weights, device=device)

    psnr_list, rmse_list, l1_list, ssim_list, lpips_list = [], [], [], [], []
    gt_w2c_list = []
    cam = None
    tracking_only = mapping_iters == 0 and not add_new_gaussians
    for time_idx in range(num_frames):
        color_np, depth_np, intrinsics_np, pose_np = dataset[time_idx]
        gt_w2c_list.append(np.linalg.inv(pose_np))
        if time_idx == 0:
            cam = setup_camera(color_np.shape[1], color_np.shape[0], intrinsics_np[:3, :3], None)
        if time_idx != 0 and (time_idx + 1) % eval_every != 0:
            continue
        color, depth = frame_to_tensors(color_np, depth_np, device)
        out = render_at_pose(gm, cam_rots[..., time_idx].reshape(4),
                             cam_trans[..., time_idx].reshape(3), cam, bin_opts=bin_opts)
        psnr, ssim, lp, rmse, depth_l1, sil_mask, adiff = _view_metrics(
            out, color, depth, sil_thres, tracking_only, lpips, sil_in_depth=tracking_only)
        psnr_list.append(psnr)
        ssim_list.append(ssim)
        lpips_list.append(lp)
        rmse_list.append(rmse)
        l1_list.append(depth_l1)
        if plt is not None:
            _plot_rgbd_silhouette(plt, color, depth, out.im, out.depth, sil_mask, adiff, psnr,
                                  depth_l1, f"Time Step: {time_idx}", plot_dir,
                                  "%04d" % time_idx)

    nf = final_params["cam_unnorm_rots"].shape[-1]
    ate_rmse = None
    # Evaluated frames at another stride, or fewer, than the trajectory's
    # (the offline programs' eval_stride) do not cover it; the reference
    # package's catch-all then gives 100 as for a failed alignment.
    if nf <= len(gt_w2c_list):
        valid_gt, est = est_w2c_list_from_params(final_params, nf, gt_w2c_list)
        try:
            ate_rmse = evaluate_ate(valid_gt, est)
        except np.linalg.LinAlgError:
            pass
    if ate_rmse is None:
        ate_rmse = 100.0
        print("Failed to evaluate trajectory with alignment.")
    else:
        print("Final Average ATE RMSE: {:.2f} cm".format(ate_rmse * 100))

    metrics = {
        "psnr": float(np.mean(psnr_list)),
        "depth_rmse": float(np.mean(rmse_list)),
        "depth_l1": float(np.mean(l1_list)),
        "ms_ssim": float(np.mean(ssim_list)),
        "ate_rmse": float(ate_rmse),
    }
    metrics.update(_lpips_metrics(lpips, np.mean(lpips_list)))
    print("Average PSNR: {:.2f}".format(metrics["psnr"]))
    print("Average Depth RMSE: {:.2f} cm".format(metrics["depth_rmse"] * 100))
    print("Average Depth L1: {:.2f} cm".format(metrics["depth_l1"] * 100))
    print("Average MS-SSIM: {:.3f}".format(metrics["ms_ssim"]))
    if metrics["lpips_calibration"] == "unavailable":
        print("Average LPIPS: unavailable (no AlexNet weights found)")
    elif metrics["lpips_calibration"] == "synthetic":
        print("Average LPIPS (synthetic calibration): {:.3f} — NOT comparable to paper values; "
              "put a pretrained lpips_alex.npz beside splatam_tpu_torch/eval/lpips.py for "
              "canonical ones".format(metrics["lpips_synthetic"]))
    else:
        print("Average LPIPS: {:.3f}".format(metrics["lpips"]))
    _save_lists(eval_dir, lpips, psnr_list, rmse_list, l1_list, ssim_list, lpips_list)

    if plt is not None:
        fig, axs = plt.subplots(1, 2, figsize=(12, 4))
        axs[0].plot(np.arange(len(psnr_list)), psnr_list)
        axs[0].set_title("RGB PSNR")
        axs[0].set_xlabel("Time Step")
        axs[0].set_ylabel("PSNR")
        axs[1].plot(np.arange(len(l1_list)), np.array(l1_list) * 100)
        axs[1].set_title("Depth L1")
        axs[1].set_xlabel("Time Step")
        axs[1].set_ylabel("L1 (cm)")
        fig.suptitle(
            "Average PSNR: {:.2f}, Average Depth L1: {:.2f} cm, ATE RMSE: {:.2f} cm".format(
                metrics["psnr"], metrics["depth_l1"] * 100, metrics["ate_rmse"] * 100),
            y=1.05, fontsize=16)
        plt.savefig(os.path.join(eval_dir, "metrics.png"), bbox_inches="tight")
        plt.close()
    return metrics
