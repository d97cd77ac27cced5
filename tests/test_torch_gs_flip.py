"""Why tests/test_torch_gs_offline.py holds the offline programs at two
densify passes with the rotations' lr at 0: the trainer amplifies float32
noise, in both packages alike.

1. Rotations. A Gaussian with three equal scales (every one the first
   frame's cloud makes) has a rotation gradient of exactly 0 at the first
   step and then one proportional to the scale differences Adam has just
   begun to make, so its sign is decided by float32 rounding, and Adam
   (eps 1e-15) steps +-lr on it. The JAX package drifts from itself the
   same way when one input moves by one ulp or its render sums in another
   order, and so do colours, opacities and scales whose gradient cancels to
   float noise. Split children inherit the rotations, so at the config's
   rotation lr the two packages' maps drift apart pass by pass.
2. Thresholds. With the rotations held (lr 0) the two packages agree on
   every decision of the passes at 10 and 20; at 30 a Gaussian may be
   cloned or split in one package and not in the other. Every such
   Gaussian's averaged screen gradient lies within 1% of grad_thresh in
   both packages (their statistics differ by float32 reassociation after 30
   Adam steps), and every opacity-prune decision that differs lies within
   1% of the threshold: a flip, not a difference in the algorithm
   (tests/test_torch_c2f_flip.py is the same kind of finding).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from splatam_tpu.core import gaussians as JG
from splatam_tpu.render.api import RenderConfig
from splatam_tpu.slam import steps_gs as jsteps_gs
from splatam_tpu_torch.core import gaussians as G
from splatam_tpu_torch.core.camera import setup_camera
from splatam_tpu_torch.data import frame_to_tensors, get_dataset
from splatam_tpu_torch.scripts import gaussian_splatting as tgs
from splatam_tpu_torch.slam import steps, steps_gs
from test_torch_gs import FIELDS, TILES
from test_torch_gs_offline import _config, _run_jax, _run_port

torch.set_num_threads(1)  # see tests/test_torch_slam.py

FLIP_TOL = 0.01  # relative window around a threshold
NAIVE = RenderConfig(backend="naive")


def _chunks(n_iters, ulp=False, rcfg=TILES):
    """n_iters trainer steps on frame 0 from the first frame's anisotropic
    cloud, in the JAX package (its means moved by one ulp with ulp; its
    render by rcfg) and in the port; returns each package's active rows of
    the five parameter groups (FIELDS order)."""
    from splatam_tpu.core.camera import setup_camera as jsetup_camera
    from splatam_tpu.slam import optim as joptim
    from splatam_tpu_torch.slam import optim

    ds = get_dataset({"dataset_name": "synthetic", "num_frames": 3}, "", "box",
                     desired_height=48, desired_width=64)
    color_np, depth_np, k4, _ = ds[0]
    cam = setup_camera(64, 48, k4[:3, :3])
    pts, cols, mean_sq, valid = steps.first_frame_pointcloud(
        *frame_to_tensors(color_np, depth_np, "cpu"), cam)
    gm = G.from_pointcloud(pts, cols, mean_sq, valid, 4096, isotropic=False)
    act = gm.active.numpy()
    colors = np.clip(color_np, 0, 255).astype(np.uint8)[None]
    depths = depth_np[None, ..., 0]
    q = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (n_iters, 1))
    lrs = (0.00032, 0.0025, 0.001, 0.05, 0.005)
    fields = [jnp.asarray(getattr(gm, k).numpy()) for k in FIELDS]
    if ulp:
        fields[0] = jnp.nextafter(fields[0], fields[0] + 1.0)
    jm = JG.GaussianMap(*fields, jnp.asarray(act))
    jout = jsteps_gs.gs_mapping_chunk(
        jm, jsteps_gs.GSVariables.zeros(4096), joptim.adam_init(tuple(fields)),
        jnp.asarray(colors), jnp.asarray(depths), jnp.zeros(n_iters, jnp.int32), jnp.asarray(q),
        jnp.zeros((n_iters, 3)), jnp.int32(0), jsetup_camera(64, 48, k4[:3, :3]), n_iters,
        rcfg, lrs, 0.5, 1.0, None, False)[0]
    tout = steps_gs.gs_mapping_chunk(
        gm, steps_gs.GSVariables.zeros(4096, "cpu"),
        optim.adam_init(tuple(getattr(gm, k) for k in FIELDS)), torch.tensor(colors),
        torch.tensor(depths), [0] * n_iters, torch.tensor(q), torch.zeros((n_iters, 3)), 0, cam,
        n_iters, lrs, 0.5, 1.0, None, False)[0]
    return ([np.asarray(getattr(jout, k))[act] for k in FIELDS],
            [getattr(tout, k).numpy()[act] for k in FIELDS])


def _share_off(a, b):
    return float(np.mean(np.abs(a - b) > 1e-5))


def test_rotations_drift_apart_within_the_jax_package():
    """The first frame's cloud has three equal scales per Gaussian: its
    rotation gradients are exactly 0 at step 1 and then proportional to
    scale differences Adam has only begun to make, so their signs are
    decided by rounding, and Adam (eps 1e-15) steps +-lr on them; colours,
    opacities and scales of Gaussians whose gradient cancels to float noise
    step the same way. After 2 steps every entry of every group of the port
    lies within 1e-5 of the JAX package's. After 10 the test prints, per
    group, the share of entries more than 1e-5 apart between the packages
    and within the JAX package, between its tiles and naive backends (the
    same compositing summed in another order) and under a one-ulp change of
    its means. The JAX package drifts from itself in every group but the
    means, which hold the 99% rule in every comparison; the port is not
    required to drift."""
    jax2, port2 = _chunks(2)
    for k, j, t in zip(FIELDS, jax2, port2):
        assert np.abs(j - t).max() <= 1e-5, (k, np.abs(j - t).max())
    jax10, port10 = _chunks(10)
    ulp10, _ = _chunks(10, ulp=True)
    naive10, _ = _chunks(10, rcfg=NAIVE)
    for k, j, t, u, n in zip(FIELDS, jax10, port10, ulp10, naive10):
        shares = [_share_off(x, j) for x in (t, n, u)]
        print(f"{k}: after 10 steps the share of entries more than 1e-5 apart is "
              f"{shares[0]:.4f} between the packages, {shares[1]:.4f} between the JAX "
              f"package's tiles and naive backends, {shares[2]:.4f} under a one-ulp change")
        if k == "means3d":
            assert max(shares) <= 0.01, shares
        else:
            assert shares[1] > 0 and shares[2] > 0, (k, shares)


class _Stop(Exception):
    pass


def _recorder(fn, inputs, stop_at):
    """Records each densify pass's inputs (map and statistics, numpy) and
    the active count after it; stops the program at pass stop_at."""

    def wrapped(gm, gsvars, *args, **kwargs):
        inputs.append(dict(active=_np(gm.active), log_scales=_np(gm.log_scales),
                           logit=_np(gm.logit_opacities), accum=_np(gsvars[0]),
                           denom=_np(gsvars[1])))
        if len(inputs) == stop_at:
            raise _Stop
        out = fn(gm, gsvars, *args, **kwargs)
        inputs[-1]["after"] = int(out[0].active.sum())
        return out

    return wrapped


def _np(x):
    return x.numpy().copy() if torch.is_tensor(x) else np.asarray(x).copy()


def _decisions(rec, cfg, scene_radius):
    """A package's clone/split/prune inputs at a pass: the averaged
    gradient, the clone and split masks (steps_gs.densify_masks' rule) and
    the opacities."""
    denom = rec["denom"]
    grads = np.where(denom > 0, rec["accum"] / np.maximum(denom, 1e-20), 0.0)
    high = (grads >= np.float32(cfg.grad_thresh)) & rec["active"]
    max_scale = np.exp(rec["log_scales"]).max(axis=1)
    small = max_scale <= np.float32(0.01) * np.float32(scene_radius)
    opacity = 1.0 / (1.0 + np.exp(-rec["logit"].astype(np.float64)))
    return grads, high & small, high & ~small, opacity


def test_offline_pass_30_gap_is_a_threshold_flip(tmp_path):
    config = _config(str(tmp_path), "flip")
    config["train"]["densify_dict"]["stop_after"] = 30
    j_in, t_in = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsteps_gs, "densify_3dgs_step",
                   _recorder(jsteps_gs.densify_3dgs_step, j_in, 3))
        with pytest.raises(_Stop):
            from gaussian_splatting import offline_splatting
            _run_jax(offline_splatting, config)
        mp.setattr(steps_gs, "densify_3dgs_step",
                   _recorder(steps_gs.densify_3dgs_step, t_in, 3))
        with pytest.raises(_Stop):
            _run_port(tgs.offline_splatting, dict(config, run_name="flip_port"))
    assert [r["after"] for r in t_in[:2]] == [r["after"] for r in j_in[:2]]
    np.testing.assert_array_equal(t_in[2]["active"], j_in[2]["active"])

    cfg = steps_gs.DensifyConfig.from_dict(config["train"]["densify_dict"])
    scene_radius = float(get_dataset({"dataset_name": "synthetic", "num_frames": 3}, "", "box",
                                     desired_height=48, desired_width=64)[0][1].max()) / 2.0
    gj, cj, sj, oj = _decisions(j_in[2], cfg, scene_radius)
    gt, ct, st, ot = _decisions(t_in[2], cfg, scene_radius)
    act = j_in[2]["active"]
    flips = act & ((cj != ct) | (sj != st))
    print(f"pass 30: {flips.sum()} of {act.sum()} clone/split decisions differ")
    thr = cfg.grad_thresh
    assert (np.abs(gj[flips] - thr) <= FLIP_TOL * thr).all(), (gj[flips], gt[flips])
    assert (np.abs(gt[flips] - thr) <= FLIP_TOL * thr).all(), (gj[flips], gt[flips])
    assert flips.sum() <= 0.001 * act.sum()
    prune = act & ((oj < cfg.removal_opacity_threshold) != (ot < cfg.removal_opacity_threshold))
    thr = cfg.removal_opacity_threshold
    assert (np.abs(oj[prune] - thr) <= FLIP_TOL * thr).all()
    assert (np.abs(ot[prune] - thr) <= FLIP_TOL * thr).all()
