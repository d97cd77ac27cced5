"""Config keys the port carries, each held against the JAX package end to
end: 2 frames of test_torch_slam.py's micro config (6 tracking and 8 mapping
iterations at 64x48, rebin_every=8, so the fused path) with one key changed;
use_depth_loss_thres also at rebin_every=1 (the generic render). The same
keys at rebin_every=1 and on an anisotropic map: test_torch_slam_keys_rebin1.py
and test_torch_slam_keys_aniso.py (check_key with a variant).

Same tolerance as test_slam_loop_matches_jax: poses within 1e-4, equal
active counts per frame, equal keyframes. Each case also checks that its
key changed the run (against the unchanged config's poses or counts at the
case's rebin_every, run once per module in the port only), so a key that is silently ignored by
both packages does not pass for parity; the one key both packages ignore
on purpose (use_l1, as the reference does) must leave the run unchanged.
"""
import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

from splatam_tpu_torch.slam.config import seed_everything
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame
from test_torch_slam import _config, run_both

torch.set_num_threads(1)

FRAMES = 2
PRUNING = dict(start_after=0, remove_big_after=0, stop_after=6, prune_every=2,
               removal_opacity_threshold=0.49, final_removal_opacity_threshold=0.005,
               reset_opacities=True, reset_opacities_every=5)
CASES = {
    # the 10x-median outlier mask in both phases, floored at 5 cm
    "outlier_mask": dict(tracking={"ignore_outlier_depth_loss": True, "outlier_floor_m": 0.05},
                         mapping={"ignore_outlier_depth_loss": True, "outlier_floor_m": 0.05}),
    # pixels whose normalised depth variance is above (5 cm)^2 leave the tracking loss
    "depth_uncertainty": dict(tracking={"depth_uncertainty_thres": 0.05}),
    # a threshold no frame meets: tracking runs its one-time doubling (12 iterations)
    "depth_loss_doubling": dict(tracking={"use_depth_loss_thres": True,
                                          "depth_loss_thres": 1e-6}),
    # the same on the generic render (rebin_every=1), as ScanNet++ and the iPhone capture run it
    "depth_loss_doubling_rebin1": dict(tracking={"use_depth_loss_thres": True,
                                                 "depth_loss_thres": 1e-6},
                                       tpu={"rebin_every": 1}),
    "lr_decay": dict(tracking={"lr_decay_frac": 0.1}),
    # frame 0 maps 14 iterations instead of 8
    "bootstrap": dict(mapping={"bootstrap_num_iters": 14, "bootstrap_frames": 1}),
    "current_frame_prob": dict(mapping={"current_frame_prob": 0.6}),
    # pruning at iterations 0, 2, 4 (opacity below 0.49: the Gaussians whose two or four
    # Adam steps went down) and 6 (the final threshold), remove-big on, opacities reset to
    # 0.01 at iteration 5. After a reset the silhouette is below tracking's sil_thres
    # everywhere, so frame 1's tracking has no pixels and the camera stays: this case holds
    # the pruning decisions (the active counts) and the reset, not the poses
    "prune_and_reset": dict(mapping={"pruning_dict": PRUNING}),
    # the same schedule with pruning off: nothing leaves the map
    "prune_off": dict(mapping={"prune_gaussians": False, "pruning_dict": PRUNING}),
    # remove-big from iteration 4 on only, where about half of frame 0's Gaussians are bigger
    # than 0.1 scene radius (scene radius = max depth / 7)
    "remove_big_after": dict(scene_radius_depth_ratio=7, mapping={"pruning_dict": dict(
        PRUNING, removal_opacity_threshold=0.005, reset_opacities=False, remove_big_after=4)}),
    # both packages ignore use_l1, as the reference does (its get_loss always takes L1):
    # the run equals the unchanged config's
    "use_l1_off": dict(tracking={"use_l1": False}, mapping={"use_l1": False}),
}
IGNORED = {"use_l1_off"}


def _merge(case: dict, variant: dict) -> dict:
    """The case's overrides with the variant's on top (sections merged)."""
    out = dict(case)
    for key, value in variant.items():
        out[key] = {**case.get(key, {}), **value} if isinstance(value, dict) else value
    return out


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """base(rebin_every, distribution): the port's run of the micro config
    unchanged but for rebin_every and gaussian_distribution, made once per
    pair."""
    runs = {}

    def base(rebin_every, distribution="isotropic"):
        key = (rebin_every, distribution)
        if key not in runs:
            seed_everything(0)
            rt = SLAMRuntime(_config(tmp_path_factory.mktemp("base"),
                                     tpu={"rebin_every": rebin_every},
                                     gaussian_distribution=distribution), "cpu")
            active = []
            for i in range(FRAMES):
                run_frame(rt, i)
                active.append(rt.gm.num_active())
            runs[key] = rt, active
        return runs[key]

    return base


@pytest.mark.parametrize("case", sorted(CASES))
def test_config_key_matches_jax(tmp_path, bases, case):
    check_key(tmp_path, bases, case)


def check_key(tmp_path, bases, case: str, variant: dict | None = None):
    """CASES[case] with the variant's overrides (a rebin_every, a
    distribution) in both packages; see the module docstring."""
    overrides = _merge(CASES[case], variant or {})
    base = bases(overrides.get("tpu", {}).get("rebin_every", 8),
                 overrides.get("gaussian_distribution", "isotropic"))
    rt, jrt, t_active, j_active = run_both(tmp_path, frames=FRAMES, **overrides)
    assert t_active == j_active
    np.testing.assert_allclose(rt.cam_rots[:FRAMES], jrt.cam_rots[:FRAMES], atol=1e-4)
    np.testing.assert_allclose(rt.cam_trans[:FRAMES], jrt.cam_trans[:FRAMES], atol=1e-4)
    assert [k["id"] for k in rt.keyframe_list] == [k["id"] for k in jrt.keyframe_list]
    assert np.isfinite(rt.cam_trans).all()
    if case == "prune_and_reset":
        assert t_active[0] < base[1][0]  # pruning past iteration 0 removed Gaussians
        assert float(rt.gm.logit_opacities[rt.gm.active].min()) < -4.0  # reset to logit(0.01)
    else:
        assert np.abs(rt.cam_trans[1]).max() > 1e-3  # the camera moved
    base_rt, base_active = base
    moved = max(np.abs(rt.cam_trans[:FRAMES] - base_rt.cam_trans[:FRAMES]).max(),
                np.abs(rt.cam_rots[:FRAMES] - base_rt.cam_rots[:FRAMES]).max())
    means_moved = (rt.gm.span() != base_rt.gm.span()
                   or float((rt.gm.means3d[:rt.gm.span()]
                             - base_rt.gm.means3d[:rt.gm.span()]).abs().max()) > 0)
    if case == "prune_off":
        # the schedule that removes Gaussians at frame 0 with pruning on (prune_and_reset)
        # removes none: every valid pixel of frame 0 is still a Gaussian
        assert t_active[0] == int((rt.dataset[0][1] > 0).sum())
    elif case in IGNORED:
        assert moved == 0 and t_active == base_active and not means_moved
    else:
        assert moved > 1e-6 or t_active != base_active or means_moved, "the key changed nothing"
