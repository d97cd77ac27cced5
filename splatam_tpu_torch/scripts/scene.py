"""The synthetic map the measurement scripts render.

The JAX scripts build it by hand, each the same way (scripts/probe_dma.py:56-72,
scripts/probe_unroll.py:59-72, scripts/profile_iter.py:294-315): n Gaussians
uniform in the box [-3, -2, 0.5] - [3, 2, 6.5] in front of an identity
camera, uniform rgb, identity rotations, one opacity logit for all,
isotropic log-scales log U(0.004, 0.02), fx = fy = 300 at the image centre,
all drawn from one seeded numpy generator (means, rgb, then scales).
"""
from __future__ import annotations

import numpy as np
import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.render import api, fused_iso
from splatam_tpu_torch.slam import steps

BOX_LO = (-3.0, -2.0, 0.5)
BOX_HI = (3.0, 2.0, 6.5)
FOCAL = 300.0


def scene_arrays(n: int, opacity_logit: float = 1.0, seed: int = 0) -> dict:
    """The map's fields as numpy arrays (GaussianMap's field names)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(BOX_LO, BOX_HI, (n, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    log_scales = np.log(rng.uniform(0.004, 0.02, (n, 1))).astype(np.float32)
    return dict(
        means3d=means,
        rgb_colors=rgb,
        unnorm_rotations=np.tile(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1)),
        logit_opacities=np.full((n,), opacity_logit, np.float32),
        log_scales=log_scales,
        active=np.ones((n,), bool),
    )


def scene_camera(width: int, height: int, focal: float = FOCAL) -> Camera:
    return Camera(height=height, width=width, fx=focal, fy=focal, cx=width / 2.0,
                  cy=height / 2.0)


def synthetic_scene(n: int, width: int, height: int, opacity_logit: float, device,
                    seed: int = 0, focal: float = FOCAL):
    """(map, q, t, camera): the map on `device` at the identity pose."""
    gm = GaussianMap(**{k: torch.tensor(v, device=device)
                        for k, v in scene_arrays(n, opacity_logit, seed).items()})
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
    t = torch.zeros(3, device=device)
    return gm, q, t, scene_camera(width, height, focal)


def fused_inputs(gm: GaussianMap, q, t, cam: Camera, bin_opts=api.CLASSIC):
    """The fused forward's inputs at pose (q, t): the pair structure with its
    world-8 rows (tracking's rebin build, binned with `bin_opts`) and the
    pose vector."""
    ps = steps.loss_pair_structure(gm, q, t, cam, with_world16=True, bin_opts=bin_opts)
    rmat = fused_iso.build_rotation(fused_iso.normalize(q)[None])[0]
    width, height, intr = fused_iso._geom_for(cam)
    return ps, fused_iso.make_pose_vec(rmat, t, width, height, *intr)
