"""Fault 9's split, pinned on the CPU: the generic route's first tracking
gradient (q, t), taken as splatam_tpu_torch/scripts/track_grad_split.py
takes it on the card (PERF.md, fault 9), on seeded layered maps whose
pixels mostly end saturated (T_final down to the 1e-4 stop, the tracking
mask's silhouette above 0.99 on ~90% of the image).

Found on the card, and held here:
  - in float64 the port's route (projection, binning, K1/K2/K3's plain
    versions, the loss) is the reference's (slam_bench/reference/) to
    1e-12, given the same camera: the port's mathematics is upstream's;
  - in float32 its backward lies within rounding of float64, and on a
    saturated map most of that rounding is the recovery of T_final as
    1 - the float32 silhouette, which the JAX package's kernel does too
    (composite_pallas.py:335): handed T_final itself, the backward's error
    drops by 5x or more. On the tum cell's maps it is hidden: the split
    read the same backward error either way;
  - one pixel of the loss's mask moved (as a silhouette at 0.99, or a
    depth residual at 0, rounds apart between two float32 evaluations)
    moves the gradient far more than the whole float32 backward: the
    track_grad_gap of the tum cell is the mathematics' conditioning.
"""
import pytest
import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.render import binning
from splatam_tpu_torch.scripts import track_grad_split as split
from splatam_tpu_torch.slam import steps

H, W = 48, 64
# tum's camera scaled to 64 pixels across: fx, cx, cy are not float32 numbers
CAM = Camera(height=H, width=W, fx=51.73, fy=51.65, cx=31.86, cy=25.53)
TRACKING = {"use_sil_for_loss": True, "sil_thres": 0.99, "use_l1": True,
            "ignore_outlier_depth_loss": False, "loss_weights": {"im": 0.5, "depth": 1.0}}
CONFIG = {"experiment": {"tracking": TRACKING}}


def layered_scene(seed: int, n: int = 3000) -> dict:
    """The tracking inputs split.program_side takes: n isotropic Gaussians
    in five depth layers (1.0 to 2.4 m) over the whole view, opacities
    0.88 to 0.998 (many clamped at 0.99), a pose near identity, and a
    frame near the render (colour +-0.05, depth +-0.01 m)."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float64)

    z = 1.0 + 0.35 * torch.randint(0, 5, (n,), generator=g).double() + 0.05 * rand(n)
    x = (rand(n) * (W + 8) - 4 - CAM.cx) / CAM.fx * z
    y = (rand(n) * (H + 8) - 4 - CAM.cy) / CAM.fy * z
    rots = torch.cat([torch.ones(n, 1, dtype=torch.float64), 0.1 * (rand(n, 3) - 0.5)], 1)
    gm = GaussianMap(torch.stack([x, y, z], 1).float(), rand(n, 3).float(), rots.float(),
                     (2.0 + 4.0 * rand(n)).float(), torch.log(0.01 + 0.03 * rand(n, 1)).float(),
                     torch.ones(n, dtype=torch.bool))
    q = torch.tensor([1.0, 0.01, -0.02, 0.005])
    q = q / torch.linalg.vector_norm(q)
    t = torch.tensor([0.01, -0.02, 0.03])
    with torch.no_grad():
        out = steps.loss_render(gm, q, t, CAM, True, False, None)
    color = torch.clamp(out.im + 0.1 * (rand(3, H, W).float() - 0.5), 0.0, 1.0)
    depth = out.depth + 0.02 * (rand(H, W).float() - 0.5)
    pcfg = steps.PhaseConfig(True, 0.99, True, False, 0.5, 1.0)
    return dict(gm=gm, q=q, t=t, color=color, depth=depth, cam=CAM, pcfg=pcfg,
                bin_opts=binning.BinOptions(), lrs=(0.002, 0.002), out=out)


@pytest.fixture(scope="module", params=[0, 1])
def scene(request):
    torch.set_num_threads(1)
    cap = layered_scene(request.param)
    sil = cap.pop("out").silhouette
    assert float((sil > 0.99).double().mean()) > 0.8 and float((1.0 - sil).min()) < 2e-4
    return cap


@pytest.fixture(scope="module")
def backward(scene):
    """Every side's gradient from plain64's cotangent: only the backward's
    arithmetic differs."""
    cot = split.plain64_cotangent(scene)
    return cot, {kind: split.program_side(scene, kind, cot)["grads"]
                 for kind in ("plain32", "plain32_exact_t", "plain64")}


def test_the_float64_route_is_the_reference_at_the_programs_camera(scene):
    port = split.program_side(scene, "plain64")["grads"]
    ref = split.reference_side(scene, CONFIG, torch.float64, program_camera=True)["grads"]
    gaps = split.leaf_errors(port, ref)
    assert max(gaps.values()) < 1e-12, gaps


def test_the_float32_backward_is_rounding_mostly_the_t_final_recovery(backward):
    _, grads = backward
    divided = split.leaf_errors(grads["plain32"], grads["plain64"])
    kept = split.leaf_errors(grads["plain32_exact_t"], grads["plain64"])
    assert max(divided.values()) < 3e-4, divided
    for key in ("rel_err_q", "rel_err_t"):
        assert kept[key] * 5.0 < divided[key], (kept, divided)


def test_one_pixel_of_the_mask_outweighs_the_float32_backward(scene, backward):
    """The first masked pixel left out of the loss (as if its silhouette
    had rounded below 0.99) moves the gradient by more than ten times the
    float32 backward's whole error."""
    cot, grads = backward
    depth_cot = cot[1].clone()
    k = int(torch.nonzero(depth_cot.reshape(-1))[0, 0])
    flipped = (cot[0].clone(), depth_cot, cot[2])
    flipped[0].view(3, -1)[:, k] = 0.0
    depth_cot.view(-1)[k] = 0.0
    moved = split.program_side(scene, "plain64", flipped)["grads"]
    one_pixel = split.leaf_errors(moved, grads["plain64"])
    rounding = split.leaf_errors(grads["plain32"], grads["plain64"])
    assert one_pixel["track_grad_gap"] > 10.0 * rounding["track_grad_gap"], (one_pixel,
                                                                             rounding)
