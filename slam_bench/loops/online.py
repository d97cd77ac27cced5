"""The online SLAM loop under the loop contract (slam_bench/spec.py): one
sensor frame a unit, SLAMRuntime through prepare_frame and run_frame
(slam_bench/loop.py); its check, one more frame held against the plain
reference (slam_bench/check.py); the faults that check has to catch; and
the control, the reference in TF32 in the program's place. A
configuration that names no loop runs this one.
"""
from __future__ import annotations

import contextlib

from slam_bench import check as frame_check
from slam_bench import loop as frame_loop
from slam_bench import spec, traffic

NUMBERS = frame_check.NUMBERS
FAULTS = ("state_unchanged", "half_batch", "answer_altered", "densify_altered")


def make_inputs(cell, seed: int, n_units: int, device):
    """The trajectory of n_units frames and the frames, ray-cast on the
    device from the seed: (traffic.Plan, traffic.Frames)."""
    plan = traffic.Plan(cell.traffic, seed, n_units)
    return plan, traffic.make_frames(plan, cell.config["camera"], cell.config["sensor"],
                                     cell.config["scene"], seed, device)


class Loop(frame_loop.Loop):
    """slam_bench/loop.py's Loop, built from make_inputs' (plan, frames)."""

    def __init__(self, config: dict, inputs, device, workdir: str):
        super().__init__(config, *inputs, device, workdir)


def check(loop: Loop, i: int, follow: dict) -> spec.Judged:
    """Run check frame i and judge it (slam_bench/check.py): the readings,
    tracking's and mapping's losses on both sides as one line and as
    extras with tracking's first gradient and step by leaf, and the
    program's side as the state control_readings starts from."""
    readings, obs, ref = frame_check.check(loop, i, follow)
    losses = {"track": [obs.track_losses[:len(ref.track["losses"])], ref.track["losses"]],
              "map": [obs.map_losses[:len(ref.map["losses"])], ref.map["losses"]]}
    first = obs.first.get("track", {})
    extras = {"losses": losses,
              "track_grad": [[v.tolist() for v in first.get("grads", [])],
                             [v.tolist() for v in ref.track["grads"]]],
              "track_step": [[v.tolist() for v in first.get("step", [])],
                             [v.tolist() for v in ref.track["step"]]]}
    line = (f"tracking's losses {losses['track'][0]} against {losses['track'][1]}, "
            f"mapping's {losses['map'][0]} against {losses['map'][1]}")
    return spec.Judged(readings, line, extras, obs)


def control_readings(loop: Loop, judged: spec.Judged, follow: dict) -> dict:
    """The TF32 control on the check frame that judged (check's return) is of."""
    return frame_check.control_readings(judged.state, loop.config, loop.stream, loop.device,
                                        follow)


@contextlib.contextmanager
def planted(fault: str):
    """The program with one fault planted, for the duration: every optimizer
    step returning its state unchanged, the loss over half of the frame (its
    bottom half's depth left out), every render's colour altered by 1% where
    the render is made, or densification's new Gaussians placed 1% too deep
    along their rays where they are made."""
    from splatam_tpu_torch.render import api
    from splatam_tpu_torch.slam import optim, steps

    if fault == "state_unchanged":
        module, name, orig = optim, "adam_step", optim.adam_step

        def broken(state, params, grads, lrs, eps):
            return tuple(params), orig(state, params, grads, lrs, eps)[1]
    elif fault == "half_batch":
        module, name, orig = steps, "get_loss", steps.get_loss

        def broken(gm, q, t, color, depth_gt, cam, *args, **kwargs):
            half = depth_gt.clone()
            half[half.shape[0] // 2:] = 0.0
            return orig(gm, q, t, color, half, cam, *args, **kwargs)
    elif fault == "answer_altered":
        module, name, orig = api, "_public", api._public

        def broken(img, radii, n_pairs):
            out = orig(img, radii, n_pairs)
            return out._replace(im=out.im * 1.01)
    elif fault == "densify_altered":
        module, name, orig = steps, "backproject_pointcloud", steps.backproject_pointcloud

        def broken(color, depth, *args):
            return orig(color, depth * 1.01, *args)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(module, name, broken)
    try:
        yield
    finally:
        setattr(module, name, orig)
