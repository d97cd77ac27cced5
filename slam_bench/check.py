"""What decides `correct`: one more frame of the traffic through the
window's own call, held against the plain reference.

The check frame runs after the window (or the traced frames) through the
same Loop.frame, at the cell's sizes, with run_frame's stage marks taking
snapshots of the program's state: the map tracking starts from and its
starting pose, the pose tracking returns, and the map densification
leaves. The runtime records its phases' per-iteration losses for this
frame (SLAMRuntime.record_hist, which adds no launch to the phases), and
the mapping phase's keyframe draws are read as the runtime makes them.
Then the program's state is freed and the reference (slam_bench/reference/,
which imports nothing of the program) follows from those snapshots:

  track_loss_gap    tracking's first `track_iters` losses: the largest
                    |program - reference| / reference
  track_grad_gap    tracking's first gradient as the optimizer gets it
                    (read from the program's call of optim.adam_step), by
                    leaf (q, t): the largest gap between the program's norm
                    and the reference's, over the reference's norm of that
                    leaf or of the median leaf, whichever is larger
  map_loss_gap      mapping's first `map_iters` losses, as tracking's, on the
                    program's draws of keyframes and the keyframes' poses
  map_grad_gap      mapping's first gradient by leaf (means, colours, logit
                    opacities, log scales), as tracking's
  map_step_gap      the change mapping's first Adam step makes, by leaf, the
                    same way, over the elements whose reference gradient is
                    at least a thousandth of the leaf's median nonzero one
                    (below that, Adam's first step, lr g / |g|, moves an
                    element by round-off alone)
  densify_px_gap    the pixels densification back-projected (the program's,
                    found by projecting its new Gaussians back into the
                    frame) against the reference's choice: the symmetric
                    difference over the image's pixel count
  densify_new_gap   the new Gaussians themselves, at each pixel the program
                    chose:
                    by leaf (means, colours, logit opacities, log scales),
                    the norm of program - reference over the larger of the
                    reference's norm and the square root of the leaf's
                    element count (its RMS, where the reference's is under 1)
  keyframe_mismatch elements of the keyframe store's slots that mapping
                    drew which differ from the frames the benchmark handed
                    over (exact)

The state the reference starts from (the map at the frame's start, the
tracked pose, the keyframes' poses) is the program's own: the reference
follows the program step by step and does not rerun the whole sequence.
From there it densifies by itself: its own choice of pixels, compared
with the program's, and its own Gaussians, made at the pixels the program
chose (so that a pixel on which the two sides' silhouettes round apart
at the threshold moves only densify_px_gap); its mapping starts from that
densified map.
"""
from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from slam_bench.loop import Loop
from slam_bench.reference import follow, render
from slam_bench.reference.loss import LossConfig

NUMBERS = ("track_loss_gap", "track_grad_gap", "map_loss_gap", "map_grad_gap", "map_step_gap",
           "densify_px_gap", "densify_new_gap", "keyframe_mismatch")
LEAVES = ("means", "colors", "logit_opacities", "log_scales")


def _snapshot(gm) -> dict:
    span = gm.span()
    return {"means": gm.means3d[:span].detach().clone(),
            "colors": gm.rgb_colors[:span].detach().clone(),
            "logit_opacities": gm.logit_opacities[:span].detach().clone(),
            "log_scales": gm.log_scales[:span].detach().clone(),
            "active": gm.active[:span].clone()}


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions in full float32 (tf32 False), or in
    TF32 (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Observed:
    """The program's side of a check frame."""

    def __init__(self, loop: Loop, i: int, follow_cfg: dict):
        rt = loop.rt
        if i == 0:
            raise ValueError("a check frame has to track: not the first frame")
        self.i, self.snaps, self.draws = i, {}, None
        self.first = {}  # phase -> the first optimizer step's gradients and change
        n_map = int(follow_cfg["map_iters"])
        make_inputs = rt._mapping_inputs
        phase = [None]
        from splatam_tpu_torch.slam import optim

        adam_step = optim.adam_step

        def observed_step(state, params, grads, lrs, eps):
            new, new_state = adam_step(state, params, grads, lrs, eps)
            if phase[0] is not None and phase[0] not in self.first:
                self.first[phase[0]] = {
                    "grads": [g.detach().clone() for g in grads],
                    "step": [(a - b).detach() for a, b in zip(new, params)]}
            return new, new_state

        def mapping_inputs(time_idx, selected, num_iters):
            out = make_inputs(time_idx, selected, num_iters)
            slots, qs, ts = out[0], out[1], out[2]
            self.draws = [(int(slots[j]), qs[j].detach().clone(), ts[j].detach().clone())
                          for j in range(min(n_map, num_iters))]
            return out

        def mark(stage: str) -> None:
            phase[0] = {"compact": "track", "stage_kf": "map"}.get(stage)
            if stage == "compact":
                self.snaps["m0"] = _snapshot(rt.gm)
                self.snaps["pose0"] = (rt.cam_rots[i].copy(), rt.cam_trans[i].copy())
            elif stage == "track":
                self.snaps["tracked"] = (rt.cam_rots[i].copy(), rt.cam_trans[i].copy())
            elif stage == "densify":
                self.snaps["m1"] = _snapshot(rt.gm)

        rt.record_hist = True
        rt._mapping_inputs = mapping_inputs
        optim.adam_step = observed_step
        try:
            loop.frame(i, mark)
        finally:
            optim.adam_step = adam_step
            del rt._mapping_inputs
            rt.record_hist = False
        self.track_losses = [float(x) for x in rt.tracking_hist[:, 0]]
        self.map_losses = [float(x) for x in rt.mapping_hist[:, 0]]
        slot_frame = {kf["slot"]: kf["id"] for kf in rt.keyframe_list}
        slot_frame[rt.kf_scratch_slot] = i
        self.draw_frames = [slot_frame[s] for s, _, _ in self.draws]
        stream = loop.stream
        self.keyframe_mismatch = 0
        for slot, frame_id in zip([s for s, _, _ in self.draws], self.draw_frames):
            color, depth, _, _ = stream[frame_id]
            want_c = torch.as_tensor(color.astype(np.uint8), device=loop.device)
            want_d = torch.as_tensor(depth[..., 0], device=loop.device)
            self.keyframe_mismatch += int((rt.kf_colors[slot] != want_c).sum())
            self.keyframe_mismatch += int((rt.kf_depths[slot] != want_d).sum())


def _gap(program: list[float], ref: list[float]) -> float:
    if len(program) < len(ref):
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, ref))


def _leaf_gap(program: list, ref: list) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    if len(program) != len(ref):
        return float("inf")
    pn = [float(torch.linalg.vector_norm(p.double())) for p in program]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in ref]
    med = sorted(rn)[(len(rn) - 1) // 2]
    return max(abs(a - b) / max(b, med, 1e-30) for a, b in zip(pn, rn))


def _step_gap(program: list, ref: list, ref_grads: list) -> float:
    """_leaf_gap of the first step's change, each leaf over the elements
    whose reference gradient is not nought to rounding. Where densification
    made a different number of Gaussians on the two sides, the shorter
    leaf is padded with zeros, and every slot that only the program has
    counts."""
    if len(program) != len(ref):
        return float("inf")
    ps, rs = [], []
    for p, r, g in zip(program, ref, ref_grads):
        mag = g.abs()
        nonzero = mag[mag > 0]
        floor = 1e-3 * float(nonzero.median()) if nonzero.numel() else 0.0
        keep = mag > floor
        n = max(p.shape[0], r.shape[0])
        p, r, keep = _pad(p, n, 0), _pad(r, n, 0), _pad(keep, n, True)
        ps.append(p[keep])
        rs.append(r[keep])
    return _leaf_gap(ps, rs)


def _pad(x: torch.Tensor, n: int, value) -> torch.Tensor:
    if x.shape[0] >= n:
        return x
    return torch.cat([x, torch.full((n - x.shape[0], *x.shape[1:]), value, dtype=x.dtype,
                                    device=x.device)])


def _program_new(m0: dict, m1: dict, tracked, k: render.Intrinsics) -> dict:
    """The program's new Gaussians (the slots active after densification
    and not before): {"pixels": [H, W] bool, the pixels they were made from,
    found by projecting them back through the tracked pose, a Gaussian off
    the image flipping pixel (0, 0); "made": the same without that flip;
    "row": [H * W] the new Gaussian of each pixel; "new": their leaves}."""
    n0 = m0["active"].shape[0]
    new = m1["active"].clone()
    new[:n0] &= ~m0["active"]
    pts = m1["means"][new].double()
    q, t = (torch.as_tensor(v, dtype=torch.float64, device=pts.device) for v in tracked)
    cam = pts @ render.quat_to_rot(q).T + t
    u = torch.round(k.fx * cam[:, 0] / cam[:, 2] + k.cx).long()
    v = torch.round(k.fy * cam[:, 1] / cam[:, 2] + k.cy).long()
    img = torch.zeros((k.height, k.width), dtype=torch.bool, device=pts.device)
    row = torch.full((k.height * k.width,), -1, dtype=torch.long, device=pts.device)
    ok = (u >= 0) & (u < k.width) & (v >= 0) & (v < k.height)
    img[v[ok], u[ok]] = True
    row[v[ok] * k.width + u[ok]] = torch.nonzero(ok)[:, 0]
    made = img.clone()
    if int((~ok).sum()):
        img[0, 0] = ~img[0, 0]  # a new Gaussian off the image counts as a wrong pixel
    return {"pixels": img, "made": made, "row": row,
            "new": {n: m1[n][new] for n in LEAVES}}


def _reference_new(densified: dict) -> dict:
    """_program_new's form of follow.densify's result (rows in row-major
    order of the pixels they were made at)."""
    flat = densified["made_at"].reshape(-1)
    row = torch.cumsum(flat.long(), 0) - 1
    return {"pixels": densified["pixels"], "made": densified["made_at"],
            "row": torch.where(flat, row, -1), "new": densified["new"]}


def _new_gap(program: dict, ref: dict) -> float:
    """densify_new_gap over the pixels at which both sides made one."""
    both = (program["made"].reshape(-1) & ref["made"].reshape(-1)
            & (program["row"] >= 0) & (ref["row"] >= 0))
    if not int(both.sum()):
        return 0.0
    worst = 0.0
    for n in LEAVES:
        p = program["new"][n][program["row"][both]].double()
        r = ref["new"][n][ref["row"][both]].double()
        scale = max(float(torch.linalg.vector_norm(r)), float(r.numel()) ** 0.5)
        worst = max(worst, float(torch.linalg.vector_norm(p - r)) / scale)
    return worst


def intrinsics(config: dict) -> render.Intrinsics:
    cam = config["camera"]
    return render.Intrinsics(cam["width"], cam["height"], cam["fx"], cam["fy"], cam["cx"],
                             cam["cy"])


class Reference:
    """The reference's readings of one observed check frame."""

    def __init__(self, obs: Observed, loop_config: dict, stream, device, follow_cfg: dict,
                 made_at: torch.Tensor | None = None, tf32: bool = False):
        exp = loop_config["experiment"]
        k = intrinsics(loop_config)
        rebin = int(exp.get("tpu", {}).get("rebin_every", 1))

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)

        color, depth = stream.frame_tensors(obs.i, device)
        m0 = obs.snaps["m0"]
        with precision(tf32):
            tr = exp["tracking"]
            self.track = follow.track(
                m0, *(f32(v) for v in obs.snaps["pose0"]), color, depth, k,
                LossConfig.from_section(tr),
                (float(tr["lrs"]["cam_unnorm_rots"]), float(tr["lrs"]["cam_trans"])), rebin,
                int(follow_cfg["track_iters"]))
            mp = exp["mapping"]
            self.densified = follow.densify(m0, *(f32(v) for v in obs.snaps["tracked"]),
                                            color, depth, k, float(mp["sil_thres"]), made_at)
            draws = []
            for (_, q, t), frame_id in zip(obs.draws, obs.draw_frames):
                c, d = stream.frame_tensors(frame_id, device)
                draws.append((q, t, c, d, frame_id))
            radius = float(stream[0][1].max()) / float(exp["scene_radius_depth_ratio"])
            prune = mp["pruning_dict"] if mp.get("prune_gaussians") else None
            self.map = follow.mapping(self.densified["map"], draws, k, LossConfig.from_section(mp),
                                      mp["lrs"], prune, radius, rebin)
        self.k = k

    def readings(self, obs: Observed, program_new: dict) -> dict:
        return compare(obs.track_losses, obs.map_losses, obs.first, program_new,
                       float(obs.keyframe_mismatch), self)


def compare(track_losses, map_losses, first: dict, new: dict, keyframe_mismatch: float,
            ref: Reference) -> dict:
    """Every number compared, of one side (the program, or the control in
    its place) against the reference."""
    missing = {"grads": [], "step": []}
    tr, mp = first.get("track", missing), first.get("map", missing)
    return {"track_loss_gap": _gap(track_losses, ref.track["losses"]),
            "track_grad_gap": _leaf_gap(tr["grads"], ref.track["grads"]),
            "map_loss_gap": _gap(map_losses, ref.map["losses"]),
            "map_grad_gap": _leaf_gap(mp["grads"], ref.map["grads"]),
            "map_step_gap": _step_gap(mp["step"], ref.map["step"], ref.map["grads"]),
            "densify_px_gap": float((new["pixels"] ^ ref.densified["pixels"]).sum())
            / (ref.k.width * ref.k.height),
            "densify_new_gap": _new_gap(new, _reference_new(ref.densified)),
            "keyframe_mismatch": keyframe_mismatch}


def check(loop: Loop, i: int, follow_cfg: dict):
    """Run check frame i; returns (the readings of every number, the
    program's side, the reference's side). Frees the program's runtime
    before the reference runs."""
    obs = Observed(loop, i, follow_cfg)
    stream, device, config = loop.stream, loop.device, loop.config
    loop.rt = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    program_new = _program_new(obs.snaps["m0"], obs.snaps["m1"], obs.snaps["tracked"],
                               intrinsics(config))
    del obs.snaps["m1"]
    ref = Reference(obs, config, stream, device, follow_cfg, made_at=program_new["made"])
    return ref.readings(obs, program_new), obs, ref


def control_readings(obs: Observed, loop_config: dict, stream, device, follow_cfg: dict) -> dict:
    """The control: the reference in TF32, put in the program's place and
    judged by the same numbers against the float32 reference, which makes
    its Gaussians at the pixels the control chose, as it does at the
    program's."""
    ctl = Reference(obs, loop_config, stream, device, follow_cfg, tf32=True)
    judge = Reference(obs, loop_config, stream, device, follow_cfg,
                      made_at=ctl.densified["pixels"])
    first = {"track": ctl.track, "map": ctl.map}
    return compare(ctl.track["losses"], ctl.map["losses"], first,
                   _reference_new(ctl.densified), 0.0, judge)
