"""The generic route's first tracking gradient, split: (q, t) of one check
frame taken several ways and held against the plain reference
(slam_bench/reference/), to say which stage moves `track_grad_gap`.

    python -m splatam_tpu_torch.scripts.track_grad_split --seeds 7 8 \\
        [--workload tum.fr1_desk] [--after 9] [--device cpu]

For each seed: the cell's frames and set-up as slam_bench.run makes them,
--after more frames, then the check frame, whose tracking inputs (the map
view, the starting pose, the frame) are kept as its tracking starts. Then
the first gradient (q, t), as optim.adam_step gets it, is taken
  with each side's own render, loss mask and cotangent ("chain"):
    kernels    the program as it runs: K1, K2, K3 and, on the card, the
               loss kernel (on the CPU, the plain versions)
    plain32    the kernels' plain versions and the loss as PyTorch ops,
               float32
    plain64    the same in float64
    ref32      slam_bench's reference, which track_grad_gap compares with
    ref64      the reference in float64
    ref64_cam  the same at the program's own (float32) intrinsics
  and with plain64's cotangent and mask given to every side, so that only
  the backward's arithmetic differs ("backward"): kernels, plain32,
  plain32_exact_t (the plain backward handed T_final itself, not
  1 - the float32 silhouette), plain64.
Prints one JSON line per seed: every gradient, the gaps between the sides
(track_grad_gap's measure, |norm(a) - norm(b)| / norm(b) of the worse leaf,
and each leaf's ||a - b|| / ||b||), and the pixels whose loss mask, depth
residual's sign or colour residuals' signs differ between the renders. Exits 2 without a CUDA device
unless --device cpu.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import sys
import tempfile

import numpy as np
import torch

BACKWARD = ("kernels", "plain32", "plain32_exact_t", "plain64")
PAIRS = (("kernels", "ref32"), ("plain32", "ref32"), ("plain64", "ref64"),
         ("plain64", "ref64_cam"), ("ref32", "ref64"), ("kernels", "plain64"),
         ("plain32", "plain64"), ("kernels", "plain32"), ("plain64", "ref32"))


@contextlib.contextmanager
def plain_route(exact_t: bool = False):
    """The generic render on the kernels' plain versions, whatever the
    device, and get_loss's loss as PyTorch ops; with exact_t the backward
    gets the forward's T_final itself."""
    from splatam_tpu_torch.core import fused_loss
    from splatam_tpu_torch.render import composite

    saved = {n: getattr(composite, n) for n in
             ("composite_forward", "composite_backward", "segment_reduce")}
    saved_loss = fused_loss.fused_loss
    kept = {}

    def forward(attrs, pair_gauss, tile_start, width, height):
        t_out = torch.empty((height, width), dtype=attrs.dtype, device=attrs.device)
        out = composite.composite_forward_plain(attrs, pair_gauss, tile_start, width, height,
                                                t_out=t_out)
        kept[out.data_ptr()] = t_out
        return out

    def backward(attrs, pair_gauss, tile_start, width, height, state, g):
        t_final = kept.pop(state.data_ptr()) if exact_t else None
        return composite.composite_backward_plain(attrs, pair_gauss, tile_start, width, height,
                                                  state, g, t_final=t_final)

    composite.composite_forward = forward
    composite.composite_backward = backward
    composite.segment_reduce = composite.segment_reduce_plain
    fused_loss.fused_loss = fused_loss.loss_composition
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(composite, n, f)
        fused_loss.fused_loss = saved_loss


def capture_tracking(loop, i: int) -> dict:
    """Run frame i; returns the arguments of its first tracking_phase call
    (the map view, the starting pose, the frame, the camera, the loss
    configuration and the binning options), copied as tracking starts."""
    from splatam_tpu_torch.core.gaussians import GaussianMap
    from splatam_tpu_torch.slam import steps

    orig = steps.tracking_phase
    sig = inspect.signature(orig)
    got = {}

    def spy(*args, **kwargs):
        if not got:
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            a = a.arguments
            got.update(gm=GaussianMap(*(x.detach().clone() for x in a["gm"])),
                       q=a["q0"].detach().clone(), t=a["t0"].detach().clone(),
                       color=a["color"].clone(), depth=a["depth_gt"].clone(), cam=a["cam"],
                       pcfg=a["pcfg"], bin_opts=a["bin_opts"], lrs=(a["lr_q"], a["lr_t"]))
        return orig(*args, **kwargs)

    steps.tracking_phase = spy
    try:
        loop.frame(i)
    finally:
        steps.tracking_phase = orig
    if not got:
        raise RuntimeError(f"frame {i} did not track")
    return got


def _cast(cap: dict, dtype):
    from splatam_tpu_torch.core.gaussians import GaussianMap

    gm = GaussianMap(*(x.to(dtype) if x.is_floating_point() else x for x in cap["gm"]))
    return gm, cap["q"].to(dtype), cap["t"].to(dtype), cap["color"].to(dtype), \
        cap["depth"].to(dtype)


@contextlib.contextmanager
def camera_in(dtype):
    """Cameras hand the projection their view matrix in dtype."""
    from splatam_tpu_torch.core.camera import Camera

    w2c = Camera.w2c_tensor
    Camera.w2c_tensor = lambda self, device: w2c(self, device).to(dtype)
    try:
        yield
    finally:
        Camera.w2c_tensor = w2c


def program_side(cap: dict, kind: str, cot=None) -> dict:
    """(q, t) gradient of the program's first tracking iteration on the
    side `kind` (kernels, plain32, plain32_exact_t, plain64), and its
    render's (im, depth, silhouette) in float64. cot: the cotangent of
    (im, depth, depth_sq) to push back in place of the side's own loss."""
    from splatam_tpu_torch.slam import steps

    dtype = torch.float64 if kind == "plain64" else torch.float32
    gm, q0, t0, color, depth = _cast(cap, dtype)
    route = (contextlib.nullcontext() if kind == "kernels"
             else plain_route(exact_t=kind == "plain32_exact_t"))
    q = q0.clone().requires_grad_(True)
    t = t0.clone().requires_grad_(True)
    with route, camera_in(dtype):
        if cot is None:
            loss, _ = steps.get_loss(gm, q, t, color, depth, cap["cam"], cap["pcfg"], True,
                                     False, None, bin_opts=cap["bin_opts"])
            grads = torch.autograd.grad(loss, (q, t))
        else:
            out = steps.loss_render(gm, q, t, cap["cam"], True, False, None,
                                    bin_opts=cap["bin_opts"])
            grads = torch.autograd.grad((out.im, out.depth, out.depth_sq), (q, t),
                                        grad_outputs=tuple(c.to(dtype) for c in cot))
        with torch.no_grad():
            out = steps.loss_render(gm, q0, t0, cap["cam"], True, False, None,
                                    bin_opts=cap["bin_opts"])
    return {"grads": [g.detach().double() for g in grads],
            "im": out.im.detach().double(), "depth": out.depth.detach().double(),
            "sil": out.silhouette.detach().double()}


def plain64_cotangent(cap: dict):
    """d loss / d (im, depth, depth_sq) of plain64's render, in float64."""
    from splatam_tpu_torch.core import fused_loss
    from splatam_tpu_torch.slam import steps

    gm, q0, t0, color, depth = _cast(cap, torch.float64)
    with plain_route(), camera_in(torch.float64), torch.no_grad():
        out = steps.loss_render(gm, q0, t0, cap["cam"], True, False, None,
                                bin_opts=cap["bin_opts"])
    leaves = [x.detach().clone().requires_grad_(True) for x in (out.im, out.depth, out.depth_sq)]
    with torch.enable_grad():
        loss, _, _ = fused_loss.loss_composition(leaves[0], leaves[1], leaves[2],
                                                 out.silhouette.detach(), color, depth,
                                                 fused_loss.route(cap["pcfg"], True))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads))


def reference_side(cap: dict, config: dict, dtype, program_camera: bool = False) -> dict:
    """slam_bench's reference from the same inputs, in dtype (float64 as
    the default dtype for the run, so every tensor it makes is float64),
    at the configuration's intrinsics as the check takes them, or with
    program_camera at the program's own (the sensor's float32 intrinsics
    matrix, as the loaders hand it over: fx 517.3 is 517.29998779 there)."""
    from slam_bench.check import intrinsics
    from slam_bench.reference import follow, render
    from slam_bench.reference.loss import LossConfig

    exp = config["experiment"]
    rebin = int(exp.get("tpu", {}).get("rebin_every", 1))
    gm = cap["gm"]
    m0 = {"means": gm.means3d, "colors": gm.rgb_colors, "logit_opacities": gm.logit_opacities,
          "log_scales": gm.log_scales, "active": gm.active}
    m0 = {n: (v.to(dtype) if v.is_floating_point() else v) for n, v in m0.items()}
    cam = cap["cam"]
    k = (render.Intrinsics(cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy)
         if program_camera else intrinsics(config))
    saved = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        got = follow.track(m0, cap["q"].to(dtype), cap["t"].to(dtype), cap["color"].to(dtype),
                           cap["depth"].to(dtype), k,
                           LossConfig.from_section(exp["tracking"]), cap["lrs"], rebin, 1)
        img, _, _ = follow.render_map(m0, cap["q"].to(dtype), cap["t"].to(dtype), k)
    finally:
        torch.set_default_dtype(saved)
    return {"grads": [g.detach().double() for g in got["grads"]], "im": img[:3].double(),
            "depth": img[3].double(), "sil": img[5].double()}


def leaf_errors(a: list, b: list) -> dict:
    from slam_bench.check import _leaf_gap

    rel = [float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))
           for x, y in zip(a, b)]
    return {"track_grad_gap": _leaf_gap(a, b), "rel_err_q": rel[0], "rel_err_t": rel[1]}


def render_flips(a: dict, b: dict, color: torch.Tensor, depth_gt: torch.Tensor,
                 sil_thres: float) -> dict:
    """Pixels whose tracking mask (valid depth and silhouette above the
    threshold) differs between two renders, and pixels (colour values) in
    both masks whose depth (colour) residual changes sign: where the loss's
    cotangent differs."""
    gt = depth_gt.double()
    ma = (gt > 0) & (a["sil"] > sil_thres)
    mb = (gt > 0) & (b["sil"] > sil_thres)
    both = ma & mb
    sign = torch.sign(gt - a["depth"]) != torch.sign(gt - b["depth"])
    color = color.double()
    im_sign = (torch.sign(color - a["im"]) != torch.sign(color - b["im"])) & both[None]
    return {"mask_flips": int((ma ^ mb).sum()), "depth_sign_flips": int((sign & both).sum()),
            "im_sign_flips": int(im_sign.sum()), "mask_pixels": int(mb.sum()),
            "sil_max_abs": float((a["sil"] - b["sil"]).abs().max()),
            "depth_max_abs": float(((a["depth"] - b["depth"]).abs() * both).max())}


def split_one(cap: dict, config: dict) -> dict:
    chain = {kind: program_side(cap, kind) for kind in ("kernels", "plain32", "plain64")}
    chain["ref32"] = reference_side(cap, config, torch.float32)
    chain["ref64"] = reference_side(cap, config, torch.float64)
    chain["ref64_cam"] = reference_side(cap, config, torch.float64, program_camera=True)
    cot = plain64_cotangent(cap)
    backward = {kind: program_side(cap, kind, cot) for kind in BACKWARD}
    sil_thres = float(cap["pcfg"].sil_thres)
    return {
        "chain": {k: [g.tolist() for g in v["grads"]] for k, v in chain.items()},
        "backward": {k: [g.tolist() for g in v["grads"]] for k, v in backward.items()},
        "chain_gaps": {f"{a}-{b}": leaf_errors(chain[a]["grads"], chain[b]["grads"])
                       for a, b in PAIRS},
        "backward_gaps": {f"{k}-plain64": leaf_errors(backward[k]["grads"],
                                                      backward["plain64"]["grads"])
                          for k in BACKWARD[:-1]},
        "flips": {f"{a}-{b}": render_flips(chain[a], chain[b], cap["color"], cap["depth"],
                                           sil_thres) for a, b in PAIRS},
    }


def run_seed(cell, seed: int, after: int, device) -> dict:
    from slam_bench import traffic
    from slam_bench.loop import Loop

    np.random.seed(seed % 2**32)
    torch.manual_seed(seed)
    plan = traffic.Plan(cell.traffic, seed, int(cell.traffic["setup_frames"]) + after + 1)
    frames = traffic.make_frames(plan, cell.config["camera"], cell.config["sensor"],
                                 cell.config["scene"], seed, device)
    with tempfile.TemporaryDirectory(prefix="track_grad_split_") as workdir:
        loop = Loop(cell.config, plan, frames, device, workdir)
        i = plan.n_frames - 1
        for j in range(i):
            loop.frame(j)
        cap = capture_tracking(loop, i)
        loop.rt = None
        out = split_one(cap, cell.config)
    return {"seed": seed, "frame": i, **out}


def main(argv=None, device: str | None = None, root=None) -> int:
    from slam_bench import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="tum.fr1_desk")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--after", type=int, default=9,
                    help="frames run after the set-up frames before the check frame")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    root = spec.ROOT if root is None else root
    cell = spec.Cell(spec.load(root), args.workload, root / "slam_bench")
    if args.device is None and not torch.cuda.is_available():
        print("track_grad_split: no CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 2
    dev = torch.device(args.device or "cuda")
    for seed in args.seeds:
        res = run_seed(cell, seed, args.after, dev)
        for name, gaps in {**res["chain_gaps"],
                           **{f"backward {k}": v for k, v in res["backward_gaps"].items()}
                           }.items():
            print(f"seed {seed} {name}: " + " ".join(f"{k} {v:.3e}" for k, v in gaps.items()),
                  file=sys.stderr)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
