"""The reference's SLAM steps, followed from a state the benchmark
snapshotted: tracking's and mapping's first iterations (render, loss,
gradient, torch.optim.Adam with SplaTAM's settings, mapping's pruning) and
densification: its choice of pixels and the Gaussians it makes of them.

A map here is a dict of float32 tensors over the map's slots: means [N, 3],
colors [N, 3], logit_opacities [N], log_scales [N, 1] and active [N] bool.
A pose is (q wxyz [4], t [3]), world to camera. Pair structures follow the
configuration's tpu.rebin_every: 1 bins every render anew; above 1 a
tracking structure is binned at the pose of every rebin_every-th iteration
and reused between them, and mapping bins each keyframe once from the
phase's starting map.
"""
from __future__ import annotations

import torch

from slam_bench.reference import render
from slam_bench.reference.loss import LossConfig, loss_and_cotangent


def _opacity(logit: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    return torch.where(active, torch.sigmoid(logit), torch.zeros_like(logit))


def _rows(bins: render.Bins, means, s2, opacity, colors, rot, trans, k: render.Intrinsics):
    """The pairs' (xy, conic, opacity, [r, g, b, z, z^2]) for render.composite."""
    def rows(pidx):
        g = bins.pair_gauss[pidx]
        s = render.project(means[g], s2[g], opacity[g], rot, trans, k)
        return s.xy, s.conic, s.opacity, torch.cat(
            [colors[g], s.depth[..., None], (s.depth * s.depth)[..., None]], dim=-1)
    return rows


def bin_map(m: dict, q: torch.Tensor, t: torch.Tensor, k: render.Intrinsics) -> render.Bins:
    with torch.no_grad():
        s2 = torch.exp(m["log_scales"][:, 0]) ** 2
        s = render.project(m["means"], s2, torch.sigmoid(m["logit_opacities"]),
                           render.quat_to_rot(q), t, k)
        return render.build_bins(s, m["active"], k)


def render_map(m: dict, q, t, k: render.Intrinsics, bins: render.Bins | None = None):
    """(image [6, H, W], bins, contributing evaluations) of the map at (q, t)."""
    bins = bin_map(m, q, t, k) if bins is None else bins
    s2 = torch.exp(m["log_scales"][:, 0]) ** 2
    rows = _rows(bins, m["means"], s2, _opacity(m["logit_opacities"], m["active"]),
                 m["colors"], render.quat_to_rot(q), t, k)
    img, n = render.composite(bins, rows, k, 5)
    return img, bins, n


def track(m: dict, q0, t0, color, depth, k: render.Intrinsics, cfg: LossConfig,
          lrs: tuple[float, float], rebin_every: int, iters: int) -> list[float]:
    """Tracking's first `iters` iterations from pose (q0, t0) with Adam (eps
    1e-8, the reference's tracking optimizer): {"losses": each iteration's
    loss before its step, "grads": the first iteration's gradients (q, t),
    "step": the first step's change of (q, t)}."""
    q = q0.detach().clone().requires_grad_(True)
    t = t0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([{"params": [q], "lr": lrs[0]}, {"params": [t], "lr": lrs[1]}],
                           eps=1e-8, foreach=False)
    s2 = torch.exp(m["log_scales"][:, 0]) ** 2
    op = _opacity(m["logit_opacities"], m["active"])
    losses, bins, first = [], None, {}
    for it in range(iters):
        if it % max(rebin_every, 1) == 0:
            bins = bin_map(m, q.detach(), t.detach(), k)
        img, _ = render.composite(bins, _rows(bins, m["means"], s2, op, m["colors"],
                                              render.quat_to_rot(q.detach()), t.detach(), k),
                                  k, 5)
        value, gimg = loss_and_cotangent(img, color, depth, cfg, tracking=True)
        losses.append(value)
        opt.zero_grad()
        with torch.enable_grad():
            render.backprop(bins, _rows(bins, m["means"], s2, op, m["colors"],
                                        render.quat_to_rot(q), t, k), k, gimg)
        before = (q.detach().clone(), t.detach().clone())
        if it == 0:
            first["grads"] = [q.grad.clone(), t.grad.clone()]
        opt.step()
        if it == 0:
            first["step"] = [q.detach() - before[0], t.detach() - before[1]]
    return {"losses": losses, **first}


def mapping(m: dict, draws: list, k: render.Intrinsics, cfg: LossConfig, lrs: dict,
            prune: dict | None, scene_radius: float, rebin_every: int) -> list[float]:
    """Mapping's iterations over `draws` with Adam (eps 1e-15, the
    reference's mapping optimizer): {"losses": each iteration's loss before
    its step, "grads": the first iteration's gradients (means, colours,
    logit opacities, log scales), "step": the first step's change of them}.
    A draw is
    (q, t, color [3, H, W], depth [H, W], structure key): iterations of one
    key share the structure binned at the phase's start when rebin_every
    > 1. Pruning (mapping.pruning_dict) runs after each iteration's
    gradient and before its step, on the parameters the step starts from."""
    p = {name: m[name].detach().clone().requires_grad_(True)
         for name in ("means", "colors", "logit_opacities", "log_scales")}
    active = m["active"].clone()
    opt = torch.optim.Adam([{"params": [p["means"]], "lr": lrs["means3D"]},
                            {"params": [p["colors"]], "lr": lrs["rgb_colors"]},
                            {"params": [p["logit_opacities"]], "lr": lrs["logit_opacities"]},
                            {"params": [p["log_scales"]], "lr": lrs["log_scales"]}],
                           eps=1e-15, foreach=False)
    start = {**{n: v.detach() for n, v in p.items()}, "active": active.clone()}
    structures: dict = {}
    losses, first = [], {}
    for it, (q, t, color, depth, key) in enumerate(draws):
        if rebin_every > 1:
            if key not in structures:
                structures[key] = bin_map(start, q, t, k)
            bins = structures[key]
        else:
            bins = bin_map({**{n: v.detach() for n, v in p.items()}, "active": active}, q, t, k)
        rot = render.quat_to_rot(q)

        def rows_of(params, bins=bins, rot=rot, t=t):
            s2 = torch.exp(params["log_scales"][:, 0]) ** 2
            return _rows(bins, params["means"], s2,
                         _opacity(params["logit_opacities"], active), params["colors"],
                         rot, t, k)

        img, _ = render.composite(bins, rows_of({n: v.detach() for n, v in p.items()}), k, 5)
        value, gimg = loss_and_cotangent(img, color, depth, cfg, tracking=False)
        losses.append(value)
        opt.zero_grad()
        for v in p.values():
            v.grad = torch.zeros_like(v)
        with torch.enable_grad():
            render.backprop(bins, rows_of(p), k, gimg)
        if prune is not None and _prune_due(prune, it):
            with torch.no_grad():
                thr = (prune["final_removal_opacity_threshold"] if it == prune["stop_after"]
                       else prune["removal_opacity_threshold"])
                remove = torch.sigmoid(p["logit_opacities"]) < thr
                if it >= prune["remove_big_after"]:
                    remove |= torch.exp(p["log_scales"]).max(dim=1).values > 0.1 * scene_radius
                active &= ~remove
        before = [v.detach().clone() for v in p.values()]
        if it == 0:
            first["grads"] = [v.grad.clone() for v in p.values()]
        opt.step()
        if it == 0:
            first["step"] = [v.detach() - b for v, b in zip(p.values(), before)]
    return {"losses": losses, **first, "params": {n: v.detach() for n, v in p.items()},
            "active": active}


def _prune_due(prune: dict, it: int) -> bool:
    return prune["start_after"] <= it <= prune["stop_after"] and it % prune["prune_every"] == 0


def densify(m: dict, q, t, color, depth, k: render.Intrinsics, sil_thres: float,
            made_at: torch.Tensor | None = None) -> dict:
    """Densification (upstream add_new_gaussians, get_pointcloud and
    initialize_new_params with the projective mean_sq_dist): the pixels it
    back-projects are valid depth where the render's silhouette is below
    sil_thres, or where the render lies behind the observed depth by more
    than 50 times the median depth error. Each becomes a Gaussian at its
    pixel centre's depth along the ray in the world frame (through the
    inverse of the world-to-camera pose (q, t)), with the pixel's colour,
    logit opacity 0 and log scale log(depth / mean focal length). The
    Gaussians are made at `made_at` ([H, W] bool) where it is given, else at
    the pixels chosen here. Returns {"pixels": the pixels chosen here,
    "made_at": where the new Gaussians were made, "new": their leaves in
    row-major pixel order, "map": the map with them written into its
    lowest free slots}."""
    with torch.no_grad():
        img, _, _ = render_map(m, q, t, k)
        valid = depth > 0
        err = torch.abs(depth - img[3]) * valid
        med = torch.sort(err.reshape(-1)).values[(err.numel() - 1) // 2]
        pixels = ((img[5] < sil_thres) | ((img[3] > depth) & (err > 50.0 * med))) & valid
        made_at = pixels if made_at is None else made_at
        w2c = torch.eye(4, dtype=torch.float32, device=depth.device)
        w2c[:3, :3], w2c[:3, 3] = render.quat_to_rot(q), t
        ys, xs = torch.meshgrid(torch.arange(k.height, device=depth.device),
                                torch.arange(k.width, device=depth.device), indexing="ij")
        sel = made_at.reshape(-1)
        z = depth.reshape(-1)[sel]
        x = (xs.reshape(-1)[sel].to(torch.float32) - k.cx) / k.fx * z
        y = (ys.reshape(-1)[sel].to(torch.float32) - k.cy) / k.fy * z
        pts4 = torch.stack([x, y, z, torch.ones_like(z)], dim=-1)
        means = (torch.linalg.inv(w2c) @ pts4.T).T[:, :3]
        new = {"means": means, "colors": color.reshape(3, -1).T[sel],
               "logit_opacities": torch.zeros_like(z),
               "log_scales": torch.log(z / ((k.fx + k.fy) / 2.0))[:, None]}
        grown = {n: v.clone() for n, v in m.items()}
        free = torch.nonzero(~grown["active"])[:, 0]
        short = z.numel() - free.numel()
        if short > 0:
            for n, v in grown.items():
                grown[n] = torch.cat([v, torch.zeros((short, *v.shape[1:]), dtype=v.dtype,
                                                     device=v.device)])
            free = torch.nonzero(~grown["active"])[:, 0]
        dest = free[:z.numel()]
        for n, v in new.items():
            grown[n][dest] = v
        grown["active"][dest] = True
    return {"pixels": pixels, "made_at": made_at, "new": new, "map": grown}
