"""What a mapping iteration holds (splatam_tpu_torch/slam/steps.py
mapping_phase), on the CPU at tiny sizes.

- Lifetimes: optim.adam_step, steps.get_loss and steps.accumulate_stats are
  wrapped to keep weak references to each mapping iteration's loss, render
  output, means2d dummy and its gradient, gradients and the parameters
  adam_step returns. At every mapping render none of an earlier
  iteration's is alive (with in_place; without it, the previous step's
  result is the phase's own copy and stays), through mapping_phase itself
  and through SLAMRuntime (the generic route, held structures, in-loop
  3DGS), where mapping_phase.totals counts every phase as in_place.
- In place against a copy: the phase that owns its leaves gives the same
  leaves, active mask, per-iteration losses, Adam state and 3DGS
  statistics bit for bit as the one that does not, writes them into the
  tensors it was handed, and the one that does not leaves its input map
  bit-unchanged.
- The benchmark's reader of the counter (slam_bench/metrics/map_gaussians.py):
  the Gaussians over the phases, and None where the program keeps no such
  counter or ran no phase.
"""
import copy
import os
import weakref

import numpy as np
import pytest
import torch

from slam_bench import spec
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.slam import optim, steps
from splatam_tpu_torch.slam.config import load_experiment_config, seed_everything
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame

torch.set_num_threads(1)  # see tests/test_torch_slam.py

H, W = 40, 32
CAM = Camera(height=H, width=W, fx=30.0, fy=30.0, cx=16.0, cy=H / 2.0)
MAP = steps.PhaseConfig(use_sil_for_loss=False, sil_thres=0.5, use_l1=True,
                        ignore_outlier_depth_loss=False, w_im=0.5, w_depth=1.0)
LRS = (1e-4, 2.5e-3, 1e-3, 5e-2, 1e-3)
ITERS = 5
CONFIG_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "synthetic", "splatam.py")


def _map(n=192, seed=0, iso=True, capacity=256) -> GaussianMap:
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(1.5, 4, n)], -1)
    f = dict(means3d=means, rgb_colors=rng.uniform(0, 1, (n, 3)),
             unnorm_rotations=rng.normal(size=(n, 4)),
             logit_opacities=rng.normal(-1.0, 2.0, (n,)),
             log_scales=np.log(rng.uniform(0.03, 0.1, (n, 1 if iso else 3))))
    f = {k: torch.tensor(np.concatenate([v, np.zeros((capacity - n,) + v.shape[1:])]),
                         dtype=torch.float32) for k, v in f.items()}
    f["unnorm_rotations"][n:, 0] = 1.0
    f["active"] = torch.arange(capacity) < n
    return GaussianMap(**f)


def _frame(seed=1):
    rng = np.random.default_rng(seed)
    color = torch.tensor(rng.uniform(0, 255, (2, H, W, 3)).astype(np.uint8))
    depth = torch.tensor(rng.uniform(1.0, 4.0, (2, H, W)).astype(np.float32))
    return color, depth


def _phase(gm, iso=True, prune=False, stats=False, reuse=False, reset=False, resume=False,
           in_place=False):
    color, depth = _frame()
    qs = torch.tensor([[1.0, 0.0, 0.0, 0.0], [1.0, 0.02, -0.01, 0.0]])
    ts = torch.tensor([[0.0, 0.0, 0.0], [0.03, -0.02, 0.01]])
    pick = [0, 1, 1, 0, 1][:ITERS]
    prune_cfg = (steps.PruneConfig(enabled=True, prune_every=2, stop_after=10,
                                   removal_opacity_threshold=0.2, reset_opacities=reset,
                                   reset_opacities_every=3)
                 if prune else steps.PruneConfig(enabled=False))
    opt_state = gsvars = None
    if resume:  # a later 3DGS chunk: moments and statistics carried in
        n = gm.capacity
        gen = torch.Generator().manual_seed(5)
        shapes = [(n, 3), (n, 3)] + ([] if iso else [(n, 4)]) + [(n,), (n, 1 if iso else 3)]
        opt_state = optim.AdamState(m=tuple(1e-3 * torch.randn(s, generator=gen) for s in shapes),
                                    v=tuple(1e-6 * torch.rand(s, generator=gen) for s in shapes),
                                    step=4)
        gsvars = (torch.rand(n, generator=gen), torch.ones(n), torch.rand(n, generator=gen))
    return steps.mapping_phase(
        gm, color, depth, pick, qs[pick], ts[pick], 2.0, CAM, ITERS, MAP, prune_cfg, LRS,
        struct_qs=qs if reuse else None, struct_ts=ts if reuse else None,
        iter_struct_idx=pick if reuse else None, record_hist=True, opt_state=opt_state,
        gsvars=gsvars, start_iter=2 if resume else 0, track_stats=stats, in_place=in_place)


def _clone(gm: GaussianMap) -> GaussianMap:
    return GaussianMap(*(a.clone() for a in gm))


class Watch:
    """Weak references to every mapping iteration's tensors; at each
    mapping render, asserts that none of an earlier iteration's is alive
    (but for the previous step's result where the phase does not own its
    leaves)."""

    def __init__(self, monkeypatch, own: bool):
        self.own, self.earlier, self.current, self.renders = own, [], [], 0
        self.last_step = []
        get_loss, adam_step, accumulate = steps.get_loss, optim.adam_step, steps.accumulate_stats
        self.mapping = False

        def watched_loss(*args, **kwargs):
            self.mapping = bool(args[8])
            if self.mapping:
                self.check()
                self.renders += 1
            loss, aux = get_loss(*args, **kwargs)
            if self.mapping:
                dummy = kwargs.get("means2d_dummy")
                self.current += [weakref.ref(loss), weakref.ref(aux.silhouette),
                                 weakref.ref(aux.radii)]
                self.current += [weakref.ref(dummy)] if dummy is not None else []
            return loss, aux

        def watched_stats(gsvars, d_dummy, radii):
            self.current.append(weakref.ref(d_dummy))
            return accumulate(gsvars, d_dummy, radii)

        def watched_step(state, params, grads, lrs, eps):
            new, new_state = adam_step(state, params, grads, lrs, eps)
            if self.mapping:
                self.current += [weakref.ref(g) for g in grads]
                self.earlier += self.current + self.last_step
                self.current = []
                self.last_step = [weakref.ref(x) for x in new]
            return new, new_state

        monkeypatch.setattr(steps, "get_loss", watched_loss)
        monkeypatch.setattr(steps, "accumulate_stats", watched_stats)
        monkeypatch.setattr(optim, "adam_step", watched_step)

    def check(self) -> None:
        held = self.earlier + (self.last_step if self.own else [])
        alive = sum(r() is not None for r in held)
        assert alive == 0, f"mapping render {self.renders}: {alive} of {len(held)} earlier alive"


LIFETIME = {"generic": {}, "prune, stats": dict(prune=True, stats=True),
            "held structures": dict(reuse=True), "anisotropic": dict(iso=False)}


@pytest.mark.parametrize("in_place", [True, False], ids=["in_place", "copy"])
@pytest.mark.parametrize("case", sorted(LIFETIME))
def test_mapping_iteration_holds_nothing_earlier(monkeypatch, case, in_place):
    kw = LIFETIME[case]
    watch = Watch(monkeypatch, own=in_place)
    _phase(_map(iso=kw.get("iso", True)), in_place=in_place, **kw)
    assert watch.renders == ITERS
    watch.check()


def _config(tmp_path, case: str) -> dict:
    config = copy.deepcopy(load_experiment_config(CONFIG_PATH))
    config["workdir"] = str(tmp_path)
    config["data"].update(desired_image_height=48, desired_image_width=64, num_frames=2)
    config["tracking"]["num_iters"] = 2
    config["mapping"]["num_iters"] = 4
    config["mapping_window_size"] = 5
    config["keyframe_every"] = 2
    config["tpu"] = dict(capacity=1 << 13, rebin_every=8 if case == "held structures" else 1)
    if case == "3DGS":
        config["tracking"]["use_gt_poses"] = True
        config["mapping"].update(use_gaussian_splatting_densification=True, densify_dict=dict(
            start_after=0, remove_big_after=4, stop_after=8, densify_every=2, grad_thresh=0.01,
            num_to_split_into=2, removal_opacity_threshold=0.005,
            final_removal_opacity_threshold=0.005, reset_opacities=False,
            reset_opacities_every=500))
    return config


@pytest.mark.parametrize("case", ["generic", "held structures", "3DGS"])
def test_runtime_maps_in_place(tmp_path, monkeypatch, case):
    """Every mapping phase of SLAMRuntime steps its map's storage in place:
    nothing of an earlier iteration alive at a render, the map's tensors
    the same objects before and after a frame's mapping, and
    mapping_phase.totals' in_place equal to its phases."""
    seed_everything(0)
    rt = SLAMRuntime(_config(tmp_path, case), "cpu")
    watch = Watch(monkeypatch, own=True)
    steps.reset_map_totals()
    map_frame, storage, rows = rt.map_frame, [], []

    def observed_map_frame(time_idx, selected):
        rows.append(rt.gm.span())
        before = [a.data_ptr() for a in rt.gm]
        map_frame(time_idx, selected)
        storage.append(before == [a.data_ptr() for a in rt.gm])

    monkeypatch.setattr(rt, "map_frame", observed_map_frame)
    for i in range(2):
        run_frame(rt, i)
    totals = steps.mapping_phase.totals
    assert watch.renders == 8 and storage == [case != "3DGS"] * 2  # 3DGS compacts between chunks
    assert totals["phases"] == (4 if case == "3DGS" else 2) == totals["in_place"]
    if case == "3DGS":  # chunks after a pass step the span it leaves
        assert rt.gs_passes and totals["gaussians"] > 0
    else:
        assert totals["gaussians"] == sum(rows) > 0


# name -> mapping_phase keywords
SAME = {
    "plain": {},
    "prune": dict(prune=True),
    "stats": dict(stats=True),
    "held structures": dict(reuse=True),
    "prune, stats, held structures": dict(prune=True, stats=True, reuse=True),
    "opacity reset, resumed": dict(prune=True, reset=True, stats=True, resume=True),
    "anisotropic, prune": dict(iso=False, prune=True),
}


@pytest.mark.parametrize("case", sorted(SAME))
def test_in_place_equals_copy_bit_for_bit(case):
    kw = dict(SAME[case])
    gm = _map(iso=kw.pop("iso", True))
    kept = _clone(gm)
    owned = _clone(gm)
    gm_c, st_c, gsv_c, hist_c = _phase(gm, in_place=False, **kw)
    gm_o, st_o, gsv_o, hist_o = _phase(owned, in_place=True, **kw)
    for name, a, b in zip(GaussianMap._fields, gm, kept):  # the copy's input untouched
        assert torch.equal(a, b), f"{case}: the phase changed its input's {name}"
    for name, c, o, handed in zip(GaussianMap._fields, gm_c, gm_o, owned):
        assert torch.equal(c, o), f"{case}: {name} differs"
        assert o.data_ptr() == handed.data_ptr(), f"{case}: {name} not written in place"
    assert torch.equal(hist_c, hist_o)
    assert st_c.step == st_o.step == ITERS + (4 if kw.get("resume") else 0)
    for c, o in zip(st_c.m + st_c.v, st_o.m + st_o.v):
        assert torch.equal(c, o), f"{case}: Adam moments differ"
    if kw.get("stats"):
        for c, o in zip(gsv_c, gsv_o):
            assert torch.equal(c, o), f"{case}: 3DGS statistics differ"
        assert float(gsv_o[1].max()) > 0
    else:
        assert gsv_c is gsv_o is None
    if kw.get("prune"):
        assert int(gm_o.active.sum()) < int(kept.active.sum())  # the prune engaged


@pytest.mark.parametrize("totals, expected", [
    (dict(phases=4, in_place=4, gaussians=6_000_000), 1.5),
    (dict(phases=0, in_place=0, gaussians=0), None),
    (None, None),  # a program without the counter
])
def test_map_gaussians_reads_the_counter(monkeypatch, totals, expected):
    if totals is None:
        monkeypatch.delattr(steps.mapping_phase, "totals")
    else:
        monkeypatch.setattr(steps.mapping_phase, "totals", totals)
    assert spec.load_reader("map_gaussians").read(None) == expected
