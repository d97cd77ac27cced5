"""The plain reference: its chunked compositing and backward against one
chunk, and its loss against the port's on the same render."""
from __future__ import annotations

import torch

from slam_bench.reference import follow, render
from slam_bench.reference.loss import LossConfig, loss_and_cotangent

K = render.Intrinsics(48, 32, 40.0, 40.0, 23.5, 15.5)


def _map(n=60, seed=1):
    g = torch.Generator().manual_seed(seed)
    means = torch.rand((n, 3), generator=g) * 2.0 + torch.tensor([-1.0, -1.0, 1.5])
    return {"means": means, "colors": torch.rand((n, 3), generator=g),
            "logit_opacities": torch.randn((n,), generator=g),
            "log_scales": torch.log(0.03 + 0.1 * torch.rand((n, 1), generator=g)),
            "active": torch.rand((n,), generator=g) > 0.1}


def _grads(m, q, t, gimg):
    p = {n: m[n].clone().requires_grad_(True) for n in ("means", "colors", "logit_opacities",
                                                        "log_scales")}
    qq, tt = q.clone().requires_grad_(True), t.clone().requires_grad_(True)
    bins = follow.bin_map(m, q, t, K)
    rows = follow._rows(bins, p["means"], torch.exp(p["log_scales"][:, 0]) ** 2,
                        follow._opacity(p["logit_opacities"], m["active"]), p["colors"],
                        render.quat_to_rot(qq), tt, K)
    render.backprop(bins, rows, K, gimg)
    return [v.grad for v in (*p.values(), qq, tt)]


def test_chunked_compositing_and_backward_equal_one_chunk(monkeypatch):
    m = _map()
    q, t = torch.tensor([1.0, 0.02, -0.01, 0.0]), torch.tensor([0.05, -0.02, 0.1])
    gimg = torch.randn((6, K.height, K.width), generator=torch.Generator().manual_seed(2))
    img_one, n_one = follow.render_map(m, q, t, K)[0::2]
    grads_one = _grads(m, q, t, gimg)
    monkeypatch.setattr(render, "CHUNK_ELEMENTS", render.PIX * 4)
    img_many, n_many = follow.render_map(m, q, t, K)[0::2]
    grads_many = _grads(m, q, t, gimg)
    assert n_one == n_many > 0
    torch.testing.assert_close(img_many, img_one)
    for a, b in zip(grads_many, grads_one):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)  # summation order


def test_the_reference_loss_equals_the_ports_on_one_render():
    from splatam_tpu_torch.core.camera import Camera
    from splatam_tpu_torch.slam import steps

    m = _map(seed=4)
    q, t = torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3)
    img, _, _ = follow.render_map(m, q, t, K)
    g = torch.Generator().manual_seed(5)
    color, depth = torch.rand((3, K.height, K.width), generator=g), 2.0 + torch.rand(
        (K.height, K.width), generator=g)
    section = {"use_sil_for_loss": True, "sil_thres": 0.5, "use_l1": True,
               "ignore_outlier_depth_loss": False, "loss_weights": {"im": 0.5, "depth": 1.0}}
    cfg = LossConfig.from_section(section)
    pcfg = steps.PhaseConfig(True, 0.5, True, False, 0.5, 1.0)
    out = steps.api.RenderOutput(im=img[:3], depth=img[3], silhouette=img[5], depth_sq=img[4],
                                 radii=torch.zeros(1), n_pairs=0)
    for tracking in (True, False):
        ours, _ = loss_and_cotangent(img, color, depth, cfg, tracking)
        orig = steps.loss_render
        steps.loss_render = lambda *a, **k: out
        try:
            theirs, _ = steps.get_loss(None, q, t, color, depth, Camera(K.height, K.width, 1, 1,
                                                                          0, 0), pcfg,
                                       tracking, not tracking)
        finally:
            steps.loss_render = orig
        assert abs(ours - float(theirs)) <= 1e-5 * abs(float(theirs))
