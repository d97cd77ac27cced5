"""The port's projection, binning, composite forward (K1) and segment
reduce (K3) against the JAX package, on shared numpy inputs (the generic
render's gradients are in tests/test_torch_generic_render.py).

K1's plain version is held to the Pallas composite forward run under the
TPU interpreter (as tests/test_pallas_interpret.py runs it) at atol 1e-4,
the tolerance the JAX suite holds its own backends to; K3's plain version
to segment_reduce_scan_pallas's totals at rtol 1e-5 (same float32 sums,
another order). Projection at 1e-5 absolute (pixels) / relative (conics):
float32 rounding only. Binning must match exactly: same pairs, same
order inside each tile, same tile starts. The kernels themselves are held
to these plain versions in tests/test_torch_kernels.py (CUDA only).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.render import binning as jbinning
from splatam_tpu.render import projection as jprojection
from splatam_tpu.render.api import RenderConfig, render_gaussians
from splatam_tpu.render.pallas.composite_pallas import segment_reduce_scan_pallas
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.render import api, binning, composite, projection

JCAM = JCamera(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CAM = Camera(height=48, width=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CFG_P = RenderConfig(backend="pallas", pair_cap=1 << 12, tile_k_max=512)


def _scene(n=512, seed=0, iso=True):
    rng = np.random.default_rng(seed)
    means = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n), rng.uniform(-0.5, 5, n)], -1
    ).astype(np.float32)
    return dict(
        means=means,
        rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        logit=rng.normal(1.0, 0.5, n).astype(np.float32),
        logsc=np.log(rng.uniform(0.01, 0.08, (n, 1 if iso else 3))).astype(np.float32),
        active=rng.uniform(size=n) > 0.1,
    )


def _unit(q):
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_project_and_bins_match_jax():
    s = _scene(seed=1, iso=False)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.05, -0.02, 0.1]
    scales = np.exp(s["logsc"])
    jp, ja = jprojection.project(
        jnp.asarray(s["means"]), jnp.asarray(_unit(s["quats"])), jnp.asarray(s["logit"]),
        jnp.asarray(scales), jnp.asarray(s["active"]), jnp.asarray(w2c),
        JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, JCAM.width, JCAM.height)
    tp, ta = projection.project(
        torch.tensor(s["means"]), torch.tensor(_unit(s["quats"])), torch.tensor(s["logit"]),
        torch.tensor(scales), torch.tensor(s["active"]), torch.tensor(w2c),
        CAM.fx, CAM.fy, CAM.cx, CAM.cy, CAM.width, CAM.height)
    vis = np.asarray(ja.visible)
    np.testing.assert_array_equal(ta.visible.numpy(), vis)
    np.testing.assert_array_equal(ta.rect_min.numpy()[vis], np.asarray(ja.rect_min)[vis])
    np.testing.assert_array_equal(ta.rect_wh.numpy()[vis], np.asarray(ja.rect_wh)[vis])
    np.testing.assert_array_equal(ta.radius.numpy(), np.asarray(ja.radius))
    np.testing.assert_allclose(tp.xy.numpy()[vis], np.asarray(jp.xy)[vis], atol=1e-4)
    np.testing.assert_allclose(tp.depth.numpy(), np.asarray(jp.depth), atol=1e-5)
    np.testing.assert_allclose(tp.conic.numpy()[vis], np.asarray(jp.conic)[vis], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tp.opacity.numpy(), np.asarray(jp.opacity), atol=1e-6)

    jb = jbinning.build_bins(jp, ja, JCAM.width, JCAM.height, 1 << 14)
    tb = binning.build_bins(tp, ta, CAM.width, CAM.height)
    n = int(jb.n_pairs)
    assert tb.n_pairs == n and int(jb.overflow) == 0
    np.testing.assert_array_equal(tb.tile_start.numpy(), np.asarray(jb.tile_start))
    np.testing.assert_array_equal(tb.pair_gauss.numpy(), np.asarray(jb.pair_gauss)[:n])
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    # Gaussian-major expansion: dst maps slot offsets[g] + j to g's j-th pair.
    gid = np.repeat(np.arange(len(vis)), tb.counts.numpy())
    np.testing.assert_array_equal(tb.pair_gauss.numpy()[tb.dst.numpy()], gid)
    np.testing.assert_array_equal(tb.offsets.numpy(),
                                  np.cumsum(tb.counts.numpy()) - tb.counts.numpy())


def test_tiles_round_trip():
    img = torch.arange(2 * 37 * 45, dtype=torch.float32).reshape(2, 37, 45)
    tiles = composite.to_tiles(img)
    assert tiles.shape == (2, 9, 256)
    torch.testing.assert_close(composite.assemble_image(tiles, 45, 37), img, rtol=0, atol=0)


def test_composite_forward_plain_matches_pallas_interpret():
    """K1's plain version vs the Pallas composite forward (densify's render)."""
    s = _scene(seed=2)
    args = [jnp.asarray(x) for x in (s["means"], s["rgb"], s["quats"], s["logit"],
                                     np.tile(s["logsc"], (1, 3)), s["active"])]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(lambda *a: render_gaussians(JCAM, *a, config=CFG_P)[0])(*args))
    t = {k: torch.tensor(v) for k, v in s.items()}
    out = api.render_rgbd_sil(CAM, t["means"], t["rgb"], t["quats"], t["logit"], t["logsc"],
                              t["active"])
    mine = torch.cat([out.im, out.depth[None], out.silhouette[None], out.depth_sq[None]])
    np.testing.assert_allclose(mine.numpy(), ref, atol=1e-4)
    assert out.n_pairs > 0


def _segments(seed=4, n=300, p=2048):
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(p, rng.dirichlet(np.ones(n) * 0.5)).astype(np.int32)
    counts[rng.uniform(size=n) < 0.1] = 0
    counts[0] += p - counts.sum()
    grouped = rng.normal(size=(8, p)).astype(np.float32)
    dst = rng.permutation(p).astype(np.int32)
    return counts, grouped, dst


def test_segment_reduce_plain_matches_pallas_interpret():
    """K3's plain version vs segment_reduce_scan_pallas gathered at the
    segment ends (fused_iso.py:816-823)."""
    counts, grouped, dst = _segments()
    gid = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        scanned = np.asarray(segment_reduce_scan_pallas(jnp.asarray(grouped), jnp.asarray(gid)))
    offsets = np.cumsum(counts) - counts
    ends = np.clip(offsets + counts - 1, 0, None)
    ref = np.where(counts[:, None] > 0, scanned[:, ends].T, 0.0)

    dpair = np.empty((grouped.shape[1], 8), np.float32)
    dpair[dst] = grouped.T  # expansion slot j lives at sorted position dst[j]
    mine = composite.segment_reduce(torch.tensor(dpair), torch.tensor(dst),
                                    torch.tensor(offsets.astype(np.int32)),
                                    torch.tensor(counts))
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-5)
