"""The port's (gaussian, tile) alpha-cutoff cull (binning.build_bins
tile_cull) against the JAX package's, the port of tests/test_tile_cull.py.

On the JAX file's anisotropic scene, at direct_j 0 and 2: every tile's
kept pair list equals the JAX build_bins(tile_cull=True) segment (both
bin the same projection, as in tests/test_torch_binning_direct.py), the
cull drops pairs, and the kept stream's counts, offsets and dst describe
exactly the kept slots. The culled pairs contribute nothing, so the port's
render and its gradients with the cull equal those without within the
ROADMAP tolerances (images atol 1e-4, gradients 5e-5 of each column's
largest value). The SLAM loop with tpu.tile_cull passes
assert_loops_match against the JAX runtime's at rebin 8, on an isotropic
and on an anisotropic map.
"""
import numpy as np
import jax  # noqa: F401  (both frameworks in one process: import both first)
import pytest
import torch

from splatam_tpu_torch.core.camera import setup_camera
from splatam_tpu_torch.parallel import spatial
from splatam_tpu_torch.render import api, binning
from tests.test_binning_direct import _tile_segments
from tests.test_render import make_cam, make_scene
from tests.test_torch_binning_direct import both_bins, port_segments
from tests.test_torch_slam import assert_loops_match, run_both

torch.set_num_threads(1)


def _aniso_scene():
    # tests/test_tile_cull.py's: large anisotropic splats whose rects span
    # several tiles, with corner tiles outside the cutoff ellipse.
    return make_scene(n=256, seed=21, scale=0.25, anisotropic=True, z_range=(1.2, 3.0))


@pytest.mark.parametrize("direct_j", [0, 2])
def test_tile_cull_matches_jax_segments(direct_j):
    cam = make_cam()
    scene = _aniso_scene()
    jb, tb, n_tiles = both_bins(scene, cam, direct_j=direct_j, tile_cull=True)
    _, base, _ = both_bins(scene, cam, direct_j=direct_j)
    assert tb.n_culled > 0 and tb.n_pairs == int(jb.n_pairs) == base.n_pairs - tb.n_culled
    np.testing.assert_array_equal(tb.tile_start.numpy(), np.asarray(jb.tile_start))
    assert port_segments(tb, n_tiles) == _tile_segments(jb, n_tiles)
    # counts > 0 exactly where they are without the cull (each Gaussian's
    # first pair stays), and they count the kept pairs
    np.testing.assert_array_equal(tb.counts.numpy() > 0, np.asarray(jb.in_stream))
    np.testing.assert_array_equal(tb.counts.numpy(),
                                  np.bincount(tb.pair_gauss.numpy(), minlength=len(tb.counts)))
    # dst sends each Gaussian's kept slots to stream positions holding it
    gid = np.repeat(np.arange(len(tb.counts)), tb.counts.numpy())
    np.testing.assert_array_equal(tb.pair_gauss.numpy()[tb.dst.numpy()], gid)
    np.testing.assert_array_equal(np.sort(tb.dst.numpy()), np.arange(tb.n_pairs))
    np.testing.assert_array_equal(tb.offsets.numpy(),
                                  np.cumsum(tb.counts.numpy()) - tb.counts.numpy())


@pytest.mark.parametrize("direct_j", [0, 2])
def test_tile_cull_render_matches_unculled(direct_j):
    cam = make_cam()
    pcam = setup_camera(cam.width, cam.height, [[80.0, 0, cam.width / 2],
                                               [0, 80.0, cam.height / 2], [0, 0, 1]])
    means, colors, quats, logit, log_scales, active = (
        torch.tensor(np.asarray(a)) for a in _aniso_scene())

    def render(opts):
        m, s = means.clone().requires_grad_(True), log_scales.clone().requires_grad_(True)
        out = api.render_rgbd_sil(pcam, m, colors, quats, logit, s, active, bin_opts=opts)
        loss = out.im.sum() + out.depth.sum() + out.silhouette.sum()
        return out, torch.autograd.grad(loss, (m, s)), out.n_pairs

    out0, g0, n0 = render(binning.BinOptions(direct_j=direct_j))
    out1, g1, n1 = render(binning.BinOptions(tile_cull=True, direct_j=direct_j))
    assert n1 < n0
    for a, b in ((out0.im, out1.im), (out0.depth, out1.depth),
                 (out0.silhouette, out1.silhouette)):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=1e-4, rtol=0)
    for a, b in zip(g0, g1):
        scale = np.abs(a.numpy()).max(axis=0)
        assert (np.abs(b.numpy() - a.numpy()) <= 5e-5 * scale).all()


@pytest.mark.parametrize("dist", ["isotropic", "anisotropic"])
def test_tile_cull_loop_matches_jax(tmp_path, dist):
    """The SLAM loop with tpu.tile_cull (rebin 8) against the JAX runtime's;
    the port's structure builds dropped pairs."""
    binning.reset_pair_totals()
    rt, jrt, t_active, j_active = run_both(tmp_path, gaussian_distribution=dist,
                                           tpu={"tile_cull": True})
    assert rt.bin_opts == binning.BinOptions(tile_cull=True)
    totals = binning.build_bins.totals
    assert 0 < totals["culled"] < totals["pairs"], totals
    assert rt.gm.isotropic == (dist == "isotropic")
    assert_loops_match(rt, jrt, t_active, j_active)


def test_tile_cull_reaches_the_bands():
    """The banded structure build culls each band's pairs; with bands the
    runtime's direct_j is 0, as in the JAX runtime."""
    cam = make_cam()
    pcam = setup_camera(cam.width, cam.height, [[80.0, 0, cam.width / 2],
                                               [0, 80.0, cam.height / 2], [0, 0, 1]])
    means, _, quats, logit, log_scales, active = (
        torch.tensor(np.asarray(a)) for a in _aniso_scene())
    bands = spatial.make_bands(2, "cpu")
    args = (bands, pcam, means, quats, logit, log_scales, active)
    plain = spatial.compute_pair_structure_sharded(*args)
    culled = spatial.compute_pair_structure_sharded(
        *args, bin_opts=binning.BinOptions(tile_cull=True))
    assert all(c.n_culled > 0 for c in culled)
    assert [c.n_pairs + c.n_culled for c in culled] == [p.n_pairs for p in plain]
    assert binning.BinOptions.from_config({"tile_cull": True, "direct_j": 2}, banded=True) == \
        binning.BinOptions(tile_cull=True, direct_j=0)
