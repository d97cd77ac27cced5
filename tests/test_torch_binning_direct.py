"""The port's J-slot pair order (binning.build_bins direct_j) against the
JAX package's direct expansion, tile by tile.

The port sizes its pair buffers exactly, so of the JAX direct path
(splatam_tpu/render/binning.py:242-373) only its pair order is left: among
pairs of equal (tile, quantized depth) key, every Gaussian's slots j < J
come first, in Gaussian order, then the slots j >= J. The JAX file's
fallback test (pair_cap < J * N + 4096 takes the classic path) and its
tail-overflow test (only j >= J pairs drop) have no counterpart here: the
port has no pair cap, so it neither falls back nor drops a pair.

Both packages bin the same projection (the JAX one, handed to the port as
tensors), so the comparison is of the binning alone; the projections
themselves are held to each other in tests/test_torch_render.py.
"""
import numpy as np
import jax  # noqa: F401  (both frameworks in one process: import both first)
import jax.numpy as jnp
import pytest
import torch

from splatam_tpu.render import binning as jbinning
from splatam_tpu_torch.render import binning
from splatam_tpu_torch.render.projection import Projected, ProjectedAux
from tests.test_binning_direct import _project, _tile_segments
from tests.test_render import make_cam, make_scene
from tests.test_torch_slam import assert_loops_match, run_both

torch.set_num_threads(1)

CAP = 1 << 14


def to_torch(proj, aux):
    """A JAX projection as the port's Projected / ProjectedAux."""
    t = lambda a, dt=None: torch.tensor(np.asarray(a), dtype=dt)
    return (Projected(t(proj.xy), t(proj.depth), t(proj.conic), t(proj.opacity)),
            ProjectedAux(t(aux.radius), t(aux.rect_min, torch.int64),
                         t(aux.rect_wh, torch.int64), t(aux.visible)))


def port_segments(bins, num_tiles):
    pg, ts = bins.pair_gauss.numpy(), bins.tile_start.numpy()
    return [list(pg[ts[t]:ts[t + 1]]) for t in range(num_tiles)]


def both_bins(scene, cam, **opts):
    """(JAX bins, port bins, tile count) of one projection."""
    proj, aux = _project(scene, cam)
    gx, gy = jbinning.grid_shape(cam.width, cam.height)
    jb = jbinning.build_bins(proj, aux, cam.width, cam.height, CAP, **opts)
    tb = binning.build_bins(*to_torch(proj, aux), cam.width, cam.height, **opts)
    assert int(jb.overflow) == 0
    return jb, tb, gx * gy


def tie_scene():
    """make_scene's 300 Gaussians and two more at the same depth: a large
    one (3x3 tiles, its slot j = 5 in tile (2, 1)) and, after it, a small
    one inside tile (2, 1) (its only slot, j = 0). They tie on the key in
    that tile, where the classic order puts the large one first and the
    J-slot order (J = 2) the small one."""
    base = [np.asarray(a) for a in make_scene(n=300, seed=3)]
    extra = dict(
        means=np.array([[24.0 - 48.0, 24.0 - 32.0, 160.0], [40.0 - 48.0, 24.0 - 32.0, 160.0]],
                       np.float32) / 80.0,
        colors=np.array([[0.9, 0.1, 0.1], [0.1, 0.9, 0.1]], np.float32),
        quats=np.array([[1.0, 0, 0, 0]] * 2, np.float32),
        logit=np.array([3.0, 3.0], np.float32),
        log_scales=np.log(np.array([[0.17], [0.01]], np.float32)),
        active=np.ones(2, bool),
    )
    return tuple(jnp.asarray(np.concatenate([b, e])) for b, e in zip(base, extra.values()))


@pytest.mark.parametrize("J", [1, 2, 4])
@pytest.mark.parametrize("aniso", [False, True])
def test_direct_matches_jax_segments(J, aniso):
    """Every tile's pair list equals the JAX direct path's, and the
    stream holds the classic pairs (same count, same per-Gaussian counts)."""
    cam = make_cam()
    scene = make_scene(n=300, seed=3, anisotropic=aniso)
    jb, tb, n_tiles = both_bins(scene, cam, direct_j=J)
    classic = binning.build_bins(*to_torch(*_project(scene, cam)), cam.width, cam.height)
    assert tb.n_pairs == int(jb.n_pairs) == classic.n_pairs > 0
    np.testing.assert_array_equal(tb.counts.numpy(), np.asarray(jb.counts))
    np.testing.assert_array_equal(tb.tile_start.numpy(), np.asarray(jb.tile_start))
    assert port_segments(tb, n_tiles) == _tile_segments(jb, n_tiles)
    assert sorted(tb.pair_gauss.tolist()) == sorted(classic.pair_gauss.tolist())


def test_direct_order_on_tied_depths():
    """On a tie where the JAX direct order differs from its classic order,
    the port's direct order is the JAX direct one and differs from the
    port's classic order (so this test can fail)."""
    cam = make_cam()
    scene = tie_scene()
    big, small = 300, 301
    tile = 1 * 6 + 2  # tile (2, 1) of the 6x4 grid
    jd, td, n_tiles = both_bins(scene, cam, direct_j=2)
    jc, tc, _ = both_bins(scene, cam)
    segs = {name: port_segments(b, n_tiles) if name[0] == "t" else _tile_segments(b, n_tiles)
            for name, b in (("jd", jd), ("td", td), ("jc", jc), ("tc", tc))}
    pos = {k: [s[tile].index(big), s[tile].index(small)] for k, s in segs.items()}
    assert pos["jc"][0] < pos["jc"][1] and pos["jd"][1] < pos["jd"][0], pos
    assert segs["td"] == segs["jd"] and segs["tc"] == segs["jc"]
    assert segs["td"][tile] != segs["tc"][tile]


def test_direct_loop_matches_jax(tmp_path):
    """The SLAM loop with tpu.direct_j = 2 (rebin 8, isotropic) against the
    JAX runtime's."""
    rt, jrt, t_active, j_active = run_both(tmp_path, tpu={"direct_j": 2})
    assert rt.bin_opts == binning.BinOptions(direct_j=2)
    assert_loops_match(rt, jrt, t_active, j_active)
