"""The port's row bands (splatam_tpu_torch/parallel/spatial.py) against the
JAX package's row-sharded phases on its virtual CPU mesh, and against the
port's own unbanded path.

tests/test_multichip.py's scene and sizes: H=80, W=64, 256 Gaussians from
numpy seeds, 2 and 4 bands. With 4 bands of 32 rows band 3 would start at
row 96, past the image (the JAX module renders it in padding rows and
crops): it has no rows, an empty structure, and renders nothing, so every
route below also runs with an empty band; test_empty_band_renders_on_every_route
also runs a band with rows and no pair through binning and the kernels'
plain versions. The JAX side runs its `tiles` backend, whose structures carry no
world rows, so its tracking with a structure takes the generic render where
the port takes the pair-space one (world-8 rows on an isotropic map, world-16
on an anisotropic one): the same function by another route.

Tolerances. Banded against unbanded, in the port: tests/test_multichip.py's
(loss rtol 1e-5, silhouette atol 1e-5, radii > 0 equal; the phases' loss
rtol 1e-4, poses and means atol 1e-5, the 3DGS statistics rtol 1e-3), and
gradients within 5e-5 of each output row's largest value (ROADMAP's kernel
gate; a Gaussian's gradient is now summed per band, then over bands). Against
the JAX package: the same forward gates, on JAX's forward jitted with the
inputs as constants (as test_multichip.py jits it); gradients within the
port-vs-JAX tolerances of tests/test_torch_fused_iso.py (pose 2e-4, Gaussian
parameters 3e-4 of the largest): XLA's jitted gradient program of the banded
mapping render applies a pair at one near-cutoff pixel that the same
function's eager forward skips (3.8e-4 in that pixel's silhouette, measured
on this scene), and the port matches the eager forward.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.core.gaussians import GaussianMap as JMap
from splatam_tpu.parallel.spatial import make_mesh
from splatam_tpu.render.api import RenderConfig
from splatam_tpu.slam import optim as joptim
from splatam_tpu.slam import steps as jsteps
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.core.gaussians import GaussianMap
from splatam_tpu_torch.parallel import spatial
from splatam_tpu_torch.slam import steps

torch.set_num_threads(1)

H, W = 80, 64
JCAM = JCamera(height=H, width=W, fx=60.0, fy=60.0, cx=32.0, cy=H / 2.0)
CAM = Camera(height=H, width=W, fx=60.0, fy=60.0, cx=32.0, cy=H / 2.0)
RCFG = RenderConfig(backend="tiles", pair_cap=1 << 12, tile_k_max=256)
TRACK = dict(use_sil_for_loss=True, sil_thres=0.99, use_l1=True, ignore_outlier_depth_loss=True,
             w_im=0.5, w_depth=1.0)
MAP = dict(use_sil_for_loss=False, sil_thres=0.5, use_l1=True, ignore_outlier_depth_loss=False,
           w_im=0.5, w_depth=1.0)
Q = np.asarray([1.0, 0.01, 0.0, 0.0], np.float32)
T = np.asarray([0.02, -0.01, 0.03], np.float32)
MAP_KEYS = ("means3d", "rgb_colors", "logit_opacities", "log_scales")
LRS = (1e-4, 2.5e-3, 1e-3, 5e-2, 1e-3)


def _fields(n=256, seed=0, iso=True, capacity=None):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(1.5, 4, n)], -1).astype(np.float32)
    f = dict(means3d=means, rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
             unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
             logit_opacities=rng.normal(1.0, 0.5, (n,)).astype(np.float32),
             log_scales=np.log(rng.uniform(0.02, 0.08, (n, 1 if iso else 3))).astype(np.float32),
             active=np.ones(n, bool))
    if capacity:
        f = {k: np.concatenate([v, np.zeros((capacity - n,) + v.shape[1:], v.dtype)])
             for k, v in f.items()}
        f["unnorm_rotations"][n:, 0] = 1.0
    return f


def _maps(**kw):
    f = _fields(**kw)
    return (JMap(**{k: jnp.asarray(v) for k, v in f.items()}),
            GaussianMap(**{k: torch.tensor(v) for k, v in f.items()}))


def _frame(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (3, H, W)).astype(np.float32),
            rng.uniform(1.0, 4.0, (H, W)).astype(np.float32))


def _close_rows(got, ref, tol, msg):
    """Each output row (a gradient column: got and ref are [N, k] or [k]) within tol of
    its own largest value."""
    got, ref = np.asarray(got).reshape(len(got), -1), np.asarray(ref).reshape(len(ref), -1)
    scale = np.maximum(np.abs(ref).max(0), 1e-12)
    err = np.abs(got - ref).max(0) / scale
    assert (err <= tol).all(), f"{msg}: {err.max():.3e} of the largest (> {tol})"


# route -> (map, tracking, structure): every route get_loss can take with bands
ROUTES = {
    "tracking generic, isotropic": (True, True, False),
    "tracking world-8 pair space": (True, True, True),
    "tracking world-16 pair space": (False, True, True),
    "mapping generic, isotropic": (True, False, False),
    "mapping fused, isotropic": (True, False, True),
    "mapping generic reuse, anisotropic": (False, False, True),
}


def _port_loss(tgm, color, depth, tracking, with_ps, bands):
    """Port get_loss and its gradients: to (q, t) tracking, else to MAP_KEYS."""
    q, t = torch.tensor(Q, requires_grad=tracking), torch.tensor(T, requires_grad=tracking)
    params = {k: getattr(tgm, k).clone().requires_grad_(not tracking) for k in MAP_KEYS}
    g = tgm._replace(**params)
    ps = (steps.loss_pair_structure(g, q, t, CAM, with_world16=tracking, bands=bands)
          if with_ps else None)
    pcfg = steps.PhaseConfig(**(TRACK if tracking else MAP))
    loss, aux = steps.get_loss(g, q, t, torch.tensor(color), torch.tensor(depth), CAM, pcfg,
                               tracking, not tracking, ps, bands=bands)
    grads = torch.autograd.grad(loss, (q, t) if tracking else tuple(params.values()))
    return float(loss.detach()), aux, [x.numpy() for x in grads], ps


def _jax_loss(jgm, color, depth, tracking, with_ps, mesh):
    """JAX get_loss on the mesh: (loss, aux) of its forward jitted with
    constant inputs, and its gradients (as _port_loss's)."""
    pcfg = jsteps.PhaseConfig(**(TRACK if tracking else MAP))

    def loss_fn(x):
        if tracking:
            q, t, g = x[0], x[1], jgm
        else:
            q, t = jnp.asarray(Q), jnp.asarray(T)
            g = jgm._replace(**dict(zip(MAP_KEYS, x)))
        ps = (jsteps.loss_pair_structure(g, jax.lax.stop_gradient(q), jax.lax.stop_gradient(t),
                                         JCAM, RCFG, with_world16=tracking, mesh=mesh)
              if with_ps else None)
        return jsteps.get_loss(g, q, t, jnp.asarray(color), jnp.asarray(depth), JCAM, pcfg,
                               RCFG, tracking, not tracking, mesh=mesh, pair_structure=ps)

    x = ((jnp.asarray(Q), jnp.asarray(T)) if tracking
         else tuple(getattr(jgm, k) for k in MAP_KEYS))
    loss, aux = jax.jit(lambda: loss_fn(x))()
    (_, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(x)
    return float(loss), aux, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_banded_get_loss_matches_jax_and_unbanded(route, n_bands):
    iso, tracking, with_ps = ROUTES[route]
    jgm, tgm = _maps(iso=iso)
    color, depth = _frame()
    bands = spatial.make_bands(n_bands, "cpu")
    loss_b, aux_b, grads_b, ps = _port_loss(tgm, color, depth, tracking, with_ps, bands)
    loss_u, aux_u, grads_u, _ = _port_loss(tgm, color, depth, tracking, with_ps, None)
    loss_j, aux_j, grads_j = _jax_loss(jgm, color, depth, tracking, with_ps, make_mesh(n_bands))
    if with_ps:
        assert len(ps) == n_bands
        assert (ps[0].world8 is not None) == (tracking and iso)
        assert (ps[0].world16 is not None) == (tracking and not iso)
    # banded against unbanded, in the port
    np.testing.assert_allclose(loss_b, loss_u, rtol=1e-5)
    np.testing.assert_allclose(aux_b.silhouette.numpy(), aux_u.silhouette.numpy(), atol=1e-5)
    np.testing.assert_array_equal(aux_b.radii.numpy() > 0, aux_u.radii.numpy() > 0)
    for got, ref in zip(grads_b, grads_u):
        _close_rows(got, ref, 5e-5, f"{route}: banded vs unbanded gradient")
    # against the JAX package's sharded function
    np.testing.assert_allclose(loss_b, loss_j, rtol=1e-5)
    np.testing.assert_allclose(aux_b.silhouette.numpy(), np.asarray(aux_j.silhouette), atol=1e-5)
    generic = not with_ps or (not tracking and not iso)
    if generic:  # the port's pair-space and fused renders form no radii (all 0)
        np.testing.assert_array_equal(aux_b.radii.numpy() > 0, np.asarray(aux_j.radii) > 0)
    tol = 2e-4 if tracking else 3e-4
    for got, ref in zip(grads_b, grads_j):
        _close_rows(got, ref, tol, f"{route}: banded vs JAX sharded gradient")


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("rebin_every", [1, 3])
def test_banded_tracking_phase_matches_jax(rebin_every, n_bands):
    """test_multichip.py's tracking tests (5 iterations at rebin 1, 6 at
    rebin 3), the port banded against JAX on the mesh and against the
    port unbanded."""
    jgm, tgm = _maps(seed=2)
    color, depth = _frame(seed=3)
    q0, t0 = np.asarray([1.0, 0.01, 0, 0], np.float32), np.asarray([0.05, 0, 0], np.float32)
    iters = 5 if rebin_every == 1 else 6
    jq, jt, jit_, jloss, *_ = jsteps.tracking_phase(
        jgm, jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(color), jnp.asarray(depth), JCAM,
        iters, False, 1e5, 2e-3, 1e-3, jsteps.PhaseConfig(**TRACK), RCFG,
        mesh=make_mesh(n_bands), rebin_every=rebin_every)
    runs = []
    for bands in (spatial.make_bands(n_bands, "cpu"), None):
        runs.append(steps.tracking_phase(
            tgm, torch.tensor(q0), torch.tensor(t0), torch.tensor(color), torch.tensor(depth),
            CAM, iters, False, 1e5, 2e-3, 1e-3, steps.PhaseConfig(**TRACK), rebin_every,
            bands=bands))
    (q_b, t_b, it_b, loss_b, _), (q_u, t_u, it_u, loss_u, _) = runs
    assert it_b == it_u == int(jit_)
    for q_ref, t_ref, loss_ref in ((q_u.numpy(), t_u.numpy(), float(loss_u)),
                                   (np.asarray(jq), np.asarray(jt), float(jloss))):
        np.testing.assert_allclose(float(loss_b), loss_ref, rtol=1e-4)
        np.testing.assert_allclose(q_b.numpy(), q_ref, atol=1e-5)
        np.testing.assert_allclose(t_b.numpy(), t_ref, atol=1e-5)


# (structure reuse, 3DGS statistics)
MAPPING = {"stats": (False, True), "stats, reuse": (True, True), "fused reuse": (True, False)}


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("case", sorted(MAPPING))
def test_banded_mapping_phase_matches_jax(case, n_bands):
    """test_multichip.py's mapping tests (4 iterations, pruning every 2,
    the 3DGS statistics with the y rescale of means2d_dummy and the radii
    max over bands), and the fused render over reused band structures."""
    reuse, stats = MAPPING[case]
    jgm, tgm = _maps(seed=4)
    color, depth = _frame(seed=5)
    n_iters = 4
    kf_u8 = (color.transpose(1, 2, 0) * 255).astype(np.uint8)[None]
    prune = dict(enabled=True, prune_every=2, stop_after=10)
    zeros = jnp.zeros((jgm.capacity,), jnp.float32)
    params = (jgm.means3d, jgm.rgb_colors, jgm.unnorm_rotations, jgm.logit_opacities,
              jgm.log_scales)
    struct = dict(struct_qs=jnp.tile(jnp.asarray([[1.0, 0, 0, 0]]), (2, 1)),
                  struct_ts=jnp.zeros((2, 3)), iter_struct_idx=jnp.zeros((n_iters,), jnp.int32),
                  n_structs=jnp.int32(1)) if reuse else {}
    jgm2, _, jgsv, jloss, *_ = jsteps.mapping_phase(
        jgm, jnp.asarray(kf_u8), jnp.asarray(depth)[None], jnp.zeros((n_iters,), jnp.int32),
        jnp.tile(jnp.asarray([[1.0, 0, 0, 0]]), (n_iters, 1)), jnp.zeros((n_iters, 3)),
        jnp.float32(2.0), JCAM, n_iters, jsteps.PhaseConfig(**MAP), RCFG,
        jsteps.PruneConfig(**prune), LRS, joptim.adam_init(params), (zeros, zeros, zeros),
        track_stats=stats, mesh=make_mesh(n_bands), reuse_structures=reuse, **struct)
    q = torch.tensor([[1.0, 0, 0, 0]])
    runs = []
    for bands in (spatial.make_bands(n_bands, "cpu"), None):
        gm2, _, gsv, hist = steps.mapping_phase(
            tgm, torch.tensor(kf_u8), torch.tensor(depth)[None], [0] * n_iters,
            q.expand(n_iters, 4), torch.zeros((n_iters, 3)), 2.0, CAM, n_iters,
            steps.PhaseConfig(**MAP), steps.PruneConfig(**prune), LRS,
            struct_qs=q if reuse else None, struct_ts=torch.zeros((1, 3)) if reuse else None,
            iter_struct_idx=[0] * n_iters if reuse else None, record_hist=True,
            track_stats=stats, bands=bands)
        runs.append((gm2, gsv, float(hist[:, 0].sum())))
    (gm_b, gsv_b, loss_b), (gm_u, gsv_u, loss_u) = runs
    refs = ((gm_u.means3d.numpy(), gm_u.active.numpy(), gsv_u and [x.numpy() for x in gsv_u],
             loss_u),
            (np.asarray(jgm2.means3d), np.asarray(jgm2.active),
             stats and [np.asarray(x) for x in jgsv], float(jloss)))
    for means, active, gsv, loss in refs:
        np.testing.assert_allclose(loss_b, loss, rtol=1e-4)
        np.testing.assert_allclose(gm_b.means3d.numpy(), means, atol=1e-5)
        np.testing.assert_array_equal(gm_b.active.numpy(), active)
        if stats:
            np.testing.assert_allclose(gsv_b[0].numpy(), gsv[0], rtol=1e-3, atol=1e-6)
            np.testing.assert_allclose(gsv_b[1].numpy(), gsv[1], atol=1e-6)
            np.testing.assert_allclose(gsv_b[2].numpy(), gsv[2], atol=1e-6)
    if stats:
        assert float(gsv_b[0].max()) > 0 and float(gsv_b[1].max()) > 0


@pytest.mark.parametrize("n_bands", [2, 4])
def test_banded_densify_step_matches_jax(n_bands):
    """densify_step's banded render decides the same candidates: the same
    Gaussians written into the same free slots as JAX on the mesh and as
    the port unbanded."""
    f = _fields(seed=6, capacity=8192)
    jgm = JMap(**{k: jnp.asarray(v) for k, v in f.items()})
    tgm = GaussianMap(**{k: torch.tensor(v) for k, v in f.items()})
    color, depth = _frame(seed=7)
    jout = jsteps.densify_step(jgm, jnp.zeros((8192,)), jnp.asarray(color), jnp.asarray(depth),
                               jnp.asarray(Q), jnp.asarray(T), jnp.int32(3), JCAM, 0.5, RCFG,
                               mesh=make_mesh(n_bands))
    outs = [steps.densify_step(tgm, torch.zeros(8192), torch.tensor(color), torch.tensor(depth),
                               torch.tensor(Q), torch.tensor(T), 3, CAM, 0.5, bands)
            for bands in (spatial.make_bands(n_bands, "cpu"), None)]
    (gm_b, ts_b, n_b, drop_b), (gm_u, ts_u, n_u, _) = outs
    assert drop_b == 0 and n_b == n_u == int(jout[2]) > 0
    for ref_gm, ref_ts in ((gm_u, ts_u.numpy()), (jout[0], np.asarray(jout[1]))):
        for k in ("means3d", "rgb_colors", "log_scales", "active"):
            np.testing.assert_allclose(np.asarray(getattr(gm_b, k)),
                                       np.asarray(getattr(ref_gm, k)), atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(ts_b.numpy(), ref_ts)


@pytest.mark.parametrize("empty", ["band past the image", "band with rows and no pair"])
def test_empty_band_renders_on_every_route(empty):
    """An empty band on every banded route (generic, world-8 and world-16
    pair space, fused mapping): band 3 of 4 (it would start at row 96 of 80:
    no rows, an empty structure, nothing rendered), or band 1 of 2 of a map
    whose Gaussians all sit in the top rows (rows 48-79 and no pair: binning,
    K1-K5 and K3 run on empty pair lists). Each still gives the unbanded
    image and finite gradients."""
    past = empty == "band past the image"
    n_bands = 4 if past else 2
    bands = spatial.make_bands(n_bands, "cpu")
    assert spatial.shard_heights(H, 4) == (32, 128)
    color, depth = _frame()
    for iso in (True, False):
        f = _fields(iso=iso)
        if not past:  # every Gaussian in the upper part of the view
            f["means3d"][:, 1] = np.random.default_rng(3).uniform(-1, -0.6, 256)
        tgm = GaussianMap(**{k: torch.tensor(v) for k, v in f.items()})
        q, t = torch.tensor(Q), torch.tensor(T)
        ps = steps.loss_pair_structure(tgm, q, t, CAM, with_world16=True, bands=bands)
        assert [p.n_pairs > 0 for p in ps] == [True] * (n_bands - 1) + [False]
        assert ps[-1].pair_gauss.shape == (0,) and int(ps[-1].tile_start.max()) == 0
        assert ps[-1].tile_start.shape == ((1,) if past else (4 * 2 + 1,))  # rows 48-79
        for tracking in (True, False):
            for with_ps in (False, True):
                loss_b, aux_b, grads_b, _ = _port_loss(tgm, color, depth, tracking, with_ps,
                                                       bands)
                loss_u, aux_u, _, _ = _port_loss(tgm, color, depth, tracking, with_ps, None)
                np.testing.assert_allclose(loss_b, loss_u, rtol=1e-5)
                np.testing.assert_allclose(aux_b.silhouette.numpy(),
                                           aux_u.silhouette.numpy(), atol=1e-5)
                assert all(np.isfinite(g).all() for g in grads_b)


def test_world_rows_exclude_each_other():
    """The JAX function takes both and silently uses world_rows8
    (spatial.py:64); the port refuses the pair."""
    _, tgm = _maps()
    with pytest.raises(ValueError, match="exclude each other"):
        spatial.compute_pair_structure_sharded(
            spatial.make_bands(2, "cpu"), CAM, tgm.means3d, tgm.unnorm_rotations,
            tgm.logit_opacities, tgm.log_scales, tgm.active,
            world_rows=torch.zeros((256, 13)), world_rows8=torch.zeros((256, 8)))


def test_banded_render_refuses_a_full_image_structure():
    """A single-device PairStructure is never handed to a banded render."""
    _, tgm = _maps()
    q, t = torch.tensor(Q), torch.tensor(T)
    bands = spatial.make_bands(2, "cpu")
    ps = steps.loss_pair_structure(tgm, q, t, CAM, with_world16=True)
    with pytest.raises(ValueError, match="per-band pair structures"):
        spatial.render_rgbd_sil_pairspace_sharded(bands, CAM, ps, q, t)
    for given in (ps, [ps]):
        with pytest.raises(ValueError, match="per-band pair structures"):
            steps.get_loss(tgm, q, t, torch.zeros((3, H, W)), torch.ones((H, W)), CAM,
                           steps.PhaseConfig(**TRACK), True, False, given, bands=bands)


def test_make_bands_and_heights():
    assert spatial.make_bands(3, "cpu") == [torch.device("cpu")] * 3
    assert spatial.shard_heights(680, 4) == (176, 704)
    assert spatial.shard_heights(64, 4) == (16, 64)
    assert spatial.shard_heights(240, 8) == (32, 256)
    assert spatial.band_rows(680, 4) == [176, 176, 176, 152]
    assert spatial.band_rows(80, 4) == [32, 32, 16, 0]


@pytest.mark.parametrize("n_bands", [2, 4])
def test_band_pairs_keep_the_full_images_order(n_bands):
    """At 1200x680 the full image has 3225 tiles (19 depth-key bits) and a
    band fewer (20 or 21 bits of its own): each band's binning keys depth
    on the full image's tile count, so every tile lists the same Gaussians
    in the same order as the full image's tile (a finer key would part
    pairs that the full key ties and orders by Gaussian index)."""
    from splatam_tpu_torch.render import binning
    from splatam_tpu_torch.scripts import scene

    gm, q, t, cam = scene.synthetic_scene(20000, 1200, 680, 1.0, "cpu")
    gx, gy = binning.grid_shape(cam.width, cam.height)
    h_local, _ = spatial.shard_heights(cam.height, n_bands)
    assert binning.depth_bits_for(gx * gy) < binning.depth_bits_for(gx * (h_local // 16))
    full = steps.loss_pair_structure(gm, q, t, cam)
    bands = steps.loss_pair_structure(gm, q, t, cam, bands=spatial.make_bands(n_bands, "cpu"))

    def lists(ps):
        ends = ps.tile_start.tolist()
        return [ps.pair_gauss[a:b].tolist() for a, b in zip(ends[:-1], ends[1:])]

    want = lists(full)
    per_band = (h_local // 16) * gx
    for k, ps in enumerate(bands):
        got = lists(ps)
        first = k * per_band
        # the last band stops at the image's last row, so its tiles are
        # the image's last tile rows
        assert got == want[first:first + per_band]
