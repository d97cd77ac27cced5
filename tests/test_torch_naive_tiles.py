"""The port's two references of the kernels, the naive compositor
(render/naive.py) and the tiles compositor (render/composite_tiles.py),
against their JAX counterparts, and the port's three render backends
against each other.

The compositors are fed the same projected Gaussians (the JAX package's
projection, as numpy) and the same per-tile lists (the JAX binning's
sorted pairs, cut to tiles by the port's tile_lists). The naive forward
and its autograd gradients are held to the JAX function and jax.grad; the
tiles forward and its analytic backward to composite_tiles and its custom
VJP. Tolerances are the JAX suite's (test_pallas_interpret.py:76-77):
images 1e-4 absolute, gradients 5e-5 of each array's largest magnitude.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.render import binning as jbinning
from splatam_tpu.render import composite_jax as jtiles
from splatam_tpu.render import naive as jnaive
from splatam_tpu.render.api import _prep_gaussians
from splatam_tpu.render.projection import project as jproject
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.render import api, composite_tiles, naive
from splatam_tpu_torch.render.projection import Projected, ProjectedAux

# one intra-op thread per test worker (see test_torch_generic_render.py)
torch.set_num_threads(1)

H, W = 48, 64
JCAM = JCamera(height=H, width=W, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CAM = Camera(height=H, width=W, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
GRAD_TOL = 5e-5
DIFF = ("xy", "conic", "opacity", "channels")


def projected(n=320, n_chans=4, seed=0):
    """The JAX projection of a seeded anisotropic map, as numpy: the
    compositors' float inputs (DIFF), depth and the projection's aux."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(-0.5, 5, n)], -1).astype(np.float32)
    quats, logit, scales = _prep_gaussians(
        jnp.asarray(rng.normal(size=(n, 4)).astype(np.float32)),
        jnp.asarray(rng.normal(1.0, 0.8, n).astype(np.float32)),
        jnp.asarray(np.log(rng.uniform(0.01, 0.08, (n, 3))).astype(np.float32)))
    proj, aux = jproject(jnp.asarray(means), quats, logit, scales,
                         jnp.asarray(rng.uniform(size=n) > 0.1), JCAM.w2c_array(),
                         JCAM.fx, JCAM.fy, JCAM.cx, JCAM.cy, W, H)
    x = {k: np.asarray(v) for k, v in proj._asdict().items()}
    x["channels"] = rng.uniform(0, 1, (n, n_chans)).astype(np.float32)
    return x, proj, aux


def close(mine, ref, name, tol=GRAD_TOL):
    ref = np.asarray(ref)
    assert np.isfinite(mine).all(), name
    np.testing.assert_allclose(mine, ref, atol=tol * (np.abs(ref).max() + 1e-8), rtol=0,
                               err_msg=name)


def torch_inputs(x):
    return {k: torch.tensor(x[k]).requires_grad_(True) for k in DIFF}


def test_composite_naive_matches_jax():
    x, proj, aux = projected(seed=1)
    g = np.random.default_rng(2).normal(size=(4, H, W)).astype(np.float32)

    def jfn(xy, conic, opacity, channels):
        p = proj._replace(xy=xy, conic=conic, opacity=opacity)
        return jnaive.composite_naive(p, aux, channels, W, H)

    img_j, vjp = jax.vjp(jfn, *(jnp.asarray(x[k]) for k in DIFF))
    grads_j = vjp(jnp.asarray(g))
    t = torch_inputs(x)
    taux = ProjectedAux(*(torch.tensor(np.asarray(a)) for a in aux))
    img = naive.composite_naive(
        Projected(xy=t["xy"], depth=torch.tensor(x["depth"]), conic=t["conic"],
                  opacity=t["opacity"]), taux, t["channels"], W, H)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j), atol=1e-4)
    assert float(img.detach().abs().max()) > 0.1
    grads = torch.autograd.grad((img * torch.tensor(g)).sum(), [t[k] for k in DIFF])
    for name, mine, ref in zip(DIFF, grads, grads_j):
        close(mine.numpy(), ref, name)


def test_composite_tiles_matches_jax():
    """Forward and the analytic backward (the suffix recurrence run lane by
    lane here, by an associative scan there) on exact per-tile lists."""
    x, proj, aux = projected(seed=3)
    bins = jbinning.build_bins(proj, aux, W, H, 1 << 12)
    n_pairs = int(bins.n_pairs)
    lists, lens = composite_tiles.tile_lists(
        torch.tensor(np.asarray(bins.pair_gauss)[:n_pairs]),
        torch.tensor(np.asarray(bins.tile_start)))
    assert lists.shape[1] % composite_tiles.CHUNK == 0 and int(lens.max()) > composite_tiles.CHUNK
    px, py = composite_tiles.tile_pixel_coords(W, H)
    jpx, jpy = jtiles.tile_pixel_coords(W, H)
    np.testing.assert_array_equal(px, jpx)
    np.testing.assert_array_equal(py, jpy)
    t_tiles = lists.shape[0]
    g = np.random.default_rng(4).normal(size=(t_tiles, 4, 256)).astype(np.float32)

    def jfn(xy, conic, opacity, channels):
        return jtiles.composite_tiles(xy, conic, opacity, channels,
                                      jnp.asarray(lists.numpy().astype(np.int32)),
                                      jnp.asarray(lens.numpy().astype(np.int32)),
                                      jnp.asarray(jpx), jnp.asarray(jpy))

    acc_j, vjp = jax.vjp(jfn, *(jnp.asarray(x[k]) for k in DIFF))
    grads_j = vjp(jnp.asarray(g))
    t = torch_inputs(x)
    acc = composite_tiles.composite_tiles(t["xy"], t["conic"], t["opacity"], t["channels"],
                                          lists, lens, torch.tensor(px), torch.tensor(py))
    assert acc.shape == (4, t_tiles, 256)  # [C, T, 256]; the JAX function's is [T, C, 256]
    np.testing.assert_allclose(acc.detach().permute(1, 0, 2).numpy(), np.asarray(acc_j),
                               atol=1e-4)
    grads = torch.autograd.grad((acc * torch.tensor(g).permute(1, 0, 2)).sum(),
                                [t[k] for k in DIFF])
    for name, mine, ref in zip(DIFF, grads, grads_j):
        close(mine.numpy(), ref, name)


def test_tile_lists_are_the_exact_pair_runs():
    pair_gauss = torch.tensor([5, 2, 7, 1, 1, 3], dtype=torch.int32)
    tile_start = torch.tensor([0, 3, 3, 6], dtype=torch.int32)
    lists, lens = composite_tiles.tile_lists(pair_gauss, tile_start)
    assert lists.shape == (3, composite_tiles.CHUNK) and lens.tolist() == [3, 0, 3]
    assert lists[0, :3].tolist() == [5, 2, 7] and lists[2, :3].tolist() == [1, 1, 3]
    empty, lens = composite_tiles.tile_lists(pair_gauss[:0], torch.zeros(4, dtype=torch.int32))
    assert empty.shape == (3, 0) and lens.tolist() == [0, 0, 0]


@pytest.mark.parametrize("n_colors,append", [(2, True), (6, False)])
def test_the_three_backends_agree(n_colors, append):
    """backend "auto" (the kernels' plain versions here), "naive" and
    "tiles" on one map: images within 1e-4, gradients within 5e-5 of the
    largest magnitude of "auto"'s."""
    rng = np.random.default_rng(n_colors)
    n = 300
    s = dict(means=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                             rng.uniform(0.5, 5, n)], -1).astype(np.float32),
             colors=rng.uniform(0, 1, (n, n_colors)).astype(np.float32),
             quats=rng.normal(size=(n, 4)).astype(np.float32),
             logit=rng.normal(1.0, 0.8, n).astype(np.float32),
             logsc=np.log(rng.uniform(0.01, 0.08, (n, 3))).astype(np.float32))
    active = torch.tensor(rng.uniform(size=n) > 0.1)
    rows = n_colors + (3 if append else 0)
    w = torch.tensor(rng.normal(size=(rows, H, W)).astype(np.float32))
    out = {}
    for backend in ("auto", "naive", "tiles"):
        t = {k: torch.tensor(v).requires_grad_(True) for k, v in s.items()}
        img, radii, n_pairs = api.render_gaussians(CAM, *t.values(), active, backend=backend,
                                                   append_depth_channels=append)
        grads = torch.autograd.grad((img * w).sum(), list(t.values()))
        out[backend] = (img.detach(), radii, grads)
        assert img.shape == (rows, H, W) and (n_pairs > 0) == (backend != "naive")
    img_a, radii_a, grads_a = out["auto"]
    for backend in ("naive", "tiles"):
        img, radii, grads = out[backend]
        np.testing.assert_allclose(img.numpy(), img_a.numpy(), atol=1e-4, err_msg=backend)
        assert torch.equal(radii, radii_a)
        for name, mine, ref in zip(s, grads, grads_a):
            close(mine.numpy(), ref.numpy(), f"{backend} {name}")


def test_kernel_gradients_against_float64():
    """The kernels' semantics (the plain versions of K1 -> K2 -> K3, the
    "auto" backend on the CPU) against the naive backend in float64 on
    chip_smoke.py path 11's reference scene (2,000 anisotropic Gaussians
    at 160x120, its seed), where the card put the kernels 3.0e-5 of the
    largest gradient from the float32 naive and tiles backends. That gap
    is the float32 error of the reference rasterizer's backward, which
    recovers each pair's transmittance by dividing by (1 - alpha) on the
    back-to-front walk (render/composite.py); the float32 naive backend
    (forward-order autograd) lies closer to float64. Held: images within
    1e-5, gradients within the suite's 5e-5 of their largest."""
    from splatam_tpu_torch.core.gaussians import GaussianMap
    from splatam_tpu_torch.slam import steps

    n = 2000
    rng = np.random.default_rng(0)
    fields = dict(
        means3d=np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                          rng.uniform(1.0, 5, n)], -1).astype(np.float32),
        rgb_colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(n, 4)).astype(np.float32),
        logit_opacities=rng.normal(1.0, 0.5, n).astype(np.float32),
        log_scales=np.log(rng.uniform(0.01, 0.08, (n, 1))).astype(np.float32),
        active=rng.uniform(size=n) > 0.1,
    )
    fields["log_scales"] = np.log(rng.uniform(0.01, 0.08, (n, 3))).astype(np.float32)
    gm = GaussianMap(**{k: torch.tensor(v) for k, v in fields.items()})
    q, t = torch.tensor([0.99, 0.02, -0.03, 0.01]), torch.tensor([0.02, -0.01, 0.03])
    cam = Camera(height=120, width=160, fx=150.0, fy=150.0, cx=80.0, cy=60.0)
    with torch.no_grad():
        means, rots = steps.transform_to_frame(gm, q, t, False, False)
    gen = torch.Generator().manual_seed(12)
    colors = torch.rand((n, 3), generator=gen)
    w = torch.randn((3, cam.height, cam.width), generator=gen, dtype=torch.float64)
    out = {}
    for backend, dtype in (("auto", torch.float32), ("naive", torch.float64)):
        leaves = [a.detach().to(dtype).requires_grad_(True)
                  for a in (means, colors, rots, gm.logit_opacities, gm.log_scales)]
        with pytest.MonkeyPatch.context() as mp:  # the camera's w2c in the leaves' dtype
            w2c = Camera.w2c_tensor
            mp.setattr(Camera, "w2c_tensor", lambda self, device: w2c(self, device).to(dtype))
            img, _, _ = api.render_gaussians(cam, *leaves, gm.active, backend=backend,
                                             append_depth_channels=False)
            grads = torch.autograd.grad((img * w.to(dtype)).sum(), leaves)
        out[backend] = img.detach().double(), [g.double() for g in grads]
    (img, grads), (ref_img, ref_grads) = out["auto"], out["naive"]
    assert float((img - ref_img).abs().max()) <= 1e-5
    for name, g, r in zip(("means", "colors", "rotations", "opacities", "scales"), grads, ref_grads):
        assert float((g - r).abs().max() / r.abs().max()) <= GRAD_TOL, name
