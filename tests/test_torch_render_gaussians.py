"""The port's render_gaussians (the generic render of any channels) against
the JAX package's, on shared numpy inputs.

The JAX side runs backend="pallas" under the TPU interpreter, as
tests/test_pallas_interpret.py does; the port runs backend="auto", whose
kernels take their plain versions on the CPU. Kernel channel counts 1, 3,
5 and 10 (the colours, plus z and z^2 when depth is appended), in both
append modes where the count allows it, isotropic and anisotropic maps.
Tolerances are the JAX suite's own (test_pallas_interpret.py:76-77):
images 1e-4 absolute, every gradient within 5e-5 of its own largest
magnitude; radii equal. A seeded cotangent weighs every output row.

The gradients are also held to the JAX package's naive backend, its
oracle, at the same tolerance. The Pallas interpreter's gradients carry
float32 noise of their own: on one of these scenes its rotation gradient
lies 5.8e-5 of the largest from the naive backend's, and the JAX tiles
backend's lies there too. So each element of the port's gradient may lie
from the Pallas one by the tolerance plus the naive backend's own distance
from it there, and must lie within the tolerance of the naive one.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.render.api import RenderConfig
from splatam_tpu.render.api import render_gaussians as jrender
from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.render import api, composite

# one intra-op thread per test worker (see test_torch_generic_render.py)
torch.set_num_threads(1)

H, W = 48, 64
JCAM = JCamera(height=H, width=W, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CAM = Camera(height=H, width=W, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
CFG_P = RenderConfig(backend="pallas", pair_cap=1 << 12, tile_k_max=512)
GRAD_TOL = 5e-5
NAMES = ("means", "colors", "quats", "logit", "logsc")


def scene(n_colors, iso, n=384, seed=0):
    """Some Gaussians lie behind the camera; colours [n, n_colors]."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(-0.5, 5, n)], -1).astype(np.float32)
    return dict(
        means=means,
        colors=rng.uniform(0, 1, (n, n_colors)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        logit=rng.normal(1.0, 0.5, n).astype(np.float32),
        logsc=np.log(rng.uniform(0.01, 0.08, (n, 1 if iso else 3))).astype(np.float32),
        active=rng.uniform(size=n) > 0.1,
    )


def close_grad(mine, ref, name, oracle):
    """mine within GRAD_TOL of the oracle's largest magnitude of the oracle,
    and of ref's largest magnitude plus the oracle's own distance from
    ref, element by element."""
    ref, oracle = np.asarray(ref), np.asarray(oracle)
    assert np.isfinite(mine).all(), name
    np.testing.assert_allclose(mine, oracle, atol=GRAD_TOL * (np.abs(oracle).max() + 1e-8),
                               rtol=0, err_msg=f"{name} (naive)")
    slack = GRAD_TOL * (np.abs(ref).max() + 1e-8) + np.abs(oracle - ref)
    bad = np.abs(mine - ref) > slack
    assert not bad.any(), (f"{name} (pallas): {int(bad.sum())} elements, worst "
                           f"{float(np.abs(mine - ref)[bad].max())}")


def both(s, append, jcam=JCAM, cam=CAM, seed=1, **kw):
    """(JAX image, radii, grads, the naive backend's grads; the port's
    image, radii, grads) of the same weighted sum of every output row."""
    rows = s["colors"].shape[1] + (3 if append else 0)
    w = np.random.default_rng(seed).normal(size=(rows, cam.height, cam.width)).astype(np.float32)
    active = jnp.asarray(s["active"])
    jkw = {k: (tuple(jnp.float32(x) for x in v) if k == "intrinsics_override" else v)
           for k, v in kw.items()}

    def jax_side(cfg):
        def jloss(*a):
            img, radii, _, _ = jrender(jcam, *a, active, config=cfg,
                                       append_depth_channels=append, **jkw)
            return jnp.sum(img * w), (img, radii)

        return jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            *(jnp.asarray(s[k]) for k in NAMES))

    with pltpu.force_tpu_interpret_mode():
        (_, (img_j, radii_j)), grads_j = jax_side(CFG_P)
    _, grads_naive = jax_side(RenderConfig(backend="naive"))
    t = {k: torch.tensor(v).requires_grad_(k != "active") for k, v in s.items()}
    img, radii, _ = api.render_gaussians(cam, *(t[k] for k in NAMES), t["active"],
                                         append_depth_channels=append, **kw)
    grads = torch.autograd.grad((img * torch.tensor(w)).sum(), [t[k] for k in NAMES])
    return (np.asarray(img_j), np.asarray(radii_j), grads_j, grads_naive), (img, radii, grads)


def check(jax_out, port_out, iso):
    (img_j, radii_j, grads_j, grads_naive), (img, radii, grads) = jax_out, port_out
    assert img.shape == img_j.shape
    np.testing.assert_allclose(img.detach().numpy(), img_j, atol=1e-4)
    np.testing.assert_array_equal(radii.numpy(), radii_j)
    for name, mine, ref, oracle in zip(NAMES, grads, grads_j, grads_naive):
        if iso and name == "quats":
            # a spherical covariance does not depend on the rotation: both
            # gradients are float32 noise, which only has to stay finite
            assert torch.isfinite(mine).all() and float(mine.abs().max()) < 1e-2
            continue
        close_grad(mine.numpy(), ref, name, oracle)


# (kernel channel count, append_depth_channels, isotropic): ch = colours + 2
# with depth appended (its z and z^2; the silhouette comes from the
# transmittance), colours without
CASES = [(1, False, True), (3, False, False), (3, True, True), (5, False, True),
         (5, True, True), (5, True, False), (10, False, False), (10, True, True)]


@pytest.mark.parametrize("ch,append,iso", CASES,
                         ids=[f"ch{c}-{'depth' if a else 'nodepth'}-{'iso' if i else 'aniso'}"
                              for c, a, i in CASES])
def test_render_gaussians_matches_pallas_interpret(ch, append, iso):
    s = scene(ch - 2 if append else ch, iso, seed=ch)
    check(*both(s, append, seed=ch + 1), iso)


def test_intrinsics_override_and_lim_wh_on_a_band_match_jax():
    """The image's rows from one tile row down as a band of its own: the
    band's height, cy moved up by its first row, the full image's frustum
    clamp."""
    s = scene(3, False, seed=7)
    top = 16
    jcam = JCamera(height=H - top, width=W, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
    cam = Camera(height=H - top, width=W, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
    kw = dict(intrinsics_override=(60.0, 60.0, 32.0, 24.0 - top), lim_wh=(W, H))
    jax_out, port_out = both(s, True, jcam, cam, seed=8, **kw)
    check(jax_out, port_out, iso=False)
    # the band is the full render's rows from `top` down, but for the
    # rounding of centres projected through the shifted cy (z^2 up to ~25)
    full, _, _ = api.render_gaussians(CAM, *(torch.tensor(s[k]) for k in NAMES),
                                      torch.tensor(s["active"]))
    np.testing.assert_allclose(port_out[0].detach().numpy(), full[:, top:].numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("ch", [0, 11])
def test_check_rows_rejects_channel_counts_the_kernels_do_not_take(ch):
    attrs = torch.zeros((4, 6 + ch))
    with pytest.raises(ValueError, match="1 to 10 channels"):
        composite._check_rows(attrs, None, torch.zeros(2, dtype=torch.int32), 16, 16)


def test_render_gaussians_rejects_more_channels_than_the_kernels_take():
    """Nine colours with depth appended make 11 kernel channels: the kernel
    backend raises on either device, as the TPU kernel fails; the
    references take any count."""
    s = scene(9, True, n=64, seed=9)
    t = [torch.tensor(s[k]) for k in (*NAMES, "active")]
    with pytest.raises(ValueError, match="1 to 10 channels"):
        api.render_gaussians(CAM, *t)
    for backend in ("naive", "tiles"):
        img, _, _ = api.render_gaussians(CAM, *t, backend=backend)
        assert img.shape == (12, H, W)
    with pytest.raises(ValueError, match="backend"):
        api.render_gaussians(CAM, *t, backend="xla")
