"""The generic render's projection kernels (csrc/projection.cu) and their
plain versions.

On the CPU: project_backward_plain, the closed-form gradient the backward
kernel computes, against autograd of _prep_gaussians + `project` in float64
(every gradient within 1e-9 of its column's largest) and against jax.vjp
of the JAX package's _prep_gaussians + project (float64 under
jax.enable_x64; within 1e-9 too), on families of Gaussians that take each
branch: behind the near plane, beyond both frustum clamps and on their
edges, det <= 0, opacity under 1/255, log scales [N, 1] and [N, 3]. On a
clamp's edge PyTorch passes the gradient (a closed interval) and JAX does
not, and on det <= 0 lanes one rounding decides the branch, so those two
families are held to autograd alone. Each subset of the inputs autograd
may ask for (tracking's means, mapping's four, none), intrinsics_override
and lim_wh; CPU tensors take `project` through autograd.

The kernels themselves are held to `project` and to the twin on the card
in tests/test_torch_kernels.py (CUDA only), on this file's families.
"""
import numpy as np
import pytest
import torch

from splatam_tpu_torch.core.camera import Camera
from splatam_tpu_torch.render import api, projection

W, H, FX, FY, CX, CY = 64, 48, 60.0, 55.0, 32.3, 24.1
LIMX, LIMY = 1.3 * (W / (2.0 * FX)), 1.3 * (H / (2.0 * FY))
TOL64 = 1e-9
FAMILIES = ("random", "behind_near_plane", "clamped", "clamp_edge", "det_le_zero", "faint")
JAX_FAMILIES = ("random", "behind_near_plane", "clamped", "faint")
MAPPING = (True, True, True, True)
TRACKING = (True, False, False, False)
NONE = (False, False, False, False)


def _w2c(general: bool, seed: int = 0) -> np.ndarray:
    w2c = np.eye(4)
    if general:
        rng = np.random.default_rng(seed)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        w2c[:3, :3] = q * np.sign(np.linalg.det(q))
        w2c[:3, 3] = [0.1, -0.2, 0.3]
    return w2c


def _family(name: str, cols: int, seed: int = 0, n: int = 256) -> dict:
    """Leaves (float64 numpy) and a w2c whose projection takes the family's
    branch in most lanes; "random" has some of every branch but the edges."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 5.0, n)
    x, y = rng.uniform(-1.2, 1.2, n) * LIMX * z, rng.uniform(-1.2, 1.2, n) * LIMY * z
    logit = rng.normal(1.0, 1.0, n)
    log_scales = np.log(rng.uniform(0.01, 0.3, (n, cols)))
    general = name == "random"
    if name == "random":
        z = rng.uniform(-0.5, 5.0, n)
        x, y = rng.uniform(-3, 3, n), rng.uniform(-2, 2, n)
    elif name == "behind_near_plane":
        z = np.where(rng.uniform(size=n) < 0.5, rng.uniform(-1.0, 0.2, n), z)
        z[:8] = projection.NEAR_CLIP
    elif name == "clamped":
        x = rng.choice([-1.0, 1.0], n) * rng.uniform(1.5, 4.0, n) * LIMX * z
        y = rng.choice([-1.0, 1.0], n) * rng.uniform(1.5, 4.0, n) * LIMY * z
    elif name == "clamp_edge":  # px / safe_tz exactly +-limx, +-limy
        z = np.ones(n)
        x = rng.choice([-LIMX, LIMX], n)
        y = np.where(rng.uniform(size=n) < 0.5, rng.choice([-LIMY, LIMY], n), y)
    elif name == "det_le_zero":  # one huge axis: c00 c11 and c01^2 round to one another
        assert cols == 3
        log_scales = np.stack([np.full(n, 18.0), np.full(n, -18.0), rng.uniform(-3, -1, n)], -1)
    elif name == "faint":  # opacity under 1/255
        logit = rng.uniform(-9.0, -6.0, n)
    return dict(means=np.stack([x, y, z], -1), quats=rng.normal(size=(n, 4)), logit=logit,
                log_scales=log_scales, active=rng.uniform(size=n) > 0.1, w2c=_w2c(general, seed))


def _torch(f: dict, dtype=torch.float64, device="cpu") -> dict:
    return {k: torch.tensor(v, dtype=torch.bool if k == "active" else dtype, device=device)
            for k, v in f.items()}


def _autograd(t: dict, needs, cot, lim_wh=None, intr=(FX, FY, CX, CY)):
    """Gradients of _prep_gaussians + project by autograd, None where not asked."""
    leaves = [t[k].clone().requires_grad_(need)
              for k, need in zip(("means", "quats", "logit", "log_scales"), needs)]
    quats, logit, scales = api._prep_gaussians(*leaves[1:])
    proj, _ = projection.project(leaves[0], quats, logit, scales, t["active"], t["w2c"], *intr,
                                 W, H, lim_wh=lim_wh)
    wrt = [x for x in leaves if x.requires_grad]
    outs = [(o, c) for o, c in zip(proj, cot) if o.requires_grad]
    got = iter(torch.autograd.grad([o for o, _ in outs], wrt, [c for _, c in outs])
               if wrt else [])
    return [next(got) if need else None for need in needs]


def _cot(n: int, seed: int, dtype=torch.float64, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g, dtype=dtype).to(device)
            for shape in ((n, 2), (n,), (n, 3), (n,))]


def _twin(t: dict, cot, needs=MAPPING, lim_wh=None, intr=(FX, FY, CX, CY)):
    return projection.project_backward_plain(cot, t["means"], t["quats"], t["logit"],
                                             t["log_scales"], t["w2c"], *intr, W, H,
                                             lim_wh=lim_wh, needs=needs)


def _close(got, ref, tol: float) -> None:
    """Every column within tol of the reference column's largest magnitude."""
    n = ref.shape[0]
    got, ref = got.double(), ref.double()
    err = (got - ref).abs().reshape(n, -1).amax(0)
    scale = ref.abs().reshape(n, -1).amax(0).clamp_min(1e-300)
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert float((err / scale).max()) <= tol, (err / scale).tolist()


def _close_grads(got, ref, tol: float, cols: int, tol_cov: float | None = None) -> None:
    """(means, quats, logits, log scales) gradients: each column within tol
    (quats and log scales of an anisotropic map within tol_cov, if given).
    An isotropic map's quaternion gradient is zero in exact arithmetic, so
    both sides are rounding there: each held under tol of the log-scale
    gradient's largest."""
    for i, (g, r) in enumerate(zip(got, ref)):
        assert (g is None) == (r is None)
        if g is None:
            continue
        if i == 1 and cols == 1:
            scale = float(ref[3].abs().max()) if ref[3] is not None else float(r.abs().max())
            assert float(g.abs().max()) <= tol * scale and float(r.abs().max()) <= tol * scale
        else:
            _close(g, r, tol_cov if tol_cov is not None and cols == 3 and i in (1, 3) else tol)


CASES = [(f, c) for f in FAMILIES for c in (1, 3) if not (f == "det_le_zero" and c == 1)]


@pytest.mark.parametrize("family,cols", CASES)
def test_backward_twin_is_autograd_of_project(family, cols):
    f = _family(family, cols, seed=len(family) + cols)
    t = _torch(f)
    if family == "det_le_zero":  # the family takes both branches of det_ok
        s = projection.project_state(t["means"], t["quats"], t["log_scales"], t["w2c"], FX, FY,
                                     CX, CY, W, H)
        assert int((s.det == 0).sum()) > 0 and int((s.det < 0).sum()) > 0
    if family == "clamp_edge":
        s = projection.project_state(t["means"], t["quats"], t["log_scales"], t["w2c"], FX, FY,
                                     CX, CY, W, H)
        assert int((s.vx.abs() == LIMX).sum()) > 0 and int((s.vy.abs() == LIMY).sum()) > 0
    cot = _cot(len(f["logit"]), 1)
    _close_grads(_twin(t, cot), _autograd(t, MAPPING, cot), TOL64, cols)


@pytest.mark.parametrize("family,cols", [(f, c) for f in JAX_FAMILIES for c in (1, 3)])
def test_backward_twin_is_jax_vjp_of_project(family, cols):
    import jax
    import jax.numpy as jnp

    from splatam_tpu.render import api as japi
    from splatam_tpu.render import projection as jprojection

    f = _family(family, cols, seed=100 + len(family) + cols)
    cot = _cot(len(f["logit"]), 2)
    with jax.enable_x64(True):
        def fn(means, quats, logit, log_scales):
            q, lo, sc = japi._prep_gaussians(quats, logit, log_scales)
            proj, _ = jprojection.project(means, q, lo, sc, jnp.asarray(f["active"]),
                                          jnp.asarray(f["w2c"]), FX, FY, CX, CY, W, H)
            return tuple(proj)

        args = [jnp.asarray(f[k], jnp.float64) for k in ("means", "quats", "logit", "log_scales")]
        _, vjp = jax.vjp(fn, *args)
        ref = [torch.tensor(np.asarray(g)) for g in vjp(tuple(jnp.asarray(c.numpy())
                                                              for c in cot))]
    _close_grads(_twin(_torch(f), cot), ref, TOL64, cols)


@pytest.mark.parametrize("needs", [TRACKING, MAPPING, NONE, (False, False, True, False)],
                         ids=["tracking", "mapping", "none", "opacity"])
def test_backward_twin_writes_only_what_is_asked(needs):
    f = _family("random", 3, seed=7)
    t = _torch(f)
    cot = _cot(len(f["logit"]), 3)
    got = _twin(t, cot, needs)
    assert [g is not None for g in got] == list(needs)
    _close_grads(got, _autograd(t, needs, cot), TOL64, 3)


@pytest.mark.parametrize("cols", [1, 3])
def test_backward_twin_takes_intrinsics_override_and_lim_wh(cols):
    """A band's projection: other intrinsics and the full image's clamp."""
    f = _family("clamped", cols, seed=11)
    t = _torch(f)
    intr, lim_wh = (58.0, 57.0, 31.0, 9.5), (W, 3 * H)
    cot = _cot(len(f["logit"]), 4)
    got = _twin(t, cot, lim_wh=lim_wh, intr=intr)
    _close_grads(got, _autograd(t, MAPPING, cot, lim_wh=lim_wh, intr=intr), TOL64, cols)
    # and not the default clamp's gradient
    assert not torch.allclose(got[0], _twin(t, cot, intr=intr)[0])


def test_none_cotangents_are_zeros():
    f = _family("random", 3, seed=12)
    t = _torch(f)
    cot = _cot(len(f["logit"]), 5)
    sparse = [cot[0], None, cot[2], None]
    dense = [cot[0], torch.zeros_like(cot[1]), cot[2], torch.zeros_like(cot[3])]
    for a, b in zip(_twin(t, sparse), _twin(t, dense)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("override", [False, True])
def test_cpu_tensors_take_project_through_autograd(override):
    f = _family("random", 1, seed=13)
    t = _torch(f, torch.float32)
    w2c = tuple(tuple(float(v) for v in row) for row in f["w2c"])
    cam = Camera(height=H, width=W, fx=FX, fy=FY, cx=CX, cy=CY, w2c=w2c)
    intr, lim_wh = ((58.0, 57.0, 31.0, 9.5), (W, 3 * H)) if override else (None, None)
    means = t["means"].requires_grad_(True)
    before = (projection.project_forward.launches, projection.project_backward.launches)
    proj, aux = api.project_gaussians(cam, means, t["quats"], t["logit"], t["log_scales"],
                                      t["active"], intrinsics_override=intr, lim_wh=lim_wh)
    assert "ProjectGauss" not in type(proj.xy.grad_fn).__name__
    quats, logit, scales = api._prep_gaussians(t["quats"], t["logit"], t["log_scales"])
    ref, ref_aux = projection.project(means, quats, logit, scales, t["active"],
                                      cam.w2c_tensor("cpu"), *(intr or (FX, FY, CX, CY)), W, H,
                                      lim_wh=lim_wh)
    for a, b in zip((*proj, *aux), (*ref, *ref_aux)):
        assert torch.equal(a, b)
    proj.xy.sum().backward()
    assert (projection.project_forward.launches,
            projection.project_backward.launches) == before


def test_project_consts_are_projects_scalars():
    """The kernels' camera arguments: w2c row-major, then project's scalars."""
    w2c = _w2c(True, 3)
    c = projection.project_consts(w2c.tolist(), FX, FY, CX, CY, W, H, (W, 2 * H))
    assert len(c) == 24
    assert c[:12] == (*w2c[:3, :3].ravel(), *w2c[:3, 3])
    assert c[12:] == (FX, FY, 2.0 * FX / W, (W - 2.0 * CX) / W, 2.0 * FY / H,
                      (H - 2.0 * CY) / H, LIMX, 1.3 * (2 * H / (2.0 * FY)), W, H, 4, 3)
