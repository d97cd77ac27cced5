"""The port's 3DGS pieces against the JAX package's, on shared numpy inputs:
expon_lr, _alloc_slots, compact_with, densify_3dgs_step, gs_mapping_chunk
and the generic render's means2d_dummy harvest (slam/steps_gs.py,
core/gaussians.py, render/api.py).

The JAX side renders with its `tiles` backend on the CPU; the port runs
the kernels' plain versions (the tensors lie on the CPU). The port's split
noise (steps_gs.split_noise) is replaced by the JAX package's draws from
the same key (jax.random.split, jax.random.normal), so a pass writes the
same rows in both. Tolerances: expon_lr 1e-7 relative (float32 step by
step in both); slot allocation, compaction and every mask exactly; densify
fields 1e-6 (float32 reassociation in the split offset); the statistics'
gradient sums within 5e-5 of their largest value (the JAX suite's gradient
tolerance, tests/test_pallas_interpret.py:76-77), their counts and radii
exactly; trained parameters by tests/test_torch_slam.py's rule (at least
99% of entries within 1e-5).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from splatam_tpu.core import gaussians as JG
from splatam_tpu.core.camera import setup_camera as jsetup_camera
from splatam_tpu.render.api import RenderConfig, render_rgbd_sil as jrender
from splatam_tpu.slam import optim as joptim
from splatam_tpu.slam import steps_gs as jgs
from splatam_tpu_torch.core import gaussians as G
from splatam_tpu_torch.core.camera import setup_camera
from splatam_tpu_torch.data import frame_to_tensors, get_dataset
from splatam_tpu_torch.render import api
from splatam_tpu_torch.slam import optim, steps, steps_gs

torch.set_num_threads(1)

TILES = RenderConfig(backend="tiles", pair_cap=1 << 15, tile_k_max=2048)
FIELDS = ("means3d", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")


def jax_split_noise(seed: int):
    """A stand-in for steps_gs.split_noise that draws what the JAX package
    draws for the generator's seed: per pass, key, sub = split(key); the n
    children's samples from split(sub, n)."""
    keys = {}

    def noise(gen, n, capacity):
        s = gen.initial_seed()
        key, sub = jax.random.split(keys.get(s, jax.random.PRNGKey(s)))
        keys[s] = key
        ks = jax.random.split(sub, n)
        return torch.tensor(np.stack([np.asarray(jax.random.normal(ks[r], (capacity, 3)))
                                      for r in range(n)]), device=gen.device)

    return noise


@pytest.mark.parametrize("delay", [0, 1000], ids=["no_delay", "delay"])
def test_expon_lr_matches_jax(delay):
    """At every 37th step of a 30k schedule and at the delay's and the
    schedule's ends: within one float32 ulp of the JAX package's per
    transcendental on the path (XLA's float32 exp and sin are not correctly
    rounded; an ulp is 6e-8 to 1.2e-7 relative): exp alone without the
    delay, exp and sin with it; equal at most steps."""
    steps = sorted(set(range(0, 30001, 37)) | {1, 7, 999, 1000, 29999, 30000, 41000})
    ref = np.asarray([float(jgs.expon_lr(jnp.float32(s), 0.00032, 0.0000032,
                                         lr_delay_steps=delay, lr_delay_mult=0.01,
                                         max_steps=30000.0)) for s in steps], np.float32)
    got = np.asarray([steps_gs.expon_lr(s, 0.00032, 0.0000032, lr_delay_steps=delay,
                                        lr_delay_mult=0.01, max_steps=30000.0)
                      for s in steps], np.float32)
    np.testing.assert_array_max_ulp(got, ref, maxulp=2 if delay else 1)
    assert np.mean(got == ref) >= 0.8, np.mean(got == ref)


@pytest.mark.parametrize("n_want", [20, 70], ids=["fits", "overflows"])
def test_alloc_slots_matches_jax(n_want):
    rng = np.random.default_rng(n_want)
    active = rng.uniform(size=128) < 0.5
    want = np.zeros(128, bool)
    want[rng.choice(np.flatnonzero(active), min(n_want, active.sum()), replace=False)] = True
    jd, jw, jo = jgs._alloc_slots(jnp.asarray(active), jnp.asarray(want))
    d, w = steps_gs._alloc_slots(torch.tensor(active), torch.tensor(want))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    dropped = int(want.sum() - w.sum().item())
    assert dropped == int(jo)
    assert (dropped > 0) == (want.sum() > (~active).sum())


def _random_fields(rng, cap, s, n_active=None):
    active = (rng.uniform(size=cap) < 0.6 if n_active is None else np.arange(cap) < n_active)
    return dict(
        means3d=rng.normal(size=(cap, 3)).astype(np.float32),
        rgb_colors=rng.uniform(0, 1, (cap, 3)).astype(np.float32),
        unnorm_rotations=rng.normal(size=(cap, 4)).astype(np.float32),
        logit_opacities=rng.normal(0.0, 2.0, cap).astype(np.float32),
        log_scales=np.log(rng.uniform(0.005, 0.05, (cap, s))).astype(np.float32),
        active=active,
    )


def test_compact_with_matches_jax():
    rng = np.random.default_rng(3)
    f = _random_fields(rng, 64, 3)
    ts = rng.uniform(0, 9, 64).astype(np.float32)
    extras = ((rng.normal(size=(64, 3)).astype(np.float32),
               rng.normal(size=64).astype(np.float32)),
              tuple(rng.uniform(size=64).astype(np.float32) for _ in range(3)))
    jgm, jts, jex = JG.compact_with(JG.GaussianMap(**{k: jnp.asarray(v) for k, v in f.items()}),
                                    jnp.asarray(ts), jax.tree.map(jnp.asarray, extras))
    gsv = steps_gs.GSVariables(*(torch.tensor(x) for x in extras[1]))
    gm, t, ex = G.compact_with(G.GaussianMap(**{k: torch.tensor(v) for k, v in f.items()}),
                               torch.tensor(ts), ((torch.tensor(extras[0][0]),
                                                   torch.tensor(extras[0][1])), gsv))
    assert isinstance(ex[1], steps_gs.GSVariables)
    for k in G.GaussianMap._fields:
        np.testing.assert_array_equal(getattr(gm, k).numpy(), np.asarray(getattr(jgm, k)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jts))
    for mine, ref in zip(jax.tree.leaves((ex[0], tuple(ex[1]))), jax.tree.leaves(jex)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("iso,final,it", [(False, False, 100), (True, True, 5)],
                         ids=["anisotropic", "isotropic_final"])
def test_densify_3dgs_step_matches_jax(monkeypatch, iso, final, it):
    """The JAX suite's setup (tests/test_gs_densify.py) at a capacity with
    room for every clone and split, random moments, five Gaussians above
    0.1 scene_radius (pruned as big from remove_big_after=10 on, or split),
    statistics with unseen Gaussians (denom 0)."""
    rng = np.random.default_rng(7)
    cap, s = 256, 1 if iso else 3
    f = _random_fields(rng, cap, s, n_active=60)
    f["log_scales"][:5] = np.log(0.4)
    grads = rng.uniform(0, 6e-4, cap).astype(np.float32)
    denom = rng.integers(0, 3, cap).astype(np.float32)
    stats = (grads * denom, denom, rng.uniform(0, 5, cap).astype(np.float32))
    moments = [rng.normal(size=np.shape(f[k])).astype(np.float32) for k in FIELDS]
    cfg_kw = dict(grad_thresh=3e-4, num_to_split_into=2, removal_opacity_threshold=0.01,
                  final_removal_opacity_threshold=0.05, remove_big_after=10)
    scene_radius = 3.0

    jm = JG.GaussianMap(**{k: jnp.asarray(v) for k, v in f.items()})
    jst = joptim.AdamState(m=tuple(map(jnp.asarray, moments)),
                           v=tuple(jnp.asarray(np.abs(x)) for x in moments), step=jnp.int32(3))
    jgm, jgsv, jst2, jovf = jgs.densify_3dgs_step(
        jm, jgs.GSVariables(*map(jnp.asarray, stats)), jst, jnp.float32(scene_radius),
        jax.random.split(jax.random.PRNGKey(11))[1], jnp.int32(it),
        jgs.DensifyConfig(**cfg_kw), final=final)
    assert int(jovf) == 0

    monkeypatch.setattr(steps_gs, "split_noise", jax_split_noise(11))
    gm = G.GaussianMap(**{k: torch.tensor(v) for k, v in f.items()})
    st = optim.AdamState(m=tuple(map(torch.tensor, moments)),
                         v=tuple(torch.tensor(np.abs(x)) for x in moments), step=3)
    gsv = steps_gs.GSVariables(*map(torch.tensor, stats))
    cfg = steps_gs.DensifyConfig(**cfg_kw)
    n_clone, n_split = steps_gs.densify_counts(gm, gsv, scene_radius, cfg)
    gen = torch.Generator().manual_seed(11)
    gm2, gsv2, st2 = steps_gs.densify_3dgs_step(gm, gsv, st, scene_radius, gen, it, cfg, final)
    assert n_clone > 0 and n_split > 0
    np.testing.assert_array_equal(gm2.active.numpy(), np.asarray(jgm.active))
    for k in FIELDS:
        np.testing.assert_allclose(getattr(gm2, k).numpy(), np.asarray(getattr(jgm, k)),
                                   atol=1e-6, rtol=0, err_msg=k)
    slots = np.flatnonzero(~f["active"])[: n_clone + 2 * n_split]
    for mine, ref in zip(st2.m + st2.v, jst2.m + jst2.v):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
        assert not mine.numpy()[slots].any()
    for x in gsv2:
        assert not x.numpy().any()


@pytest.fixture(scope="module")
def frames():
    ds = get_dataset({"dataset_name": "synthetic", "num_frames": 3}, "", "box",
                     desired_height=48, desired_width=64)
    return [ds[i] for i in range(3)]


def test_gs_mapping_chunk_matches_jax(frames):
    """10 iterations at 48x64 with track_stats and the means3D schedule, on
    the first frame's anisotropic cloud, over the three frames."""
    color_np, depth_np, k4, _ = frames[0]
    cam = setup_camera(64, 48, k4[:3, :3])
    jcam = jsetup_camera(64, 48, k4[:3, :3])
    color, depth = frame_to_tensors(color_np, depth_np, "cpu")
    pts, cols, mean_sq, valid = steps.first_frame_pointcloud(color, depth, cam)
    gm = G.from_pointcloud(pts, cols, mean_sq, valid, 4096, isotropic=False)
    fields = {k: getattr(gm, k).numpy() for k in G.GaussianMap._fields}
    # Distinct scales per axis and random rotations, so the rotations get
    # real gradients (three equal scales make them float noise).
    rng = np.random.default_rng(0)
    fields["log_scales"] = fields["log_scales"] + rng.uniform(-0.3, 0.3, (4096, 3)).astype(
        np.float32)
    fields["unnorm_rotations"] = rng.normal(size=(4096, 4)).astype(np.float32)
    gm = G.GaussianMap(**{k: torch.tensor(v) for k, v in fields.items()})
    slots = rng.integers(0, 3, 10).astype(np.int32)
    poses = [np.linalg.inv(f[3]) for f in frames]
    from splatam_tpu.slam.pipeline import _quat_from_w2c
    qs = np.stack([_quat_from_w2c(poses[s]) for s in slots]).astype(np.float32)
    ts = np.stack([poses[s][:3, 3] for s in slots]).astype(np.float32)
    colors = np.stack([np.clip(f[0], 0, 255).astype(np.uint8) for f in frames])
    depths = np.stack([f[1][..., 0].astype(np.float32) for f in frames])
    lrs = (0.00032, 0.0025, 0.001, 0.05, 0.005)
    sched = (0.00032, 0.0000032, 0.01, 40.0)

    jm = JG.GaussianMap(**{k: jnp.asarray(v) for k, v in fields.items()})
    jst = joptim.adam_init(tuple(getattr(jm, k) for k in FIELDS))
    jgm, jgsv, _, jloss = jgs.gs_mapping_chunk(
        jm, jgs.GSVariables.zeros(4096), jst, jnp.asarray(colors), jnp.asarray(depths),
        jnp.asarray(slots), jnp.asarray(qs), jnp.asarray(ts), jnp.int32(5), jcam, 10, TILES,
        lrs, 0.5, 1.0, sched, True)

    st = optim.adam_init(tuple(getattr(gm, k) for k in FIELDS))
    gm2, gsv, st2, loss = steps_gs.gs_mapping_chunk(
        gm, steps_gs.GSVariables.zeros(4096, "cpu"), st, torch.tensor(colors),
        torch.tensor(depths), slots, torch.tensor(qs), torch.tensor(ts), 5, cam, 10, lrs, 0.5,
        1.0, sched, True)
    assert st2.step == 10
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    act = fields["active"]
    for k in FIELDS:
        diff = np.abs(getattr(gm2, k).numpy()[act] - np.asarray(getattr(jgm, k))[act])
        assert np.mean(diff > 1e-5) <= 0.01, (k, np.mean(diff > 1e-5))
    accum, ref = gsv.means2d_grad_accum.numpy(), np.asarray(jgsv.means2d_grad_accum)
    assert ref.max() > 0 and (ref > 0).sum() > 100
    np.testing.assert_allclose(accum, ref, atol=5e-5 * ref.max(), rtol=0)
    np.testing.assert_array_equal(gsv.denom.numpy(), np.asarray(jgsv.denom))
    np.testing.assert_array_equal(gsv.max_2d_radius.numpy(), np.asarray(jgsv.max_2d_radius))


@pytest.mark.parametrize("iso", [True, False], ids=["isotropic", "anisotropic"])
def test_means2d_dummy_gradient_matches_jax(iso):
    """The generic render's screen-space harvest: d loss / d means2d_dummy
    and the radii against the JAX package's render_rgbd_sil."""
    rng = np.random.default_rng(5)
    n = 512
    f = _random_fields(rng, n, 1 if iso else 3)
    f["means3d"] = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                             rng.uniform(-0.5, 5, n)], -1).astype(np.float32)
    f["log_scales"] = np.log(rng.uniform(0.01, 0.08, (n, f["log_scales"].shape[1]))
                             ).astype(np.float32)
    k = np.array([[60.0, 0, 32.0], [0, 60.0, 24.0], [0, 0, 1]])
    w = rng.normal(size=(6, 48, 64)).astype(np.float32)
    names = FIELDS + ("active",)

    def jloss(dummy):
        out = jrender(jsetup_camera(64, 48, k), *(jnp.asarray(f[x]) for x in names),
                      config=TILES, means2d_dummy=dummy)
        img = jnp.concatenate([out.im, out.depth[None], out.silhouette[None],
                               out.depth_sq[None]])
        return jnp.sum(img * w), out.radii

    (_, jradii), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.zeros((n, 2)))
    dummy = torch.zeros((n, 2), requires_grad=True)
    out = api.render_rgbd_sil(setup_camera(64, 48, k), *(torch.tensor(f[x]) for x in names),
                              means2d_dummy=dummy)
    img = torch.cat([out.im, out.depth[None], out.silhouette[None], out.depth_sq[None]])
    (grad,) = torch.autograd.grad((img * torch.tensor(w)).sum(), dummy)
    ref = np.asarray(jgrad)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(grad.numpy(), ref, atol=5e-5 * np.abs(ref).max(), rtol=0)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(jradii))
    assert (out.radii.numpy() > 0).sum() > n // 4


def test_eval_of_fewer_frames_than_the_trajectory_matches_jax(frames, tmp_path):
    """eval_sequence over two frames of a 3-frame trajectory (the offline
    programs evaluate eval_num_frames frames at eval_stride): the evaluated
    frames do not cover the trajectory, and both packages report the
    reference's ATE of 100 with the same image metrics."""
    from splatam_tpu.eval.evaluate import eval_sequence as jeval
    from splatam_tpu_torch.eval.evaluate import eval_sequence

    color_np, depth_np, k4, _ = frames[0]
    cam = setup_camera(64, 48, k4[:3, :3])
    pts, cols, mean_sq, valid = steps.first_frame_pointcloud(
        *frame_to_tensors(color_np, depth_np, "cpu"), cam)
    params = G.compact_to_numpy(G.from_pointcloud(pts, cols, mean_sq, valid, 4096, False))
    w2cs = [np.linalg.inv(f[3]) for f in frames]
    from splatam_tpu.slam.pipeline import _quat_from_w2c
    params["cam_unnorm_rots"] = np.stack([_quat_from_w2c(w) for w in w2cs], -1)[None]
    params["cam_trans"] = np.stack([w[:3, 3] for w in w2cs], -1)[None].astype(np.float32)
    strided = get_dataset({"dataset_name": "synthetic", "num_frames": 2}, "", "box",
                          desired_height=48, desired_width=64)
    common = dict(sil_thres=0.5, mapping_iters=10, add_new_gaussians=True, eval_every=1)
    ref = jeval(strided, params, len(strided), str(tmp_path / "jax"), rcfg=TILES,
                save_plots=False, **common)
    mine = eval_sequence(strided, params, len(strided), str(tmp_path / "port"), device="cpu",
                         save_plots=False, **common)
    assert len(strided) == 2 and ref["ate_rmse"] == mine["ate_rmse"] == 100.0
    assert abs(mine["psnr"] - ref["psnr"]) <= 0.05
    assert abs(mine["depth_l1"] - ref["depth_l1"]) <= 1e-4
