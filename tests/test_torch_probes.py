"""The fused forward's probe kernels (render/probes.py) and the port's
measurement scripts (splatam_tpu_torch/scripts/), on the CPU.

The plain versions are held to the JAX package on one synthetic map
(scripts/scene.py, the JAX probe scripts' map, at 64x48 with ~500 pairs per
tile), built from the same numpy seed for both packages:
  * fwd2 and math_only against fused_forward_pallas under the TPU
    interpreter; for math_only the JAX kernel gets its own world-8 rows
    remapped column for column so that pair k of a tile takes the row of the
    tile's pair k mod 128. Channels within atol 1e-4; n_contrib equal except
    where a pixel's transmittance lands within float32 rounding of the
    T < 1e-4 stop (the TPU kernel multiplies transmittances in log space):
    there the port's final T must lie within 1% of 1e-4, and at most 0.1% of
    the pixels may stop one hit apart (one pixel of 3,072 at logit 1.0);
  * dma_only, dma_b2 and dma_b4 against numpy written from the TPU kernel
    bodies (scripts/probe_dma.py:134-145, :192-204) on the JAX structure's
    world8, pad_start and lens, padding columns masked; rtol 1e-5 (the same
    float32 sums in the same order).
The kernels themselves are held to these plain versions on the card
(tests/test_torch_kernels.py). The scripts run at a micro size with
--device cpu and print every line; without it, on a machine with no GPU,
they exit non-zero.
"""
import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from splatam_tpu.core.camera import Camera as JCamera
from splatam_tpu.core.gaussians import GaussianMap as JMap
from splatam_tpu.render.api import RenderConfig
from splatam_tpu.render.pallas import fused_iso as jfused
from splatam_tpu.slam import steps as jsteps
from splatam_tpu_torch.render import bounds, composite, fused_iso, probes
from splatam_tpu_torch.scripts import probe_dma, probe_unroll, profile_iter, scene

torch.set_num_threads(1)

W, H, N = 64, 48, 150_000
C = probes.C
CFG_P = RenderConfig(backend="pallas", pair_cap=1 << 15, tile_k_max=2048)
MICRO = ["--device", "cpu", "--n", "20000", "--h", "48", "--w", "64", "--reps", "1",
         "--iters", "1"]


def _jax_inputs(logit):
    """The JAX package's structure and pose vector for the scene."""
    cam = scene.scene_camera(W, H)
    jcam = JCamera(height=H, width=W, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
    jgm = JMap(**{k: jnp.asarray(v) for k, v in scene.scene_arrays(N, logit).items()})
    q, t = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32), jnp.zeros(3, jnp.float32)
    ps = jsteps.loss_pair_structure(jgm, q, t, jcam, CFG_P, with_world16=True)
    limx, limy = 1.3 * W / (2.0 * cam.fx), 1.3 * H / (2.0 * cam.fy)
    pose = jfused.make_pose_vec(jnp.eye(3, dtype=jnp.float32), t, cam.fx, cam.fy, cam.cx,
                                cam.cy, limx, limy)
    return ps, pose


class PortInputs(NamedTuple):
    world8: torch.Tensor  # [P, 8]
    tile_start: torch.Tensor  # [T + 1]
    pose: torch.Tensor  # [24]
    n_pairs: int


@pytest.fixture(scope="module", params=[-2.0, 1.0], ids=["logit-2", "logit1"])
def both(request):
    """(JAX structure, JAX pose, the port's inputs) at one opacity. The
    port's own binning must give the same tiles and pair counts; its kernels
    then get the JAX structure's rows in the port's layout (unpadded [P, 8]),
    so both packages composite the same floats in the same order (the two
    binnings can order two pairs of equal quantized depth apart, and their
    exp rounds s^2 an ulp apart)."""
    logit = request.param
    jps, jpose = _jax_inputs(logit)
    gm, q, t, cam = scene.synthetic_scene(N, W, H, logit, "cpu")
    tps, pose = scene.fused_inputs(gm, q, t, cam)
    n = int(jps.bins.n_pairs)
    assert tps.n_pairs == n
    np.testing.assert_array_equal(tps.tile_start.numpy(), np.asarray(jps.bins.tile_start))
    lens, pad_start = np.asarray(jps.lens), np.asarray(jps.pad_start)
    cols = np.concatenate([pad_start[i] + np.arange(k) for i, k in enumerate(lens)])
    w8 = torch.tensor(np.ascontiguousarray(np.asarray(jps.world8)[:, cols].T))
    same = np.isclose(w8.numpy(), tps.world8.numpy(), rtol=1e-6, atol=1e-9).all(1)
    assert same.mean() >= 0.999
    return jps, jpose, PortInputs(w8, tps.tile_start, pose, n)


def _pallas_image(world8, jps, jpose):
    gx = math.ceil(W / 16)
    with pltpu.force_tpu_interpret_mode():
        out = jfused.fused_forward_pallas(world8, jpose, jps.pad_start, jps.lens, gx,
                                          gx * math.ceil(H / 16), W, H)
    return composite.assemble_image(torch.tensor(np.asarray(out)).permute(1, 0, 2), W, H)


def _check_against_pallas(mine, ref):
    channels, nc = slice(0, composite.CH + 1), composite.CH + 1
    flipped = mine[nc] != ref[nc]
    t_final = 1.0 - mine[composite.CH][flipped]
    assert int(flipped.sum()) <= 1e-3 * flipped.numel()
    assert bool(((t_final - composite.T_EPS).abs() <= 1e-2 * composite.T_EPS).all())
    agree = (~flipped)[None]
    np.testing.assert_allclose((mine[channels] * agree).numpy(), (ref[channels] * agree).numpy(),
                               atol=1e-4)


def test_fwd2_plain_matches_pallas_interpret(both):
    jps, jpose, port = both
    before = probes.fwd2.launches
    mine = probes.fwd2(port.world8, port.pose, port.tile_start, W, H)
    assert probes.fwd2.launches == before  # CPU tensors take the plain version
    assert torch.equal(mine, fused_iso.fused_forward_plain(port.world8, port.pose, port.tile_start,
                                                           W, H))
    _check_against_pallas(mine, _pallas_image(jps.world8, jps, jpose))


def test_math_only_plain_matches_pallas_on_remapped_rows(both):
    jps, jpose, port = both
    lens, pad_start = np.asarray(jps.lens), np.asarray(jps.pad_start)
    assert lens.max() > 4 * C  # the first chunk is composited five times or more
    cols = np.arange(jps.world8.shape[1])
    for s, k in zip(pad_start, lens):
        cols[s:s + k] = s + np.arange(k) % C
    mine = probes.math_only(port.world8, port.pose, port.tile_start, W, H)
    _check_against_pallas(mine, _pallas_image(jps.world8[:, cols], jps, jpose))
    starts = port.tile_start[:-1].tolist()
    np.testing.assert_array_equal(
        probes.first_chunk_rows(port.tile_start, port.n_pairs).numpy(),
        np.concatenate([s + np.arange(k) % C for s, k in zip(starts, lens)]))


def test_probe_walks_do_not_change_under_the_cull(both):
    """fwd2 and math_only run K4's culled walk on the card (math_only takes
    the warp masks of its first chunk once and walks them in every round):
    the cull must change no bit of either plain image, and math_only's rows
    are K4's index mode with pair_gauss = first_chunk_rows."""
    _, _, port = both
    args = (port.pose, port.tile_start, W, H)
    remap = probes.first_chunk_rows(port.tile_start, port.n_pairs).int()
    assert torch.equal(
        probes.math_only_plain(port.world8, *args),
        fused_iso.fused_forward_plain(port.world8, *args, pair_gauss=remap, cull=composite.WARP_W))
    assert torch.equal(
        probes.fwd2_plain(port.world8, *args),
        fused_iso.fused_forward_plain(port.world8, *args, cull=composite.WARP_W))


def _dma_reference(world8, pad_start, lens, b):
    """The TPU kernels' sums: per tile, lane l adds row 0 of columns
    s + i*b*C + l for every block i, padding columns (past lens) masked."""
    out = np.zeros((len(lens), C), np.float32)
    for t, (s, num) in enumerate(zip(pad_start, lens)):
        chunks = -(-num // C)
        for i in range(-(-chunks // b)):
            k = i * b * C + np.arange(C)
            out[t] += np.where(k < num, world8[0, np.minimum(s + k, world8.shape[1] - 1)], 0.0)
    return out


@pytest.mark.parametrize("b", probes.DMA_BLOCKS)
def test_dma_walk_plain_matches_tpu_kernel_bodies(both, b):
    jps, _, port = both
    ref = _dma_reference(np.asarray(jps.world8), np.asarray(jps.pad_start),
                         np.asarray(jps.lens), b)
    mine = probes.dma_walk(port.world8, port.tile_start, b)
    assert mine.shape == (port.tile_start.shape[0] - 1, C)
    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_walk_counts_follow_the_plain_walk(both):
    _, _, port = both
    xy, conic, op, _ = fused_iso.project_pairs_plain(port.world8, port.pose, W, H)
    wc = bounds.walk_counts(xy, conic, op, port.tile_start, W, H)
    img = fused_iso.fused_forward_plain(port.world8, port.pose, port.tile_start, W, H)
    lens = (port.tile_start[1:] - port.tile_start[:-1]).long()
    assert wc.bwd_evals == int(img[-1].sum())  # the backward walks stop at n_contrib
    assert wc.bwd_reach == int(composite.to_tiles(img[-1:])[0].amax(1).sum())
    assert wc.applied <= wc.hits <= wc.alpha <= wc.evals <= int(lens.sum()) * 256
    terminated = wc.hits - wc.applied  # one stopping hit per terminated pixel
    assert (terminated == 0) == (wc.evals == int(lens.sum()) * 256)
    assert wc.bwd_alpha <= wc.alpha and wc.unclamped <= wc.applied


def test_roofline_picks_the_larger_time():
    assert bounds.roofline(int(3.35e9), 0) == (pytest.approx(1.0), "bytes")
    assert bounds.roofline(0, int(67e9)) == (pytest.approx(1.0), "operations")
    ms, by = bounds.roofline(int(3.35e9), int(2 * 67e9))
    assert (ms, by) == (pytest.approx(2.0), "operations")


PROBE_LINES = {
    probe_unroll: ["parity fwd2 vs K4: equal=True", "full", "fwd2"],
    probe_dma: ["full", "dma_only", "dma_b2", "dma_b4", "math_only"],
}


@pytest.mark.parametrize("mod", [probe_unroll, probe_dma], ids=["probe_unroll", "probe_dma"])
def test_probe_scripts_print_every_probe_on_cpu(mod, capsys):
    times = mod.main(MICRO)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device=cpu") and "pairs=" in out[0]
    for want in PROBE_LINES[mod]:
        assert any(line.startswith(want) for line in out[1:]), want
    assert all(tm.event is None and tm.busy is None and tm.wall > 0 for tm in times.values())


STAGES = ["projection fwd", "ps build (proj + bins)", "  proj + build_bins",
          "K1 composite forward", "K2 composite backward", "K3 segment reduce (11 columns)",
          "mapping get_loss fwd ONLY", "tracking get_loss fwd+bwd (reused ps)",
          "tracking get_loss fwd+bwd (pair-space)", "mapping get_loss fwd+bwd"]
SUMMARY = ["pair_structure build", "forward render", "tracking fwd+bwd", "mapping  fwd+bwd",
           "summary (wall)"]


@pytest.mark.parametrize("stages", [False, True], ids=["summary", "stages"])
def test_profile_iter_prints_every_stage_on_cpu(stages, capsys):
    results = profile_iter.main(MICRO + (["--stages"] if stages else []))
    out = capsys.readouterr().out.splitlines()
    for want in (STAGES if stages else SUMMARY):
        assert any(line.startswith(want) for line in out), want
    absent = [line for line in out if "absent in the port" in line]
    assert len(absent) == (len(profile_iter.ABSENT) if stages else 0)
    assert len(results) == (len(STAGES) if stages else len(SUMMARY) - 1)


@pytest.mark.parametrize("mod", [probe_unroll, probe_dma, profile_iter],
                         ids=["probe_unroll", "probe_dma", "profile_iter"])
def test_scripts_refuse_to_fall_back_to_cpu(mod, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the scripts would run on it")
    with pytest.raises(SystemExit) as exc:
        mod.main(["--n", "100"])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


def test_profile_iter_takes_the_binning_variants(capsys):
    """--tile_cull and --direct_j reach every structure build, as the TPU
    script's flags do: the summary's structure drops pairs."""
    profile_iter.main(MICRO + ["--tile_cull", "--direct_j", "2"])
    out = capsys.readouterr().out.splitlines()
    assert "BinOptions(tile_cull=True, direct_j=2)" in out[0]
    counts = next(line for line in out if line.startswith("n_pairs="))
    assert int(counts.split("n_culled=")[1]) > 0, counts
