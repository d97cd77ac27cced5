"""The port's evaluation against the JAX package's, on the same inputs.

ms_ssim on seeded images (48x64 and an odd 37x53) within 1e-5; LPIPS on
the synthesized AlexNet weights (both packages build them from one numpy
seed) within 1e-5 relative; eval_sequence, eval_nvs and eval_online of
both packages on one params dict (frame 0's backprojection, near-opaque,
at the ground-truth poses: tests/test_eval_paths.py's), each package on
its own copy of the synthetic sequence, without plots: PSNR within 1e-3
dB, depth L1 / RMSE within 1e-5 m, MS-SSIM and LPIPS within 1e-4, ATE
within 1e-6 m, equal valid-frame counts and the same per-frame .txt files
of the same lengths. The JAX side renders with the `tiles` backend; the
port runs its kernels' plain versions.
"""
import os

import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import jax.numpy as jnp
import torch

from splatam_tpu.core import losses as jlosses
from splatam_tpu.data.synthetic import SyntheticDataset as JDataset
from splatam_tpu.eval import evaluate as jeval
from splatam_tpu.eval.lpips_jax import lpips_fn as j_lpips_fn
from splatam_tpu_torch.core import losses as tlosses
from splatam_tpu_torch.data.synthetic import SyntheticDataset as TDataset
from splatam_tpu_torch.eval import evaluate as teval
from splatam_tpu_torch.eval.lpips import lpips_fn as t_lpips_fn
from test_eval_paths import RCFG, _gt_map_params

torch.set_num_threads(1)

FRAMES = 4
ARGS = dict(sil_thres=0.5, mapping_iters=10, add_new_gaussians=True, eval_every=1)


def _images(h, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("h, w", [(48, 64), (37, 53)])
def test_ms_ssim_matches_jax(h, w):
    a, b = _images(h, w, seed=h)
    mine = float(tlosses.ms_ssim(torch.tensor(a), torch.tensor(b)))
    ref = float(jlosses.ms_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert 0.0 < ref < 1.0
    assert abs(mine - ref) <= 1e-5, (mine, ref)
    assert float(tlosses.ms_ssim(torch.tensor(a), torch.tensor(a))) == pytest.approx(1.0, abs=1e-5)


def test_lpips_synthesized_matches_jax():
    tf, jf = t_lpips_fn(device="cpu"), j_lpips_fn()
    assert tf.synthetic and jf.synthetic
    for seed in (0, 1):
        a, b = _images(48, 64, seed)
        mine, ref = float(tf(torch.tensor(a), torch.tensor(b))), float(jf(jnp.asarray(a),
                                                                         jnp.asarray(b)))
        assert ref > 0
        assert abs(mine - ref) <= 1e-5 * ref, (mine, ref)
    assert float(tf(torch.tensor(a), torch.tensor(a))) == 0.0


@pytest.fixture(scope="module")
def scene():
    jds = JDataset(num_frames=FRAMES, height=48, width=64, motion_scale=0.3)
    tds = TDataset(num_frames=FRAMES, height=48, width=64, motion_scale=0.3)
    params = _gt_map_params(jds, FRAMES)
    # a trajectory off the ground truth, so that ATE is not 0
    params["cam_trans"] = params["cam_trans"] + np.float32(0.01) * np.arange(
        FRAMES, dtype=np.float32)[None, None, :]
    return jds, tds, params


def _compare(mine: dict, ref: dict) -> None:
    assert sorted(mine) == sorted(ref)
    assert abs(mine["psnr"] - ref["psnr"]) <= 1e-3
    for k in ("depth_l1", "depth_rmse"):
        assert abs(mine[k] - ref[k]) <= 1e-5, k
    for k in ("ms_ssim", "lpips_synthetic"):
        if k in ref:
            assert abs(mine[k] - ref[k]) <= 1e-4, k
    if "ate_rmse" in ref:
        assert abs(mine["ate_rmse"] - ref["ate_rmse"]) <= 1e-6
    for k in ("num_valid_frames", "lpips_calibration"):
        assert mine.get(k) == ref.get(k), k


def _same_files(mine_dir, ref_dir):
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(mine_dir)) == names
    for name in names:
        if name.endswith(".txt"):
            assert np.loadtxt(os.path.join(mine_dir, name)).size == np.loadtxt(
                os.path.join(ref_dir, name)).size, name
    return names


def test_eval_sequence_matches_jax(tmp_path, scene):
    jds, tds, params = scene
    ref = jeval.eval_sequence(jds, params, FRAMES, str(tmp_path / "j"), rcfg=RCFG,
                              save_plots=False, **ARGS)
    mine = teval.eval_sequence(tds, params, FRAMES, str(tmp_path / "t"), device="cpu",
                               save_plots=False, **ARGS)
    _compare(mine, ref)
    assert ref["ate_rmse"] > 1e-3 and ref["psnr"] > 12
    assert "lpips_synthetic.txt" in _same_files(tmp_path / "t", tmp_path / "j")


def test_eval_nvs_matches_jax(tmp_path, scene):
    jds, tds, params = scene
    ref = jeval.eval_nvs(jds, params, FRAMES, str(tmp_path / "j"), rcfg=RCFG,
                         save_plots=False, **ARGS)
    mine = teval.eval_nvs(tds, params, FRAMES, str(tmp_path / "t"), device="cpu",
                          save_plots=False, **ARGS)
    _compare(mine, ref)
    assert "valid_nvs_frames.npy" in _same_files(tmp_path / "t", tmp_path / "j")
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "valid_nvs_frames.npy"),
                                  np.load(tmp_path / "j" / "valid_nvs_frames.npy"))


def test_eval_online_matches_jax(tmp_path, scene):
    jds, tds, params = scene
    ref = jeval.eval_online(jds, [params] * FRAMES, FRAMES, str(tmp_path / "j"), rcfg=RCFG,
                            **ARGS)
    mine = teval.eval_online(tds, [params] * FRAMES, FRAMES, str(tmp_path / "t"),
                             device="cpu", **ARGS)
    _compare(mine, ref)
    _same_files(tmp_path / "t", tmp_path / "j")
