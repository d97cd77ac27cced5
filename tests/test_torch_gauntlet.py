"""The port's quality gauntlet (splatam_tpu_torch/scripts/gauntlet.py)
against the JAX script (scripts/gauntlet.py), and the micro-gauntlets on
the card (the port of tests/test_gauntlet.py).

On the CPU:
- every variant's config, with and without overrides, equals the JAX
  run_variant's; each flag (--map_iters, --bootstrap, --cur_prob, --c2f)
  sets what its JAX environment variable or flag sets, and so do
  --direct_j and --tile_cull. Both packages' rgbd_slam are patched to
  capture the config, so no loop runs;
- one tiny variant end to end in both packages (clean, 3 frames, 64x48,
  3/3 iterations): poses within 1e-4 and PSNR within 0.05 dB, the
  tolerances of tests/test_torch_rgbd_slam.py;
- main exits 1 when a floor breaks and writes gauntlet_results.json.

On the card (markers cuda, slow, gauntlet; skipped without a CUDA device,
and not selected by tier-1's -m 'not slow'): the two micro-gauntlets at
the JAX file's floors (clean, 30 frames at 160x120: ATE < 3.3 cm, PSNR >=
35 dB; scan, 39 frames at motion_scale 1.0: < 1.8 cm, >= 37 dB), and the
falsifiability check: at 3 tracking iterations the clean one trips both
floors (JAX record: 14.71 cm / 21.77 dB). The card part imports no JAX:
    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_gauntlet.py -m cuda
"""
import copy
import json
import sys

import numpy as np
import pytest
import torch

try:  # the card machine has no JAX; the CPU parity tests then skip
    import jax  # noqa: F401  (both frameworks in one process: import both first)
    import scripts.gauntlet as j_gauntlet
    import splatam_tpu.slam.pipeline as j_pipeline
except ImportError:
    j_gauntlet = j_pipeline = None

from splatam_tpu_torch.scripts import gauntlet
from splatam_tpu_torch.slam import pipeline

torch.set_num_threads(1)

FAKE = {"ate_rmse": 0.01, "psnr": 40.0, "depth_l1": 0.002, "ms_ssim": 0.99,
        "lpips_synthetic": 0.01, "lpips_calibration": "synthetic"}


@pytest.fixture
def jax_side():
    if j_gauntlet is None:
        pytest.skip("needs the JAX package")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def captured(monkeypatch):
    """Both packages' rgbd_slam replaced by a capture of their config;
    returns {"jax": [...], "port": [...]}."""
    seen = {"jax": [], "port": []}

    def fake(side, metrics):
        def rgbd_slam(config, *args):
            seen[side].append(copy.deepcopy(config))
            return dict(metrics)
        return rgbd_slam

    monkeypatch.setattr(j_pipeline, "rgbd_slam", fake("jax", FAKE))
    monkeypatch.setattr(pipeline, "rgbd_slam", fake("port", FAKE))
    return seen


@pytest.mark.parametrize("name", sorted(gauntlet.THRESHOLDS))
@pytest.mark.parametrize("overrides", [None, {"tracking": {"lrs": {"cam_trans": 0.02}},
                                             "keyframe_every": 3}])
def test_variant_config_matches_jax(jax_side, captured, tmp_path, name, overrides):
    assert gauntlet.THRESHOLDS == j_gauntlet.THRESHOLDS
    j_gauntlet.run_variant(name, 12, 48, 64, 4, str(tmp_path), 7,
                           overrides=copy.deepcopy(overrides))
    gauntlet.run_variant(name, 12, 48, 64, 4, str(tmp_path), 7,
                         overrides=copy.deepcopy(overrides), device="cpu")
    assert captured["port"] == captured["jax"] and len(captured["port"]) == 1


def test_flags_set_what_the_jax_environment_sets(jax_side, captured, tmp_path, monkeypatch):
    """--map_iters / --bootstrap / --cur_prob against GAUNTLET_MAP_ITERS /
    GAUNTLET_BOOTSTRAP / GAUNTLET_CUR_PROB, with --c2f levels on both."""
    common = ["--variant", "both", "--frames", "5", "--h", "48", "--w", "64",
              "--workdir", str(tmp_path), "--c2f", "4:2,2:3", "--c2f_extra"]
    monkeypatch.setenv("GAUNTLET_MAP_ITERS", "9")
    monkeypatch.setenv("GAUNTLET_BOOTSTRAP", "2:17")
    monkeypatch.setenv("GAUNTLET_CUR_PROB", "0.3")
    monkeypatch.setattr(sys, "argv", ["gauntlet.py", *common, "--cpu"])
    j_gauntlet.main()
    gauntlet.main([*common, "--device", "cpu", "--map_iters", "9", "--bootstrap", "2:17",
                   "--cur_prob", "0.3"])
    assert len(captured["port"]) == 2 and captured["port"] == captured["jax"]
    mapping = captured["port"][0]["mapping"]
    assert (mapping["num_iters"], mapping["bootstrap_frames"], mapping["bootstrap_num_iters"],
            mapping["current_frame_prob"]) == (9, 2, 17, 0.3)


def test_refused_flags_exit_2(jax_side, captured, tmp_path, monkeypatch):
    """--direct_j and --tile_cull, which the port once refused, set
    tpu.direct_j and tpu.tile_cull in the variant's config as the JAX
    script's flags do; a flag the port does not take (the JAX script's
    --cpu, which is --device cpu here) still exits 2."""
    common = ["--variant", "clean", "--frames", "5", "--h", "48", "--w", "64",
              "--workdir", str(tmp_path)]
    for flags in (["--direct_j", "2"], ["--tile_cull"], ["--direct_j", "3", "--tile_cull"]):
        captured["jax"].clear()
        captured["port"].clear()
        monkeypatch.setattr(sys, "argv", ["gauntlet.py", *common, *flags, "--cpu"])
        j_gauntlet.main()
        gauntlet.main([*common, *flags, "--device", "cpu"])
        assert len(captured["port"]) == 1 and captured["port"] == captured["jax"]
        tpu = captured["port"][0]["tpu"]
        j = int(flags[1]) if flags[0] == "--direct_j" else 0
        assert tpu.get("direct_j", 0) == j
        assert tpu.get("tile_cull", False) == ("--tile_cull" in flags)
    with pytest.raises(SystemExit) as e:
        gauntlet.main(["--cpu"])
    assert e.value.code == 2


def test_main_exits_1_when_a_floor_breaks(tmp_path, monkeypatch):
    bad = dict(FAKE, ate_rmse=0.02)  # 2 cm: the clean floor is 1.5 cm
    monkeypatch.setattr(pipeline, "rgbd_slam", lambda config, device: dict(bad))
    with pytest.raises(SystemExit) as e:
        gauntlet.main(["--variant", "clean", "--device", "cpu", "--workdir", str(tmp_path)])
    assert e.value.code == 1
    results = json.loads((tmp_path / "gauntlet_results.json").read_text())
    assert results["clean"]["pass"] is False and results["clean"]["ate_cm"] == 2.0
    monkeypatch.setattr(pipeline, "rgbd_slam", lambda config, device: dict(FAKE))
    assert gauntlet.main(["--variant", "clean", "--device", "cpu",
                          "--workdir", str(tmp_path)])["clean"]["pass"]


def test_tiny_variant_matches_jax(jax_side, tmp_path, monkeypatch):
    """clean, 3 frames at 64x48, 3 tracking and 3 mapping iterations, in
    both packages (the JAX side on the CPU's `tiles` backend)."""
    monkeypatch.setenv("GAUNTLET_MAP_ITERS", "3")
    jm = j_gauntlet.run_variant("clean", 3, 48, 64, 8, str(tmp_path / "jax"), 3)
    tm = gauntlet.run_variant("clean", 3, 48, 64, 8, str(tmp_path / "port"), 3, device="cpu",
                              map_iters=3)
    load = lambda side: dict(np.load(tmp_path / side / "gauntlet_clean" / "params.npz"))  # noqa: E731
    mine, ref = load("port"), load("jax")
    np.testing.assert_allclose(mine["cam_unnorm_rots"], ref["cam_unnorm_rots"], atol=1e-4)
    np.testing.assert_allclose(mine["cam_trans"], ref["cam_trans"], atol=1e-4)
    assert np.abs(mine["cam_trans"][..., -1]).max() > 1e-3  # the camera moved
    assert abs(tm["psnr"] - jm["psnr"]) <= 0.05
    assert abs(tm["ate_rmse"] - jm["ate_rmse"]) <= 1e-4
    assert sorted(tm) == sorted(jm)


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.gauntlet
@pytest.mark.parametrize("name", sorted(gauntlet.MICRO))
def test_micro_gauntlet_on_the_card(cuda, tmp_path, name):
    m = gauntlet.run_micro(name, str(tmp_path), cuda)
    micro = gauntlet.MICRO[name]
    print(f"micro-gauntlet {name} on {torch.cuda.get_device_name(0)}: ATE "
          f"{m['ate_rmse'] * 100:.4f} cm, PSNR {m['psnr']:.4f} dB, wall {m['wall_s']} s")
    assert m["ate_rmse"] * 100 < micro["ate_cm"], "tracking accuracy regressed"
    assert m["psnr"] >= micro["psnr"], "map quality regressed"
    assert m["pass"]


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.gauntlet
def test_micro_gauntlet_floors_trip_at_3_tracking_iterations(cuda, tmp_path):
    """The floors are falsifiable: 3 tracking iterations break both."""
    m = gauntlet.run_micro("clean", str(tmp_path), cuda, track_iters=3)
    print(f"micro-gauntlet clean at 3 tracking iterations on {torch.cuda.get_device_name(0)}: "
          f"ATE {m['ate_rmse'] * 100:.4f} cm, PSNR {m['psnr']:.4f} dB")
    assert m["ate_rmse"] * 100 >= gauntlet.MICRO["clean"]["ate_cm"]
    assert m["psnr"] < gauntlet.MICRO["clean"]["psnr"]
    assert not m["pass"]
