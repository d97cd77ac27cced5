"""The port's shadow-tracking diagnostic
(splatam_tpu_torch/scripts/diag_shadow_tracking.py) against the JAX
script (scripts/diag_shadow_tracking.py).

The JAX script's main runs under a patched sys.argv (--cpu, 4 frames at
64x48, 3 tracking iterations) and prints each frame's shadow error; the
port's shadow_errors runs the same config. Both packages' mapping is cut
from the scripts' fixed 60 iterations to 3 (the plain versions take about
a second a mapping iteration on the CPU): the JAX runtime is patched to
read that and its working directory from the test.

Tolerance, from the 1e-4 that holds the two packages' poses
(tests/test_torch_rgbd_slam.py): a translation within 1e-4 m and a
quaternion within 1e-4 move the camera centre by at most ~3e-4 m with
this sequence's ~1 m translations, so the translation errors agree within
0.03 cm. The rotation error is an arccos near 1: the two estimates' own
~2e-4 rad apart, plus float32 rounding of the trace (~1e-7, which arccos
turns into sqrt(2e-7) ~ 4.5e-4 rad), so within 0.05 degrees. The JAX
script prints 4 decimals.
"""
import re
import sys

import numpy as np
import pytest
import jax  # noqa: F401  (both frameworks in one process: import both first)
import torch

import scripts.diag_shadow_tracking as j_shadow
import splatam_tpu.slam.pipeline as j_pipeline
from splatam_tpu_torch.scripts import diag_shadow_tracking as shadow

torch.set_num_threads(1)

FRAMES, H, W, ITERS, MAP_ITERS = 4, 48, 64, 3, 3
LINE = re.compile(r"frame (\d+): shadow err ([\d.]+) cm / ([\d.]+) deg")


def test_shadow_errors_match_jax(tmp_path, monkeypatch, capsys):
    made = []

    class Runtime(j_pipeline.SLAMRuntime):
        def __init__(self, config):
            config["workdir"] = str(tmp_path / "jax")
            config["mapping"]["num_iters"] = MAP_ITERS
            super().__init__(config)
            made.append(self)

    monkeypatch.setattr(j_pipeline, "SLAMRuntime", Runtime)
    monkeypatch.setattr(sys, "argv", ["diag_shadow_tracking.py", "--cpu", "--frames", str(FRAMES),
                                      "--h", str(H), "--w", str(W), "--iters", str(ITERS)])
    j_shadow.main()
    made[0].shutdown()
    printed = capsys.readouterr().out
    ref = np.array([(float(t), float(r)) for _, t, r in LINE.findall(printed)])
    assert [int(f) for f, _, _ in LINE.findall(printed)] == list(range(1, FRAMES))
    assert "shadow tracking error over 3 frames" in printed

    config = shadow.shadow_config(FRAMES, H, W, ITERS, workdir=str(tmp_path / "port"))
    config["mapping"]["num_iters"] = MAP_ITERS
    t, r = shadow.shadow_errors(config, "cpu")
    assert t.shape == r.shape == (FRAMES - 1,)
    np.testing.assert_allclose(t, ref[:, 0], atol=0.03)
    np.testing.assert_allclose(r, ref[:, 1], atol=0.05)
    assert t.max() > 0.1  # the tracker is off the ground truth by something measurable
    summary = shadow.summary(t, r)
    assert f"mean {t.mean():.4f}" in summary and f"p90 {np.percentile(r, 90):.4f}" in summary


def test_shadow_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    """main prints the per-frame lines and the JAX script's summary (mapping
    cut to 1 iteration); its --direct_j refuses with exit 2."""
    config_of = shadow.shadow_config

    def cut(*args):
        config = config_of(*args)
        config["mapping"]["num_iters"] = 1
        return config

    monkeypatch.setattr(shadow, "shadow_config", cut)
    t, r = shadow.main(["--device", "cpu", "--frames", "2", "--h", "24", "--w", "32",
                        "--iters", "1", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(LINE.findall(out)) == 1 == len(t) and "rotation deg:" in out
    with pytest.raises(SystemExit) as e:
        shadow.main(["--device", "cpu", "--direct_j", "2"])
    assert e.value.code == 2
