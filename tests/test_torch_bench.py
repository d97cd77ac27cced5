"""The port's benchmark entry point (splatam_tpu_torch/scripts/bench.py)
against bench.py on the CPU.

Both scripts run in subprocesses at BENCH_PLATFORM=cpu BENCH_H=48
BENCH_W=64 BENCH_FRAMES=3 BENCH_WARMUP=1, side by side (the JAX one about
20 s; the port's plain compositing loops about 2 min on one thread). Their
JSON lines have the same keys (the port's plus `device`), the same metric
text, warmup_frames and rebin_every, and the same n_gaussians_final. The
JAX script writes its run directory under tmp_path here (its own is fixed
under /tmp). The binning variants bench.py selects are held to the JAX
package by the loop tests of test_torch_tile_cull.py and
test_torch_binning_direct.py, not by more subprocesses.

Setting a variable without a counterpart exits 2, and so does a run
without BENCH_PLATFORM on a machine with no card (no fallback to the CPU).
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from splatam_tpu_torch.scripts import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(BENCH_PLATFORM="cpu", BENCH_H="48", BENCH_W="64", BENCH_FRAMES="3",
             BENCH_WARMUP="1")
# bench.py's main with its run directory moved under the test's own
JAX_BENCH = (
    "import sys\n"
    "from splatam_tpu.slam import pipeline\n"
    "init, workdir = pipeline.SLAMRuntime.__init__, sys.argv.pop(1)\n"
    "def moved(self, config, *args, **kwargs):\n"
    "    config['workdir'] = workdir\n"
    "    init(self, config, *args, **kwargs)\n"
    "pipeline.SLAMRuntime.__init__ = moved\n"
    "import bench\n"
    "bench.main()\n"
)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": (rc, stdout, stderr), "port": (...)} of the two scripts."""
    work = tmp_path_factory.mktemp("bench")
    procs = {
        "jax": subprocess.Popen([sys.executable, "-c", JAX_BENCH, str(work)], cwd=REPO,
                                env=_env(**SMALL), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen([sys.executable, "-m", "splatam_tpu_torch.scripts.bench"],
                                 cwd=REPO, env=_env(**SMALL, OMP_NUM_THREADS="1"),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[name] = (p.returncode, stdout, stderr)
    return out


def _result(run):
    rc, stdout, stderr = run
    assert rc == 0, stderr[-3000:]
    return json.loads(stdout.strip().splitlines()[-1])


def test_bench_matches_jax_bench(runs):
    ref, got = _result(runs["jax"]), _result(runs["port"])
    assert set(got) == set(ref) | {"device"} and got["device"] == "cpu"
    for key in ("metric", "unit", "aggregation", "warmup_frames", "rebin_every",
                "n_gaussians_final"):
        assert got[key] == ref[key], key
    assert ref["n_gaussians_final"] > 3000
    for key in ("value", "vs_baseline", "frame0_s", "max_frame_s"):
        assert math.isfinite(got[key]) and got[key] > 0, key
    assert got["vs_baseline"] == round(bench.REFERENCE_FRAME_SECONDS / got["value"], 3)


def test_bench_prints_frames_launches_on_stderr(runs):
    lines = runs["port"][2].splitlines()
    frames = [ln for ln in lines if ln.startswith("frame ")]
    assert len(frames) == 3 and all("pairs=" in ln and "builds" in ln for ln in frames)
    assert not any("culled=" in ln for ln in frames)  # no cull at the defaults
    launches = json.loads(next(ln for ln in lines if ln.startswith("launches: "))[10:])
    assert set(launches) >= {"composite_forward", "fused_forward", "fused_backward",
                             "segment_reduce"}


@pytest.mark.parametrize("var, value", [("BENCH_PAIR_CAP", "1048576"), ("BENCH_TILE_K", "4096"),
                                        ("BENCH_BACKEND", "tiles")])
def test_bench_refuses_variables_without_counterpart(monkeypatch, capsys, var, value):
    monkeypatch.setenv("BENCH_PLATFORM", "cpu")
    monkeypatch.setenv(var, value)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 2 and var in capsys.readouterr().err


def test_bench_needs_a_card_without_bench_platform():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the bench would run on it")
    res = subprocess.run([sys.executable, "-m", "splatam_tpu_torch.scripts.bench"], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "BENCH_PLATFORM=cpu" in res.stderr
