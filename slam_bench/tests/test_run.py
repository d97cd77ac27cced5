"""A 64x48 cell end to end on the CPU (the port's plain versions), the
imports of a run and of the reference, and the planted faults that the
check has to catch."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from slam_bench import loop as loop_mod
from slam_bench import run, spec
from slam_bench.control import FAULTS, planted

ARGS = ["--workload", "tiny.fr1_desk", "--seed", "3000000007", "--seconds", "1"]


def _run(tiny_root, capsys, trace=0):
    rc = run.main(ARGS + ["--trace", str(trace)], device="cpu", root=tiny_root)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


def test_a_tiny_cell_prints_one_contract_line(tiny_root, capsys):
    rc, line = _run(tiny_root, capsys)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    cfg = spec.Cell(spec.load(tiny_root), "tiny.fr1_desk", tiny_root / "slam_bench").config
    assert line["attempted"] == run.window_length(cfg, 1.0)
    # the CPU has no device memory to read: memory_peak_gb is the card's alone
    assert set(line["metrics"]) == {"setup_s"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_the_window_is_the_same_frames_for_a_faster_or_slower_program(tiny_root, capsys,
                                                                      monkeypatch):
    """The window runs round(seconds / window.frame_s) frames whatever the
    program's speed: a program slowed by half a second a frame runs the
    same frames as the sound one, and its frame_s.loop holds the wait."""
    import time

    _, fast = _run(tiny_root, capsys, trace=1)
    sound = loop_mod.Loop.frame

    def slow(self, i, mark=None):
        time.sleep(0.5)
        return sound(self, i, mark) + 0.5

    monkeypatch.setattr(loop_mod.Loop, "frame", slow)
    _, slowed = _run(tiny_root, capsys, trace=1)
    assert slowed["attempted"] == fast["attempted"] >= 1
    assert slowed["metrics"]["frame_s.loop"]["value"] > 0.5
    assert slowed["correct"] is True


def test_a_traced_tiny_cell_reports_the_program_spans(tiny_root, capsys):
    rc, line = _run(tiny_root, capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    # the CPU has no device trace: only the host spans and the counter read
    assert {"frame_s.loop", "frame_s_p90.loop", "track_ms", "map_ms", "densify_ms",
            "pairs_per_frame"} <= set(line["metrics"])
    assert "idle_pct" not in line["metrics"] and "breakdown" in line


def test_without_a_card_the_run_exits_without_a_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "replica_bench.fr1_desk", "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_no_module_of_the_run_or_the_reference_is_jax_or_the_jax_package(tiny_root):
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        import slam_bench.reference.follow, slam_bench.reference.loss, slam_bench.reference.render
        ref = {{n.split(".")[0] for n in sys.modules}}
        from slam_bench import run
        rc = run.main({ARGS + ["--trace", "0"]!r}, device="cpu", root=Path({str(tiny_root)!r}))
        print("RC", rc)
        print("REF", sorted(ref))
        print("RUN", sorted({{n.split(".")[0] for n in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout.splitlines()
    got = {line.split(" ", 1)[0]: line.split(" ", 1)[1] for line in out
           if line.startswith(("RC", "REF", "RUN"))}
    ref, ran = eval(got["REF"]), eval(got["RUN"])  # noqa: S307 (lists this test printed)
    assert got["RC"] == "0"
    for forbidden in ("jax", "jaxlib", "flax", "splatam_tpu"):
        assert forbidden not in ran and forbidden not in ref
    assert "splatam_tpu_torch" in ran and "splatam_tpu_torch" not in ref


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(fault, tiny_root, capsys, monkeypatch):
    """Set-up runs sound; from the first measured frame on, the fault is in
    place (slam_bench/control.py plants it), the check frame included."""
    sound = loop_mod.Loop.frame
    broken = planted(fault)

    def frame(self, i, mark=None):
        if i == self.plan.setup_frames:
            broken.__enter__()
        return sound(self, i, mark)

    monkeypatch.setattr(loop_mod.Loop, "frame", frame)
    try:
        rc, line = _run(tiny_root, capsys)
    finally:
        broken.__exit__(None, None, None)
    assert rc == 0 and line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_a_pixel_densified_apart_moves_only_the_pixel_count(tiny_root, capsys, monkeypatch):
    """A program whose densification takes one pixel more than the reference
    (as a silhouette that rounds apart at the threshold does) reads it in
    densify_px_gap alone: the reference makes its Gaussians at the program's
    pixels, so mapping's numbers and densify_new_gap stay sound."""
    import torch

    from splatam_tpu_torch.slam import steps

    choose = steps.densify_candidates

    def one_more(out, depth_gt, sil_thres):
        cand = choose(out, depth_gt, sil_thres).reshape(-1).clone()
        cand[torch.nonzero(~cand & (depth_gt.reshape(-1) > 0))[0, 0]] = True
        return cand.reshape(depth_gt.shape)

    monkeypatch.setattr(steps, "densify_candidates", one_more)
    rc, line = _run(tiny_root, capsys)
    checks = {n: c["value"] for n, c in line["checks"].items()}
    limits = {n: c["limit"] for n, c in line["checks"].items()}
    assert rc == 0 and checks["densify_px_gap"] >= 1.0 / (64 * 48)
    for n in ("map_loss_gap", "map_grad_gap", "map_step_gap", "densify_new_gap"):
        assert checks[n] <= limits[n], (n, checks[n])


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tiny_root, tmp_path):
    """With only BENCHMARK.json and slam_bench/ (no program), a run fails
    and prints no result line."""
    import shutil

    alone = tmp_path / "alone"
    shutil.copytree(tiny_root / "slam_bench", alone / "slam_bench")
    shutil.copytree(spec.BENCH_DIR, alone / "slam_bench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(tiny_root / "BENCHMARK.json", alone / "BENCHMARK.json")
    code = (f"import sys; from pathlib import Path; from slam_bench import run; "
            f"sys.exit(run.main({ARGS + ['--trace', '0']!r}, device='cpu', "
            f"root=Path({str(alone)!r})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=alone, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin"})
    assert res.returncode != 0 and "splatam_tpu_torch" in res.stderr
    assert not [line for line in res.stdout.splitlines() if line.startswith("{")]
