"""On the card: the control and every planted fault come out not correct,
and the sound program correct, at a cell's own size (one seed each; the
readings behind the limits came from slam_bench/control.py over more
seeds, PERF.md). Run on the card:

    python3 -m pytest -q slam_bench/tests/test_control.py
"""
from __future__ import annotations

import json

import pytest

from slam_bench import control, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["replica_bench.fr1_desk"])
def test_control_and_faults_fail_and_the_program_passes(workload, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32, which only the card has")
    assert control.main(["--workload", workload, "--seeds", "3000000011", "--control",
                         "--faults"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    limits = spec.Cell(spec.load(), workload).limits["limits"]

    def fails(readings):
        return any(readings[n] > limit for n, limit in limits.items())

    by_kind = {line["kind"]: line["readings"] for line in lines}
    assert set(by_kind) == {"sound", "control", *control.FAULTS}
    assert not fails(by_kind["sound"]), by_kind["sound"]
    for kind in ("control", *control.FAULTS):
        assert fails(by_kind[kind]), (kind, by_kind[kind])
