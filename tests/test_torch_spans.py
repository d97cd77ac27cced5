"""The port's span recorder (splatam_tpu_torch/utils/spans.py) on the CPU:
off it records nothing and hands out one shared object; on, spans nest
with their parents and frame ids, self times tile the top spans, waits
count per site, and its clock is the profiler's; and the online loop's
frames come out bit for bit the same with the recorder on and off."""
import copy
import time

import numpy as np
import pytest
import torch

from slam_bench import host_spans
from splatam_tpu_torch.render import binning
from splatam_tpu_torch.slam.config import load_experiment_config
from splatam_tpu_torch.slam.pipeline import SLAMRuntime, run_frame
from splatam_tpu_torch.utils import spans

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _top_ns(records) -> int:
    return sum(s.end_ns - s.start_ns for s in records.spans if s.parent < 0)


def _self_ns(records) -> int:
    return sum(host_spans.self_ns_by_name(records.spans).values())


def test_off_records_nothing_and_returns_one_shared_object():
    objs = {id(spans.span("a")), id(spans.span("b", frame=3)), id(spans.waited("site"))}
    assert objs == {id(spans.OFF)}
    with spans.span("a", frame=1):
        with spans.waited("site"):
            pass
    records = spans.take()
    assert records.spans == [] and records.syncs == {}


def test_nested_spans_record_parents_frames_and_self_times():
    spans.enable()
    with spans.span("top", frame=7):
        time.sleep(0.002)
        with spans.span("child"):
            time.sleep(0.004)
            with spans.waited("site"):
                time.sleep(0.003)
        with spans.span("child"):
            time.sleep(0.002)
    with spans.span("next", frame=8):
        time.sleep(0.001)
    spans.disable()
    records = spans.take()
    names = [s.name for s in records.spans]
    assert names == ["top", "child", "wait/site", "child", "next"]
    assert [s.parent for s in records.spans] == [-1, 0, 1, 0, -1]
    assert [s.frame for s in records.spans] == [7, 7, 7, 7, 8]
    assert host_spans.paths(records.spans)[2] == "top/child/wait/site"
    for s in records.spans:
        assert s.end_ns > s.start_ns
        if s.parent >= 0:
            p = records.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    own = host_spans.self_ns_by_name(records.spans)
    top, c1, wait, c2, _ = records.spans
    assert own["top"] == (top.end_ns - top.start_ns) - (c1.end_ns - c1.start_ns) - (
        c2.end_ns - c2.start_ns)
    assert own["child"] == (c1.end_ns - c1.start_ns) - (wait.end_ns - wait.start_ns) + (
        c2.end_ns - c2.start_ns)
    assert own["wait/site"] >= 3_000_000 and own["top"] >= 2_000_000
    assert _self_ns(records) == _top_ns(records)
    assert spans.take().spans == []


def test_waited_counts_each_site():
    spans.enable()
    for _ in range(3):
        with spans.waited("a"):
            pass
    with spans.span("s"):
        with spans.waited("b"):
            pass
    records = spans.take()
    assert records.syncs == {"a": 3, "b": 1}
    assert sum(s.name.startswith("wait/") for s in records.spans) == 4
    assert spans.take().syncs == {}


def test_a_span_lies_on_the_profilers_clock():
    """A span around a record_function region under the CPU profiler lies
    within 100 us of the region's event, the event put on Unix
    nanoseconds through kineto's trace_start_ns()."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.enable()
        for k in range(5):
            with spans.span(f"region{k}"):
                with record_function(f"region{k}"):
                    x.sum()
        spans.disable()
    records = spans.take()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("region")}
    for s in records.spans[1:]:  # the first region pays record_function's warm-up
        e = events[s.name]
        start = t0 + round(e.time_range.start * 1e3)
        end = t0 + round(e.time_range.end * 1e3)
        assert abs(start - s.start_ns) < 100_000 and abs(end - s.end_ns) < 100_000, (
            s, start, end)


def test_a_frame_under_the_profiler_records_itself():
    """A span given its frame id turns the recorder on while torch.profiler
    runs, until it closes; outside the profiler, or without a frame id,
    nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("loose") is spans.OFF
        with spans.span("top", frame=4):
            with spans.span("child"):
                with spans.waited("site"):
                    pass
        assert spans.span("after") is spans.OFF
        with spans.span("next", frame=5):
            pass
    with spans.span("outside", frame=6):
        pass
    records = spans.take()
    assert [(s.name, s.frame, s.parent) for s in records.spans] == [
        ("top", 4, -1), ("child", 4, 0), ("wait/site", 4, 1), ("next", 5, -1)]
    assert records.syncs == {"site": 1}


def test_idle_is_put_down_to_the_innermost_open_span():
    """slam_bench/host_spans.py: the card idle in [0, 10) less a kernel at
    [3, 5); spans top [0, 9) holding child [2, 6): idle 0-2 and 6-9 in top,
    2-3 and 5-6 in child, 9-10 in no span."""
    rec = spans.SpanRecord
    records = [rec("top", 0, -1, 0, 9), rec("child", 0, 0, 2, 6)]
    by_path, idle = host_spans.idle_by_path(records, [(3, 5)], (0, 10))
    assert idle == 8
    assert dict(by_path) == {"top": 5, "top/child": 2}


def _config(tmp_path, rebin_every):
    config = copy.deepcopy(load_experiment_config("configs/synthetic/splatam.py"))
    config["workdir"] = str(tmp_path)
    config["data"].update(desired_image_height=24, desired_image_width=32, num_frames=3)
    config["tracking"]["num_iters"] = 3
    config["mapping"]["num_iters"] = 3
    config["mapping_window_size"] = 5
    config["keyframe_every"] = 2
    config["tpu"] = dict(capacity=1 << 12, rebin_every=rebin_every)
    return config


def _run(tmp_path, rebin_every, record):
    """Three frames of the loop; (marks, build_bins.totals, the runtime, records)."""
    np.random.seed(0)
    torch.manual_seed(0)
    rt = SLAMRuntime(_config(tmp_path, rebin_every), "cpu")
    marks, totals, records = [], [], []
    for i in range(3):
        binning.reset_pair_totals()
        if record:
            spans.enable()
        run_frame(rt, i, mark=lambda stage, i=i: marks.append((i, stage)))
        spans.disable()
        totals.append(dict(binning.build_bins.totals))
        records.append(spans.take())
    return marks, totals, rt, records


@pytest.mark.parametrize("rebin_every", [1, 8])
def test_frames_are_bit_identical_with_the_recorder_on_and_off(tmp_path, rebin_every):
    """rebin_every 8: the fused renders on reused structures; 1: the generic
    render binning every iteration."""
    off_marks, off_totals, off, off_records = _run(tmp_path / "off", rebin_every, False)
    on_marks, on_totals, on, on_records = _run(tmp_path / "on", rebin_every, True)
    assert on_marks == off_marks and on_totals == off_totals
    assert np.array_equal(on.cam_rots, off.cam_rots)
    assert np.array_equal(on.cam_trans, off.cam_trans)
    for a, b in zip(on.gm, off.gm):
        assert torch.equal(a, b)
    assert torch.equal(on.timestep, off.timestep)
    assert all(r.spans == [] and r.syncs == {} for r in off_records)
    for i, records in enumerate(on_records):
        names = {s.name for s in records.spans}
        assert {s.frame for s in records.spans} == {i}
        assert {"compact", "select_kf", "stage_kf", "map", "iter", "render", "loss",
                "backward", "adam", "build"} <= names
        if i > 0:
            assert {"track", "densify", "readback", "select", "write"} <= names
            assert records.syncs["bins.total"] == on_totals[i]["builds"]
        assert abs(_self_ns(records) - _top_ns(records)) <= 0.01 * _top_ns(records)


def _ancestors(records, k: int) -> list:
    out, p = [], records.spans[k].parent
    while p >= 0:
        out.append(records.spans[p].name)
        p = records.spans[p].parent
    return out


def test_the_generic_route_records_project_under_render(tmp_path):
    """rebin_every 1: every render is the generic one, which projects in
    PyTorch (the span `project`, inside `render`) and then bins (`build`)."""
    _, totals, _, records = _run(tmp_path, 1, True)
    for i, rec in enumerate(records):
        project = [k for k, s in enumerate(rec.spans) if s.name == "project"]
        assert len(project) == totals[i]["builds"] > 0
        for k in project:
            assert rec.spans[rec.spans[k].parent].name == "render"


def test_project_is_the_shared_no_op_when_off(tmp_path, monkeypatch):
    seen = []
    span = spans.span

    def spy(name, frame=None):
        obj = span(name, frame)
        seen.append((name, obj))
        return obj

    monkeypatch.setattr(spans, "span", spy)
    _run(tmp_path, 1, False)
    project = [obj for name, obj in seen if name == "project"]
    assert project and all(obj is spans.OFF for obj in project)


def test_the_fused_route_records_no_project(tmp_path):
    """rebin_every 8: tracking and mapping render through the fused kernels,
    which project inside the kernel; only densification's generic render
    records `project`."""
    _, _, _, records = _run(tmp_path, 8, True)
    for rec in records:
        for k, s in enumerate(rec.spans):
            if s.name == "project":
                path = _ancestors(rec, k)
                assert "densify" in path and "track" not in path and "map" not in path
    assert any(s.name == "project" for rec in records[1:] for s in rec.spans)
