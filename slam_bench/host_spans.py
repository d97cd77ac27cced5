"""The program's spans of the traced frames, read (its recorder:
splatam_tpu_torch/utils/spans.py): self times by span name, the host's
waits and syncs, and the card's idle time put down to the span that left
it (for slam_bench/span_cost.py, which profiles frames of its own).

The recorder records every frame run under torch.profiler by itself, so
a `--trace 1` run's traced frames (slam_bench/trace.py trace_frame) leave
their records in it: the readers take them once, after the run, and
divide by the frames they cover (the traced frames, and any frame traced
again because the profiler dropped a launch of it). Every reader here
returns None for a program without the recorder, or a run without spans.

A span's self time is its duration less the part of it that its child
spans cover. The self intervals of a frame's spans tile the time its top
spans cover, so the innermost span open at a moment is the one whose self
interval holds that moment. The card is idle where no device event of the
frame's profile runs, between the frame's start and end: the time
idle_pct counts (slam_bench/trace.py). An idle stretch is split over the
innermost spans open during it, by overlap.
"""
from __future__ import annotations

from collections import defaultdict


def self_intervals(spans: list) -> list:
    """(span index, start ns, end ns) of every span's self time, by start."""
    kids = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s.parent >= 0:
            kids[s.parent].append(i)
    out = []
    for i, s in enumerate(spans):
        cursor = s.start_ns
        for k in kids[i]:
            if spans[k].start_ns > cursor:
                out.append((i, cursor, spans[k].start_ns))
            cursor = max(cursor, spans[k].end_ns)
        if s.end_ns > cursor:
            out.append((i, cursor, s.end_ns))
    out.sort(key=lambda x: x[1])
    return out


def paths(spans: list) -> list:
    """Each span's path from its top span, names joined by '/'."""
    out = []
    for s in spans:
        out.append(s.name if s.parent < 0 else f"{out[s.parent]}/{s.name}")
    return out


def self_ns_by_name(spans: list) -> dict:
    total = defaultdict(int)
    for i, start, end in self_intervals(spans):
        total[spans[i].name] += end - start
    return total


def idle_intervals(device_ns: list, frame_ns: tuple) -> list:
    """The frame's [start, end) stretches in which no device event runs;
    device_ns sorted by start."""
    f0, f1 = frame_ns
    out, cursor = [], f0
    for start, end in device_ns:
        if start > cursor:
            out.append((cursor, min(start, f1)))
        cursor = max(cursor, end)
        if cursor >= f1:
            break
    if cursor < f1:
        out.append((cursor, f1))
    return [(a, b) for a, b in out if b > a]


def idle_by_path(spans: list, device_ns: list, frame_ns: tuple) -> tuple[dict, int]:
    """(span path -> idle ns inside that span's self time, the frame's idle ns)."""
    idle = idle_intervals(device_ns, frame_ns)
    selfs = self_intervals(spans)
    names = paths(spans)
    out = defaultdict(int)
    i = j = 0
    while i < len(idle) and j < len(selfs):
        (a, b), (k, c, d) = idle[i], selfs[j]
        if min(b, d) > max(a, c):
            out[names[k]] += min(b, d) - max(a, c)
        if b <= d:
            i += 1
        else:
            j += 1
    return out, sum(b - a for a, b in idle)


_TAKEN: list = [None, None]  # the trace read last, and the records taken for it


def recorded(trace):
    """(span records, host syncs, frames) of the profiled frames: the
    recorder's records, taken once for `trace`; None where there are none."""
    if _TAKEN[0] is not trace:
        try:
            from splatam_tpu_torch.utils import spans
        except ImportError:  # a program without the recorder
            spans = None
        _TAKEN[:] = [trace, spans.take() if spans is not None else None]
    records = _TAKEN[1]
    if records is None or not records.spans or not trace.frames:
        return None
    return records.spans, sum(records.syncs.values()), len({s.frame for s in records.spans})


def self_ms(trace, name: str) -> float | None:
    """Milliseconds a frame in the self time of the spans named `name`."""
    got = recorded(trace)
    if got is None:
        return None
    return self_ns_by_name(got[0]).get(name, 0) / got[2] / 1e6


def wait_ms(trace) -> float | None:
    """Milliseconds a frame inside `wait/<site>` spans."""
    got = recorded(trace)
    if got is None:
        return None
    return sum(s.end_ns - s.start_ns for s in got[0] if s.name.startswith("wait/")) / got[2] / 1e6


def syncs_per_frame(trace) -> float | None:
    got = recorded(trace)
    return None if got is None else got[1] / got[2]
