"""Spans and host-sync counts at the layer boundaries of a frame.

One recorder for the process, off by default. Off, `span` and `waited`
return one shared object whose `with` does nothing: no record, no
allocation, no synchronize. On (enable() until disable()), each span
records its name, the frame it belongs to (the id every span of one frame
shares), its parent and its start and end in Unix nanoseconds; and
`waited(site)` wraps a point where the host blocks on the card (a read
back, a blocking upload from pageable memory, a count that sizes a
buffer): it counts one synchronization for the site and records a
`wait/<site>` span.

Times come from time.perf_counter_ns(), put on the Unix clock by one
offset taken at enable(): the clock of torch.profiler's events (kineto's
trace_start_ns() plus an event's time_range, in microseconds), so a
frame's spans and its device intervals line up.

A frame run under torch.profiler records itself: a span given its frame
id (the frame's top spans: `prepare` and run_frame's stages) turns the
recorder on, while the profiler runs and the recorder is off, until it
closes. So a profiled frame carries its spans without a switch of its
own (slam_bench's `--trace 1` frames are read so), and a frame outside
the profiler pays one check of the profiler's state per top span.

The records stay in memory until take() returns them and clears them.
The recorder follows one thread: the frame's.
"""
from __future__ import annotations

import time
from typing import NamedTuple

from torch._C._autograd import _profiler_enabled


class SpanRecord(NamedTuple):
    name: str
    frame: int | None  # the frame id the span belongs to
    parent: int  # index of the enclosing span's record; -1 at the top
    start_ns: int  # Unix nanoseconds
    end_ns: int


class Records(NamedTuple):
    spans: list  # SpanRecord, in the order the spans opened
    syncs: dict  # site -> host synchronizations counted


class _Off:
    """What span and waited return while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Open:
    """One open span: closes its record on exit (and, for a frame's top
    span that turned the recorder on under the profiler, turns it off)."""

    __slots__ = ("rec", "row", "stops")

    def __init__(self, rec: "Recorder", row: list, stops: bool = False):
        self.rec, self.row, self.stops = rec, row, stops

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.row[4] = time.perf_counter_ns() + self.rec.offset_ns
        self.rec.stack.pop()
        if self.stops:
            self.rec.on = False
        return False


class Recorder:
    def __init__(self):
        self.on = False
        self.offset_ns = 0
        self.frame = None
        self.rows: list = []  # [name, frame, parent, start, end]
        self.stack: list = []  # indices of the open spans' rows
        self.syncs: dict = {}

    def open(self, name: str, frame, stops: bool = False) -> _Open:
        if frame is not None:
            self.frame = frame
        row = [name, self.frame, self.stack[-1] if self.stack else -1, 0, 0]
        self.stack.append(len(self.rows))
        self.rows.append(row)
        row[3] = time.perf_counter_ns() + self.offset_ns
        return _Open(self, row, stops)


_REC = Recorder()


def span(name: str, frame: int | None = None):
    """A span around a `with` block; `frame` (where given) sets the frame
    id of this span and of every span after it, and under torch.profiler
    records the span and all inside it even while the recorder is off."""
    if not _REC.on:
        if frame is None or not _profiler_enabled():
            return OFF
        enable()
        return _REC.open(name, frame, stops=True)
    return _REC.open(name, frame)


def waited(site: str):
    """A point where the host waits for the card: one synchronization
    counted for `site`, and a `wait/<site>` span around the block."""
    if not _REC.on:
        return OFF
    _REC.syncs[site] = _REC.syncs.get(site, 0) + 1
    return _REC.open("wait/" + site, None)


def enable() -> None:
    """Record from now on, on a Unix clock offset taken now."""
    _REC.offset_ns = time.time_ns() - time.perf_counter_ns()
    _REC.on = True


def disable() -> None:
    _REC.on = False


def take() -> Records:
    """The spans closed and the syncs counted since the last take(); clears them."""
    out = Records([SpanRecord(*row) for row in _REC.rows], dict(_REC.syncs))
    _REC.rows, _REC.stack, _REC.syncs, _REC.frame = [], [], {}, None
    return out
