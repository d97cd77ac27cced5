"""What the measurement scripts share: the device rule, timing and the
kernels' routes (their launch counts: splatam_tpu_torch/kernels.py)."""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import NamedTuple

import torch

from splatam_tpu_torch import kernels
from splatam_tpu_torch.utils.device import require_device


def route(before: dict, after: dict) -> str:
    """The launches between two kernels.launch_counts(), by short name."""
    return " ".join(f"{k.short or n}x{after[n] - before[n]}" for n, k in kernels.KERNELS.items()
                    if after[n] != before[n]) or "none"


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu runs the kernels' plain versions")
    return ap


def resolve_device(name: str, prog: str) -> torch.device:
    """The device the caller asked for; exits 2 when that is a GPU and there
    is none (no fallback to the CPU)."""
    try:
        return require_device(name, prog)
    except RuntimeError as err:
        print(err, file=sys.stderr)
        sys.exit(2)


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(device)})"
    return "cpu (plain versions; host times only)"


class Busy(NamedTuple):
    """What torch.profiler saw of one window on the card."""

    ms: float  # device time of every kernel it recorded
    seen: int  # launches of the port's kernels among the profiler's events
    launched: int  # launches the port's wrappers counted in the same window
    events: list  # the profiler's device events, largest device time first

    @property
    def verified(self) -> bool:
        """The profiler recorded every launch of the port's kernels."""
        return self.seen == self.launched and self.ms > 0


class Timing(NamedTuple):
    """Milliseconds per call; event and busy times are None on the CPU."""

    wall: float  # host clock over `iters` calls ending in a synchronize
    event: float | None  # CUDA events around the same calls
    busy: Busy | None  # torch.profiler over another `iters` calls, ms per call


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_launches_seen(events) -> int:
    """Launches of the port's kernels among profiler events (key, count);
    the keys are demangled, "void splatam::segment_reduce_kernel<8>(...)"."""
    return sum(e.count for e in events if any(f"::{sym}" in e.key for sym in kernels.SYMBOLS))


def profile_device(fn, device: torch.device, per: int = 1) -> Busy:
    """Run fn once under torch.profiler (device activity only) and sum the
    device time of every kernel, divided by `per`. The sum counts only if
    it is `verified`: the profiler recorded every launch of the port's
    kernels that the wrappers counted in the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    before = sum(kernels.launch_counts().values())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    launched = sum(kernels.launch_counts().values()) - before
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    return Busy(busy_us / 1e3 / per, port_launches_seen(events), launched, events)


def device_busy(fn, device: torch.device, iters: int, tries: int = 3) -> Busy:
    """profile_device over `iters` calls of fn, ms per call; profiled again,
    up to `tries` times, while the profiler misses some of the port's
    launches (on an H100 it has dropped some or all of them in windows of a
    few ms, now and then, profiler_check.py)."""
    for _ in range(tries):
        busy = profile_device(lambda: [fn() for _ in range(iters)], device, per=iters)
        if busy.verified:
            break
    return busy


def time_calls(fn, device: torch.device, iters: int, reps: int, warmup: int = 1,
               busy: bool = False) -> Timing:
    """Median over `reps` runs of `iters` calls each, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    cuda = device.type == "cuda"
    walls, events = [], []
    for _ in range(reps):
        _sync(device)
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if cuda:
            end.record()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3 / iters)
        if cuda:
            events.append(start.elapsed_time(end) / iters)
    return Timing(statistics.median(walls), statistics.median(events) if cuda else None,
                  device_busy(fn, device, iters) if busy and cuda else None)


def fmt_ms(x: float | None) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def fmt_busy(b: Busy | None) -> str:
    if b is None:
        return "not measured"
    if not b.verified:
        return (f"unverified ({b.ms:.3f} ms; the profiler saw {b.seen} of {b.launched} "
                "kernel launches)")
    if not b.launched:
        return f"{b.ms:.3f} ms (unchecked: no kernel of the port)"
    return f"{b.ms:.3f} ms ({b.seen} of {b.launched} kernel launches seen)"


def verified_ms(b: Busy | None) -> float | None:
    """The busy ms of a verified window, else None."""
    return b.ms if b is not None and b.verified else None
