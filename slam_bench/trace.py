"""The traced run's readings: whole frames under torch.profiler (device
activity only), the program's stage marks, counters and launches.

Per traced frame:
  * run_frame's `mark` callback ends each stage with a synchronize, so
    the stage times (compact, track, densify, select_kf, stage_kf, map)
    are spans on the host clock;
  * build_bins.totals counts the pairs the frame's structure builds binned;
  * the profiler gives every device kernel's interval: the busy time (their
    union), the kernels by name, the launches, the idle gaps;
  * a frame counts only when the profiler saw every launch of the port's
    kernels that the port's wrappers counted (a copy of the arithmetic of
    splatam_tpu_torch/scripts/harness.py Busy.verified); the profiler
    drops launches now and then, so the run traces another frame then;
  * the inputs of every compositing launch (K1, K2, K4, K5) are kept during
    the frame, through wrappers around the port's launch functions, and
    counted after it by slam_bench/roofline.py.
"""
from __future__ import annotations

import statistics
import time
from collections import defaultdict
from dataclasses import dataclass, field

from slam_bench import roofline
from slam_bench.loop import Loop, sync

# The port's __global__ functions as the profiler names them, by kernel.
SYMBOLS = {"composite_forward": "composite_forward_kernel",
           "composite_backward": "composite_backward_kernel",
           "fused_forward": "fused_forward_kernel", "fused_backward": "fused_backward_kernel",
           "segment_reduce": "segment_reduce_kernel",
           "segment_reduce_half": "segment_reduce_half_kernel",
           "fused_forward2": "fused_forward2_kernel", "dma_walk": "dma_walk_kernel",
           "fused_math_only": "fused_math_only_kernel"}


def port_launches() -> int:
    """The launches the port's wrappers have counted so far (its counters)."""
    from splatam_tpu_torch.render import composite, fused_iso, probes

    return (fused_iso.fused_forward.launches + fused_iso.fused_backward.launches
            + sum(composite.composite_forward.launches.values())
            + sum(composite.composite_backward.launches.values())
            + sum(composite.segment_reduce.launches.values())
            + probes.fwd2.launches + probes.math_only.launches
            + sum(probes.dma_walk.launches.values()))


def kernel_of(name: str) -> str | None:
    """The port's kernel a profiler event belongs to, or None."""
    for kernel, sym in SYMBOLS.items():
        if f"::{sym}" in name or name.startswith(sym):
            return kernel
    return None


def short(name: str) -> str:
    """A kernel's name without 'void', its parameters and its template arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).split("(")[0][:160]


class Recorder:
    """Keeps the inputs of every compositing launch while installed, by
    wrapping the port's launch functions (their launch counters carry over)."""

    def __init__(self):
        self.launches: list[roofline.Launch] = []
        self._saved = []

    def install(self) -> None:
        from splatam_tpu_torch.render import composite, fused_iso

        for module, name in ((fused_iso, "fused_forward"), (fused_iso, "fused_backward"),
                             (composite, "composite_forward"),
                             (composite, "composite_backward")):
            orig = getattr(module, name)
            wrapper = self._wrap(name, orig)
            wrapper.launches = orig.launches
            setattr(module, name, wrapper)
            self._saved.append((module, name, orig, wrapper))

    def remove(self) -> None:
        for module, name, orig, wrapper in self._saved:
            orig.launches = wrapper.launches
            setattr(module, name, orig)
        self._saved = []

    def _wrap(self, name: str, orig):
        fused = name.startswith("fused")

        def wrapper(rows, *args, **kwargs):
            if fused:  # (world8, pose, tile_start, w, h[, state, g][, pair_gauss])
                pose, tile_start, width, height = args[:4]
                pair_gauss = kwargs.get("pair_gauss", args[-1] if len(args) in (5, 7) else None)
                channels = 5
            else:  # (attrs, pair_gauss, tile_start, w, h[, state, g])
                pose = None
                pair_gauss, tile_start, width, height = args[:4]
                channels = rows.shape[1] - 6
            self.launches.append(roofline.Launch(name, rows.detach(), pose, tile_start,
                                                 pair_gauss, width, height, channels))
            return orig(rows, *args, **kwargs)
        return wrapper


@dataclass
class Trace:
    """The traced frames, summed; what the per-layer readers read."""

    device: str
    frames: int = 0
    window_s: float = 0.0  # the traced frames' wall time
    busy_s: float = 0.0  # union of the device's kernel intervals
    verified: bool = False  # the frames' profiles saw every port launch (on the card)
    stage_ms: dict = field(default_factory=lambda: defaultdict(list))
    pairs: list = field(default_factory=list)
    launches: list = field(default_factory=list)  # device kernels per frame
    kernel_s: dict = field(default_factory=lambda: defaultdict(float))
    kernel_count: dict = field(default_factory=lambda: defaultdict(int))
    ops_by_kernel: dict = field(default_factory=lambda: defaultdict(float))
    bound_s: dict = field(default_factory=lambda: defaultdict(float))
    counted: dict = field(default_factory=lambda: defaultdict(int))
    by_name: dict = field(default_factory=lambda: defaultdict(float))
    gaps: list = field(default_factory=list)
    loop_s: float = 0.0  # the untraced window before the traced frames: its wall time
    loop_frames: list = field(default_factory=list)  # and each of its frames' seconds

    def mean_stage_ms(self, stage: str) -> float | None:
        vals = self.stage_ms.get(stage)
        return statistics.fmean(vals) if vals else None

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def _device_events(prof):
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name))
    return sorted(out)


def trace_frame(loop: Loop, i: int, tr: Trace) -> tuple[int, int]:
    """Run frame i under the profiler. Its readings join tr only where the
    profiler saw every launch of the port's kernels the wrappers counted
    (on the CPU, which has no device trace, always). Returns (launches the
    profiler saw, launches counted)."""
    from torch.profiler import ProfilerActivity, profile

    from splatam_tpu_torch.render import binning

    marks = []

    def mark(stage: str) -> None:
        sync(loop.device)
        marks.append((stage, time.perf_counter()))

    rec = Recorder()
    sync(loop.device)
    binning.reset_pair_totals()
    before = port_launches()
    rec.install()
    cuda = loop.device.type == "cuda"
    try:
        with profile(activities=[ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
                     ) as prof:
            wall = loop.frame(i, mark)
    finally:
        rec.remove()
    launched = port_launches() - before
    events = _device_events(prof) if cuda else []
    seen = sum(kernel_of(name) is not None for _, _, name in events)
    if cuda and (seen != launched or not events):
        return seen, launched
    tr.verified = cuda
    tr.frames += 1
    tr.window_s += wall
    tr.pairs.append(binning.build_bins.totals["pairs"])
    for (_, t0), (stage, t1) in zip(marks, marks[1:]):
        tr.stage_ms[stage].append((t1 - t0) * 1e3)
    busy, end, last_name, n_kernels = 0.0, None, None, 0
    for start, stop, name in events:
        kernel = kernel_of(name)
        if not name.startswith(("Memcpy", "Memset")):
            n_kernels += 1
        tr.by_name[kernel or short(name)] += stop - start
        if kernel is not None:
            tr.kernel_s[kernel] += stop - start
            tr.kernel_count[kernel] += 1
        if end is None or start > end:
            if end is not None:
                tr.gaps.append([f"{last_name} -> {short(name)}", start - end])
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
        last_name = short(name)
    tr.busy_s += busy
    tr.launches.append(n_kernels)
    counts: dict = {}
    for launch in rec.launches:
        key = launch.key()
        if key not in counts:
            counts[key] = roofline.evaluations(launch)
        w = roofline.work(launch, counts[key])
        tr.ops_by_kernel[w.kernel] += w.ops
        tr.bound_s[w.kernel] += w.bound_s
        tr.counted[w.kernel] += 1
    return seen, launched
