"""Where a cell's device-memory peak sits, by the program span open at the
time: one run of slam_bench.run with the program's span recorder
(splatam_tpu_torch.utils.spans.span) and structure build
(render/binning.py build_bins) wrapped, so that the allocator's peak
(torch.cuda.max_memory_allocated) is read and reset at every span boundary
and each stretch is put down to the innermost open span, a build as its own
`build_bins`. The check unit after the window is left out: the cell's loop's
`check` (slam_bench/loops/<loop>.py) is wrapped to freeze the split. Prints, after
the run's own lines on standard error: the run's peak and the span path
holding it, each span's peak, and the bytes each build held above what was
live when it started, a pair.

    python3 -m slam_bench.peak_owner --workload tum.fr1_desk --seed 7 \\
        --seconds 30 --trace 0

The readings and resets add no launch and no sync; the run's own
memory_peak_gb then reads the last stretch only, so use this run for the
split and not for the metric.
"""
from __future__ import annotations

import sys
from collections import defaultdict


class Split:
    """The peak of each innermost span, and of every build a pair."""

    def __init__(self, torch):
        self.torch = torch
        self.stack = ["outside"]
        self.peaks = defaultdict(int)
        self.top, self.top_at = 0, ""
        self.frozen = False
        self.held: list[tuple[int, int]] = []  # (bytes above entry, pairs) a build

    def fold(self) -> None:
        """Put the peak since the last fold down to the innermost span."""
        cuda = self.torch.cuda
        peak = cuda.max_memory_allocated()
        if not self.frozen:
            name = self.stack[-1]
            self.peaks[name] = max(self.peaks[name], peak)
            if peak > self.top:
                self.top, self.top_at = peak, "/".join(self.stack[1:])
        cuda.reset_peak_memory_stats()

    def enter(self, name: str) -> None:
        self.fold()
        self.stack.append(name)

    def leave(self) -> None:
        self.fold()
        self.stack.pop()

    def report(self, out) -> None:
        print(f"peak_owner: run peak {self.top} B in {self.top_at or 'outside'}", file=out)
        for name, peak in sorted(self.peaks.items(), key=lambda kv: -kv[1]):
            print(f"peak_owner: span {name} peak {peak} B", file=out)
        per_pair = sorted(b / p for b, p in self.held if p)
        if per_pair:
            print(f"peak_owner: {len(self.held)} builds; bytes above entry a pair: min "
                  f"{per_pair[0]:.1f} median {per_pair[len(per_pair) // 2]:.1f} max "
                  f"{per_pair[-1]:.1f}; the largest hold {max(b for b, _ in self.held)} B",
                  file=out)


class _Spanned:
    def __init__(self, split: Split, inner, name: str):
        self.split, self.inner, self.name = split, inner, name

    def __enter__(self):
        self.split.enter(self.name)
        return self.inner.__enter__()

    def __exit__(self, *exc):
        out = self.inner.__exit__(*exc)
        self.split.leave()
        return out


def install(split: Split, loop=None):
    """Wrap spans.span, binning.build_bins and the `check` of `loop`, a loop
    file's module (spec.Cell.loop; by default slam_bench.check, whose check
    the online loop's calls): the check unit freezes the split. Returns a
    function that unwraps them."""
    if loop is None:
        from slam_bench import check as loop
    from splatam_tpu_torch.render import binning
    from splatam_tpu_torch.utils import spans

    span, build_bins, check_fn = spans.span, binning.build_bins, loop.check
    spans.span = lambda name, frame=None: _Spanned(split, span(name, frame), name)

    def build(*args, **kwargs):
        split.enter("build_bins")
        entry = split.torch.cuda.memory_allocated()
        pairs = binning.build_bins.totals["pairs"]
        try:
            return build_bins(*args, **kwargs)
        finally:
            split.held.append((split.torch.cuda.max_memory_allocated() - entry,
                               binning.build_bins.totals["pairs"] - pairs))
            split.leave()

    # build_bins reads and reset_pair_totals writes its totals through the
    # module's name, now this wrapper: keep them one dict
    build.totals = build_bins.totals
    binning.build_bins = build

    def frozen_check(*args, **kwargs):
        split.fold()
        split.frozen = True
        return check_fn(*args, **kwargs)

    loop.check = frozen_check

    def restore() -> None:
        build_bins.totals = binning.build_bins.totals
        spans.span, binning.build_bins, loop.check = span, build_bins, check_fn

    return restore


def main(argv=None) -> int:
    import torch

    from slam_bench import run, spec

    if not torch.cuda.is_available():
        print("peak_owner: needs a CUDA device", file=sys.stderr)
        return 2
    split = Split(torch)
    # the Cell that run.main builds hands out this same loop module, wrapped
    install(split, spec.Cell(spec.load(), run.parse(argv).workload).loop)
    rc = run.main(argv)
    split.fold()
    split.report(sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
