"""Millions of (Gaussian, tile) pairs a structure build: the pairs the
traced frames' builds binned (render/binning.py build_bins.totals["pairs"],
the port's counter, kept a frame in trace.pairs) over the program's spans
named `build` a frame (render/api.py compute_pair_structure and the generic
render's own binning, as builds_per_frame counts them). The work each
generic iteration carries: it sets K2's and the build's time and their
per-pair memory. None without spans, or where no build ran."""
import statistics

from slam_bench import host_spans


def read(trace):
    got = host_spans.recorded(trace)
    if got is None or not trace.pairs:
        return None
    records, _, frames = got
    builds = sum(s.name == "build" for s in records) / frames
    if not builds:
        return None
    return statistics.fmean(trace.pairs) / builds / 1e6
