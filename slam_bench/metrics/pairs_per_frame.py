"""Millions of (Gaussian, tile) pairs the frame's structure builds binned
(render/binning.py build_bins.totals["pairs"], the port's counter)."""
import statistics


def read(trace):
    return statistics.fmean(trace.pairs) / 1e6 if trace.pairs else None
