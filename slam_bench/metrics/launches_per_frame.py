"""Device kernels a frame launches, all of them (the port's and PyTorch's),
as the profiler recorded them over whole traced frames (memory copies and
sets left out). Only where the profiler saw every launch of the port's
kernels."""
import statistics


def read(trace):
    if not trace.verified or not trace.launches:
        return None
    return statistics.fmean(trace.launches)
