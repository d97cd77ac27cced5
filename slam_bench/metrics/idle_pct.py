"""The share of the traced frames' wall time in which no kernel ran on the
card: 100 (1 - busy / window), busy being the union of the profiler's
kernel intervals; only where the profiler saw every launch of the port's
kernels (slam_bench/trace.py)."""


def read(trace):
    if not trace.verified or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
