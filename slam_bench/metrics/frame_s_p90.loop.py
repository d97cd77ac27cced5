"""The 90th percentile of the untraced window's per-frame seconds
(statistics.quantiles, n=10), the slow frames where a live loop drops
sensor frames; the same window as frame_s.loop."""
import statistics


def read(trace):
    if len(trace.loop_frames) < 2:
        return None
    return statistics.quantiles(trace.loop_frames, n=10)[-1]
