"""Tracking's time a frame: run_frame's mark("track") less mark("compact"),
each after a synchronize (slam/steps.py tracking_phase)."""


def read(trace):
    return trace.mean_stage_ms("track")
