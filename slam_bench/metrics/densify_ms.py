"""Densification's time a frame: run_frame's mark("densify") less
mark("track"), each after a synchronize (slam/steps.py densify_growing)."""


def read(trace):
    return trace.mean_stage_ms("densify")
