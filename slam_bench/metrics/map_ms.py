"""Mapping's time a frame: run_frame's mark("map") less mark("stage_kf"),
each after a synchronize (slam/steps.py mapping_phase)."""


def read(trace):
    return trace.mean_stage_ms("map")
