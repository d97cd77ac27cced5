"""The window's wall time over its frames, as the end-to-end frame_s was
before it left the end-to-end metrics (PERF.md section 2): the untraced
window that a traced run measures before its traced frames, each frame
prepare_frame + run_frame + a synchronize (slam_bench/loop.py)."""


def read(trace):
    if not trace.loop_frames:
        return None
    return trace.loop_s / len(trace.loop_frames)
