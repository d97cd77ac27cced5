"""Host synchronizations a frame: every point of the frame's path where the
host waits for the card (a read back, a blocking upload from pageable
memory, a count that sizes a buffer), each counted by the program's
`waited` site as it runs (splatam_tpu_torch/utils/spans.py), summed over
the traced frames, over the frames."""
from slam_bench import host_spans


def read(trace):
    return host_spans.syncs_per_frame(trace)
