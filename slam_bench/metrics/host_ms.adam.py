"""Host milliseconds a frame in the self time of the program's spans named
`adam`: the optim.adam_step call sites of tracking and mapping
(slam/steps.py). A span's self time is its duration less the part its child
spans cover, so the waits inside it are not counted
(splatam_tpu_torch/utils/spans.py, slam_bench/host_spans.py); summed over
the traced frames, over the frames."""
from slam_bench import host_spans


def read(trace):
    return host_spans.self_ms(trace, "adam")
