"""Host milliseconds a frame spent waiting for the card: the summed
duration of the program's `wait/<site>` spans (one around each `waited`
site, splatam_tpu_torch/utils/spans.py) over the traced frames, over the
frames."""
from slam_bench import host_spans


def read(trace):
    return host_spans.wait_ms(trace)
