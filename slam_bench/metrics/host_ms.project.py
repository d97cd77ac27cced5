"""Host milliseconds a frame in the self time of the program's spans named
`project`: the generic render's projection in PyTorch (render/api.py
_render: project_gaussians, the EWA projection with its autograd graph),
which the fused route does inside its kernels. Summed over the traced
frames, over the frames; None for a program without the span."""
from slam_bench import host_spans


def read(trace):
    got = host_spans.recorded(trace)
    if got is None or not any(s.name == "project" for s in got[0]):
        return None
    return host_spans.self_ms(trace, "project")
