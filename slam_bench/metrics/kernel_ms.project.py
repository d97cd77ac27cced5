"""Device milliseconds a frame in the generic render's projection kernels
(splatam_tpu_torch/csrc/projection.cu: project_fwd_kernel and
project_bwd_kernel), from the profiler's kernel intervals by name over
whole traced frames; None where neither ran (a program whose projection is
PyTorch's own ops)."""

NAMES = ("project_fwd_kernel", "project_bwd_kernel")


def read(trace):
    if not trace.verified or not trace.frames:
        return None
    got = [s for name, s in trace.by_name.items() if name.split("::")[-1] in NAMES]
    if not got:
        return None
    return 1e3 * sum(got) / trace.frames
