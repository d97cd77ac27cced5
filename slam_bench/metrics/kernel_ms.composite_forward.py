"""Device milliseconds a frame in the port's composite_forward_kernel (K1),
from the profiler's kernel intervals over whole traced frames."""


def read(trace):
    if not trace.verified or trace.kernel_count.get("composite_forward", 0) == 0:
        return None
    return 1e3 * trace.kernel_s["composite_forward"] / trace.frames
