"""Device milliseconds a frame in the port's fused_backward_kernel, from the
profiler's kernel intervals over whole traced frames."""


def read(trace):
    if not trace.verified or trace.kernel_count.get("fused_backward", 0) == 0:
        return None
    return 1e3 * trace.kernel_s["fused_backward"] / trace.frames
