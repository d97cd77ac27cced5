"""Device milliseconds a frame in the structure build's kernels
(splatam_tpu_torch/csrc/binning.cu: bins_expand_kernel and
bins_scatter_kernel), from the profiler's kernel intervals by name over
whole traced frames; None where neither ran (a program whose build is
PyTorch's own ops)."""

NAMES = ("bins_expand_kernel", "bins_scatter_kernel")


def read(trace):
    if not trace.verified or not trace.frames:
        return None
    got = [s for name, s in trace.by_name.items() if name.split("::")[-1] in NAMES]
    if not got:
        return None
    return 1e3 * sum(got) / trace.frames
