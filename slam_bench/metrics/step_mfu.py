"""The whole frame's share of the H100's float32 peak: the operations of
every compositing launch of the traced frames (K1 and K4 forward, K2 and K5
backward, counted from their own inputs by slam_bench/roofline.py: 30 a
contributing evaluation forward, 90 backward, and the fused kernels'
per-pair projection, 69 forward and 207 backward) over the traced frames'
wall time at 67 TFLOP/s, in %. The projection, binning, losses and Adam
outside the kernels are not counted, so this is a lower bound of the
frame's arithmetic; it bounds any kernel's gain end to end."""
from slam_bench import roofline


def read(trace):
    ops = sum(trace.ops_by_kernel.values())
    if ops <= 0 or trace.window_s <= 0 or trace.device != "cuda":
        return None
    return 100.0 * ops / (trace.window_s * roofline.PEAK_FLOPS_F32)
