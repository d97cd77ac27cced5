"""K5's share of its roofline (fused_backward_kernel, csrc/fused_backward.cu
through render/fused_iso.py): the least time the H100 needs for the work of
every K5 launch of the traced frames, over the time the profiler gave those
launches, in %.

The work is counted from each launch's own inputs (its world-8 rows, pose
and sorted pairs), by the plain reference's rules, so it is the same
whatever kernel does it (slam_bench/roofline.py):
  * per contributing (pixel, pair) evaluation, 90 operations: the forward's
    offset, power, exp, clamped alpha and tests again (16); T recovered as
    T / (1 - alpha) (2); the five channels' gradients alpha T g_k (11); the
    back-to-front colour of six channels, the silhouette's constant 1
    included (19); dL/dalpha = T sum_k (c_k - accum_k) g_k (19); the clamp
    test and dL/dG (2); dL/dpower (1); dL/dx, dL/dy (8); dL/d(a, b, c) (5);
    the pair's running sums of dxy, dconic, dopacity (7);
  * per pair, 207: the in-kernel isotropic projection again (69: transform
    18, NDC and pixel 16, clamped Jacobian 14, covariance 12, inverse and
    conic 9) and two operations for each of them in its chain rule;
  * bytes: the world-8 rows the pairs reference, the pair list, the tile
    starts and the pose, the forward's state (7 x H x W) and the cotangents
    (6 x H x W) read once, the per-pair gradients (8 floats a pair) written
    once.
The bound is the larger of the operations at 67 TFLOP/s (float32) and the
bytes at 3.35 TB/s; the result line gives the card's power limit beside it.
"""


def read(trace):
    k = "fused_backward"
    if (not trace.verified or trace.counted.get(k, 0) == 0
            or trace.counted[k] != trace.kernel_count.get(k, 0) or trace.kernel_s[k] <= 0):
        return None
    return 100.0 * trace.bound_s[k] / trace.kernel_s[k]
