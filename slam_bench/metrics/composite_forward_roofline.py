"""K1's share of its roofline (composite_forward_kernel,
csrc/composite_forward.cu through render/composite.py): the least time the
H100 needs for the work of every K1 launch of the traced frames, over the
time the profiler gave those launches, in %.

The work is counted from each launch's own inputs (its attribute rows and
sorted pairs), by the plain reference's rules (slam_bench/roofline.py):
  * per contributing (pixel, pair) evaluation, 30 operations: d = xy -
    pixel (2); the power (9); the power > 0 test (1); exp (1); alpha and
    its clamp (2); the alpha < 1/255 test (1); T (1 - alpha) and its test
    against 1e-4 (3); the weight alpha T (1); five channels accumulated (10);
  * no per-pair projection: the generic render projects in PyTorch;
  * bytes: the attribute rows (6 + 5 floats) the pairs reference, the pair
    list and the tile starts read once, the image (channels, silhouette and
    n_contrib, 7 x H x W) written once.
The bound is the larger of the operations at 67 TFLOP/s (float32) and the
bytes at 3.35 TB/s; the result line gives the card's power limit beside it.
"""


def read(trace):
    k = "composite_forward"
    if (not trace.verified or trace.counted.get(k, 0) == 0
            or trace.counted[k] != trace.kernel_count.get(k, 0) or trace.kernel_s[k] <= 0):
        return None
    return 100.0 * trace.bound_s[k] / trace.kernel_s[k]
