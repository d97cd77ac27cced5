"""Host milliseconds a frame in the self time of the program's spans named
`build`: the structure builds, projection and binning (render/api.py
compute_pair_structure, and the generic render's own binning) in tracking,
mapping and densification. A span's self time is its duration less the part
its child spans cover, so the waits inside it are not counted
(splatam_tpu_torch/utils/spans.py, slam_bench/host_spans.py); summed over
the traced frames, over the frames."""
from slam_bench import host_spans


def read(trace):
    return host_spans.self_ms(trace, "build")
