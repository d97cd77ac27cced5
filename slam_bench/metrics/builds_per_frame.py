"""Structure builds a frame: the program's spans named `build`
(render/api.py compute_pair_structure and the generic render's own
binning), counted over the traced frames, over the frames. With
tpu.rebin_every 1 every tracking and mapping iteration builds one, and
densification one more."""
from slam_bench import host_spans


def read(trace):
    got = host_spans.recorded(trace)
    if got is None:
        return None
    records, _, frames = got
    return sum(s.name == "build" for s in records) / frames
