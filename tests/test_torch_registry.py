"""The port's kernel registry (splatam_tpu_torch/kernels.py) against what it
lists: the library's entries (render/_cuda.py _SIGNATURES), the wrappers'
launch counters and the instances they count, on the CPU. The registry's
device symbols against csrc/ are held in tests/test_torch_bounds.py."""
import copy

import pytest

from slam_bench.trace import Recorder
from splatam_tpu_torch import kernels
from splatam_tpu_torch.render import _cuda, composite, fused_iso, probes
from splatam_tpu_torch.scripts import harness


@pytest.fixture
def counters():
    """Every wrapper's counter as it was, put back after the test."""
    wrappers = {(m, a) for m, a, _ in (k.counter for k in kernels.KERNELS.values())}
    saved = {(m, a): copy.deepcopy(getattr(m, a).launches) for m, a in wrappers}
    yield
    for (m, a), launches in saved.items():
        getattr(m, a).launches = launches


def _bump(k: kernels.Kernel) -> None:
    """One launch of k's instance, counted as its wrapper counts it: through
    the wrapper's module attribute."""
    module, attr, key = k.counter
    if key is None:
        getattr(module, attr).launches += 1
    else:
        getattr(module, attr).launches[key] += 1


def test_every_library_entry_that_launches_belongs_to_a_row():
    launching = {e for e in _cuda._SIGNATURES
                 if not e.endswith("_info") and e != "last_error_string"}
    assert launching == {k.entry for k in kernels.KERNELS.values()}
    for k in kernels.KERNELS.values():
        assert k.entry in _cuda._SIGNATURES, k.name
        if k.info is not None:
            entry, *args = k.info
            # the entry's arguments, then its three output pointers
            assert len(_cuda._SIGNATURES[entry]) == len(args) + 3, k.name


def test_every_library_entry_takes_the_arguments_its_signature_lists():
    """Each extern "C" function of csrc/ against its _SIGNATURES entry, by
    name and by its number of parameters: ctypes passes an argument past
    the listed ones as a C int, which would cut a stream pointer."""
    import re

    text = "".join(p.read_text() for p in sorted(_cuda.CSRC.glob("*.cu")))
    arity = {m.group(1): len([a for a in m.group(2).split(",") if a.strip()])
             for m in re.finditer(r'extern "C"\s+(?:int|const char\s*\*)\s+(\w+)\s*\(([^)]*)\)',
                                  text)}
    assert set(arity) == set(_cuda._SIGNATURES)
    for name, argtypes in _cuda._SIGNATURES.items():
        assert arity[name] == len(argtypes), name


def test_the_rows_are_the_instances_the_wrappers_count():
    """43 rows: the SLAM loop's, the probes', the loss's, the projection's
    and the structure build's kernels, and K1/K2 at every other channel
    count and K3 at every other width; each key a dict counter holds has
    one row."""
    assert len(kernels.KERNELS) == 43 and len(kernels.WIDE) == 26
    assert kernels.PROBES == ("fwd2", "dma_only", "dma_b2", "dma_b4", "math_only")
    assert set(kernels.of("composite_forward")) == set(composite.CHANNELS)
    assert set(kernels.of("composite_backward")) == set(composite.CHANNELS)
    assert set(kernels.of("segment_reduce")) == set(composite.SEGMENT_WIDTHS)
    assert set(kernels.of("dma_walk")) == set(probes.DMA_BLOCKS)
    for module, attr, key in (k.counter for k in kernels.KERNELS.values()):
        launches = getattr(module, attr).launches
        if key is None:
            assert isinstance(launches, int), attr
        else:
            assert set(launches) == set(kernels.of(attr)), attr
    shorts = [k.short for k in kernels.KERNELS.values() if k.short]
    assert len(shorts) == len(set(shorts)) == 2 * len(composite.CHANNELS) + 2 + len(
        composite.SEGMENT_WIDTHS)


def test_launch_counts_reads_each_row_from_its_own_counter(counters):
    assert list(kernels.launch_counts()) == list(kernels.KERNELS)
    for k in kernels.KERNELS.values():
        before = kernels.launch_counts()
        _bump(k)
        after = kernels.launch_counts()
        assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {k.name: 1}


def test_reset_launch_counts_zeroes_every_row_in_its_counter_shape(counters):
    for k in kernels.KERNELS.values():
        _bump(k)
    assert all(kernels.launch_counts().values())
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert fused_iso.fused_forward.launches == 0
    assert composite.composite_forward.launches == dict.fromkeys(composite.CHANNELS, 0)


def test_counts_follow_the_wrappers_that_the_trace_recorder_swaps_in(counters):
    """slam_bench/trace.py's Recorder replaces four wrappers and carries
    their counters over; a launch counted while it is installed, and one
    after it is removed, both show in launch_counts()."""
    k1, k4 = kernels.KERNELS["composite_forward"], kernels.KERNELS["fused_forward"]
    kernels.reset_launch_counts()
    orig = composite.composite_forward, fused_iso.fused_forward
    rec = Recorder()
    rec.install()
    try:
        assert (composite.composite_forward, fused_iso.fused_forward) != orig
        for k in (k1, k4):
            _bump(k)
        assert [kernels.launch_counts()[k.name] for k in (k1, k4)] == [1, 1]
    finally:
        rec.remove()
    assert (composite.composite_forward, fused_iso.fused_forward) == orig
    for k in (k1, k4):
        _bump(k)
    assert [kernels.launch_counts()[k.name] for k in (k1, k4)] == [2, 2]


def test_route_names_the_kernels_that_launched_by_short_name():
    before = dict.fromkeys(kernels.KERNELS, 0)
    after = {**before, "fused_forward": 1, "segment_reduce": 3, "loss_track": 2,
             "composite_forward_ch3": 1}
    assert harness.route(before, after) == "K4x1 K3-8x3 loss_trackx2 K1-ch3x1"
    assert harness.route(before, before) == "none"
