"""slam_bench/peak_owner.py's split of the allocator's peak by program span,
on the CPU with a stand-in for torch.cuda's allocator statistics: each
stretch's peak goes to the innermost span open during it, a structure build
to `build_bins` with its bytes above entry and its pairs, the check frame
to nobody; and install's wrappers come off again."""
from slam_bench import check, peak_owner
from splatam_tpu_torch.render import binning
from splatam_tpu_torch.utils import spans
from tests.test_torch_binning_keyed import CAMERAS, synthetic_aux


class FakeCuda:
    """memory_allocated / max_memory_allocated / reset_peak_memory_stats."""

    def __init__(self):
        self.alloc = self.peak = 0

    def take(self, n: int) -> None:
        self.alloc += n
        self.peak = max(self.peak, self.alloc)

    def memory_allocated(self) -> int:
        return self.alloc

    def max_memory_allocated(self) -> int:
        return self.peak

    def reset_peak_memory_stats(self) -> None:
        self.peak = self.alloc


class FakeTorch:
    def __init__(self):
        self.cuda = FakeCuda()


def test_the_split_puts_each_peak_down_to_the_innermost_span():
    fake = FakeTorch()
    cuda = fake.cuda
    split = peak_owner.Split(fake)
    cam = CAMERAS["tum"]
    proj, aux = synthetic_aux(cam, 300, seed=6)
    originals = spans.span, binning.build_bins, check.check
    restore = peak_owner.install(split)
    try:
        with spans.span("map"):
            cuda.take(50)
            with spans.span("render"):
                cuda.take(100)
                cuda.take(-100)
                with spans.span("build"):
                    first = binning.build_bins(proj, aux, cam.width, cam.height)
            cuda.take(-50)
        binning.reset_pair_totals()  # the trace's reset, through the wrapper
        second = binning.build_bins(proj, aux, cam.width, cam.height)
        assert binning.build_bins.totals["pairs"] == second.n_pairs
    finally:
        restore()
    assert (spans.span, binning.build_bins, check.check) == originals
    assert binning.build_bins.totals["pairs"] == second.n_pairs
    assert split.peaks["render"] == 150 and split.peaks["map"] == 50
    assert split.peaks["build_bins"] == split.peaks["build"] == 50
    assert split.top == 150 and split.top_at == "map/render"
    assert split.held == [(0, first.n_pairs), (0, second.n_pairs)]
    assert first.n_pairs > 0


def test_the_split_leaves_out_what_follows_the_window():
    fake = FakeTorch()
    split = peak_owner.Split(fake)
    originals = spans.span, binning.build_bins, check.check
    seen = []
    check.check = lambda *a, **k: (fake.cuda.take(1000), seen.append(1))
    try:
        restore = peak_owner.install(split)
        try:
            with spans.span("map"):
                fake.cuda.take(20)
            check.check()
            with spans.span("map"):
                fake.cuda.take(5)
        finally:
            restore()
    finally:
        check.check = originals[2]
    assert seen == [1] and split.frozen
    assert split.top == 20 and dict(split.peaks) == {"outside": 20, "map": 20}
