"""The bounds' operation counts (render/bounds.py) and the profiler check of
the measurement harness (scripts/harness.py), on the CPU.

Each per-evaluation or per-pair operation count in bounds.py was counted by
hand from a device function in csrc/. The test pins the text of each such
function: an edit to one fails here until its counts are checked again and
the digest below is updated with them.
"""
import hashlib
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from splatam_tpu_torch.render import bounds
from splatam_tpu_torch.scripts import harness

CSRC = Path(bounds.__file__).resolve().parents[1] / "csrc"
# (file, device function) -> sha256 prefix of the text the counts were made from
COUNTED = {
    ("common.cuh", "composite_tile"): "4be9b73dca984eac",
    ("common.cuh", "project_iso"): "6ceb4c90acf8407e",
    ("composite_backward.cu", "composite_backward_kernel"): "598b5195a123f6b0",
    ("fused_backward.cu", "fused_backward_kernel"): "85b65cb1fb54a9b8",
    ("fused_backward.cu", "chain_to_world"): "6660f7970abd6bb6",
}


def _definition(file: str, name: str) -> str:
    """The text of `name`'s definition in csrc/`file`, signature to closing brace."""
    text = (CSRC / file).read_text()
    for m in re.finditer(rf"\b{name}\s*\(", text):
        brace, semi = text.find("{", m.end()), text.find(";", m.end())
        if brace != -1 and (semi == -1 or brace < semi):
            depth = 0
            for i in range(brace, len(text)):
                depth += {"{": 1, "}": -1}.get(text[i], 0)
                if depth == 0:
                    return text[m.start():i + 1]
    raise LookupError(f"no definition of {name} in {file}")


def test_every_count_names_a_pinned_function():
    named = {src for srcs in bounds.OP_SOURCES.values() for src in srcs}
    assert named == set(COUNTED)
    counts = {k for k in vars(bounds) if k.endswith("_OPS")}
    assert counts == set(bounds.OP_SOURCES)


@pytest.mark.parametrize("src", sorted(COUNTED), ids=lambda s: s[1])
def test_counted_function_is_unchanged(src):
    digest = hashlib.sha256(_definition(*src).encode()).hexdigest()[:16]
    counts = [k for k, srcs in bounds.OP_SOURCES.items() if src in srcs]
    assert digest == COUNTED[src], (
        f"{src[1]} ({src[0]}) changed: count {', '.join(counts)} again in bounds.py, then "
        f"set its digest here to {digest}")


def test_kernel_symbols_are_the_global_functions_of_csrc():
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    found = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text)
    assert sorted(found) == sorted(harness.KERNEL_SYMBOLS)


def test_port_launches_seen_counts_only_the_port_kernels():
    events = [SimpleNamespace(key="void splatam::segment_reduce_kernel<8>(float const*)", count=3),
              SimpleNamespace(key="splatam::fused_forward_kernel(float const*)", count=2),
              SimpleNamespace(key="splatam::fused_forward2_kernel(float const*)", count=1),
              SimpleNamespace(key="void at::native::vectorized_elementwise_kernel<4>()", count=50),
              SimpleNamespace(key="my_fused_forward_kernel_copy()", count=7)]
    assert harness.port_launches_seen(events) == 6
    assert harness.port_launches_seen([]) == 0
