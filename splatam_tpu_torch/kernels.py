"""The port's hand-written CUDA kernels, one row for each instance whose
launches a wrapper counts: names, counter, library entries, device symbols,
origin and the contract chip_smoke.py holds it to. Adding a kernel takes its
csrc/*.cu source, its render/_cuda.py _SIGNATURES entry and wrapper, and a row.
Wrappers keep `.launches` (an int, or a dict by channels, columns, blocks or
route) and bump it through their module-global names, which slam_bench's
Recorder swaps: counts are read through the module attribute at call time."""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

from splatam_tpu_torch.core import fused_loss
from splatam_tpu_torch.render import binning, composite, fused_iso, probes, projection

_PALLAS, _CSRC = "splatam_tpu/render/pallas/", "splatam_tpu_torch/csrc/"


class Kernel(NamedTuple):
    name: str  # as launch_counts() and chip_smoke.py report it
    short: str | None  # K1 to K5 and their instances (None: the name)
    counter: tuple  # (module, wrapper attribute, key into its .launches or None)
    entry: str  # the _SIGNATURES entry it launches through
    symbols: tuple  # the __global__ functions its launches run
    info: tuple | None  # (its *_info entry, *that entry's arguments)
    replaces: str  # the TPU kernel, or what the JAX package leaves to XLA
    source: str
    tol: float | None  # each output row within tol of its plain version's largest
    image: bool = False  # an image whose last row (n_contrib) is exact
    bit_equal: bool = False  # equal to its plain version bit for bit
    deterministic: bool = False  # two launches equal bit for bit


# Tolerances: the forwards round like their plain versions (-fmad=false): 1e-5
# leaves room for expf and division. K2 and K5 sum a pair's per-pixel terms by
# warp shuffles, then in warp order: 1e-4. K3 and the dma walks add the same
# floats in another order than their plain versions: 1e-5.
def _composite(kind: str, ch: int, short: str, line: int, tol: float, **contract) -> Kernel:
    loop = ch == composite.CH
    return Kernel(kind if loop else f"{kind}_ch{ch}", short if loop else f"{short}-ch{ch}",
                  (composite, kind, ch), kind, (f"{kind}_kernel",), (f"{kind}_info", ch),
                  f"{_PALLAS}composite_pallas.py:{line}", f"{_CSRC}{kind}.cu", tol, **contract)


_k1 = partial(_composite, "composite_forward", short="K1", line=288, tol=1e-5, image=True,
              bit_equal=True)
_k2 = partial(_composite, "composite_backward", short="K2", line=518, tol=1e-4,
              deterministic=True)


def _k3(k: int) -> Kernel:  # 8 columns: the float4 kernel where both buffers are aligned
    return Kernel({8: "segment_reduce", 11: "segment_reduce11"}.get(k, f"segment_reduce{k}"),
                  f"K3-{k}", (composite, "segment_reduce", k), "segment_reduce",
                  ("segment_reduce_half_kernel",) * (k == 8) + ("segment_reduce_kernel",),
                  ("segment_reduce_info", k), f"{_PALLAS}composite_pallas.py:615",
                  f"{_CSRC}segment_reduce.cu", 1e-5, deterministic=True)


def _probe(name: str, key, entry: str, line: str, image: bool = False) -> Kernel:
    attr, symbol = (name, f"{entry}_kernel") if key is None else ("dma_walk", "dma_walk_kernel")
    return Kernel(name, None, (probes, attr, key), entry, (symbol,), None, f"scripts/{line}",
                  f"{_CSRC}fused_probes.cu", 1e-5, image=image)


_LOOP_WIDTHS = (8, 6 + composite.CH)  # K3 in the SLAM loop: K5's rows, K2's at five channels
_PROJECT = "splatam_tpu/render/projection.py project"
_ROWS = (
    _k1(composite.CH), _k2(composite.CH),
    Kernel("fused_forward", "K4", (fused_iso, "fused_forward", None), "fused_forward",
           ("fused_forward_kernel",), ("fused_forward_info",), f"{_PALLAS}fused_iso.py:311",
           f"{_CSRC}fused_forward.cu", 1e-5, image=True, bit_equal=True),
    Kernel("fused_backward", "K5", (fused_iso, "fused_backward", None), "fused_backward",
           ("fused_backward_kernel",), ("fused_backward_info",), f"{_PALLAS}fused_iso.py:632",
           f"{_CSRC}fused_backward.cu", 1e-4, deterministic=True),
    *(_k3(k) for k in _LOOP_WIDTHS),
    _probe("fwd2", None, "fused_forward2", "probe_unroll.py:237", image=True),
    *(_probe("dma_only" if b == 1 else f"dma_b{b}", b, f"dma_walk{b}",
             f"probe_dma.py:{147 if b == 1 else 173}") for b in probes.DMA_BLOCKS),
    _probe("math_only", None, "fused_math_only", "probe_dma.py:290", image=True),
    # a call counts two launches: its route's tile kernel and the reduction
    *(Kernel(f"loss_{r}", None, (fused_loss, "loss_terms", r), "loss_forward",
             (f"loss_{r}_tile_kernel", "loss_reduce_kernel"), ("loss_info", int(r == "map")),
             "none (XLA fuses splatam_tpu/slam/steps.py get_loss)", f"{_CSRC}loss.cu", 1e-5,
             deterministic=True) for r in ("track", "map")),
    Kernel("project_forward", None, (projection, "project_forward", None), "project_forward",
           ("project_fwd_kernel",), ("project_info", 0), f"none (XLA fuses {_PROJECT})",
           f"{_CSRC}projection.cu", None, bit_equal=True),
    Kernel("project_backward", None, (projection, "project_backward", None), "project_backward",
           ("project_bwd_kernel",), ("project_info", 1), f"none (jax.vjp of {_PROJECT})",
           f"{_CSRC}projection.cu", 1e-5, deterministic=True),
    # the structure build's expansion and scatter: integer outputs, exact
    *(Kernel(f"bins_{step}", None, (binning, f"bins_{step}", None), f"bins_{step}",
             (f"bins_{step}_kernel",), ("bins_info", i),
             "none (XLA: splatam_tpu/render/binning.py build_bins)", f"{_CSRC}binning.cu", None,
             bit_equal=True) for i, step in enumerate(("expand", "scatter"))),
)
# K1 and K2 at every other channel count, K3 at every other width of the
# generic render's rows (6 + ch): render_gaussians alone launches these.
_WIDE = (*(_k1(c) for c in composite.CHANNELS if c != composite.CH),
         *(_k2(c) for c in composite.CHANNELS if c != composite.CH),
         *(_k3(k) for k in composite.SEGMENT_WIDTHS if k not in _LOOP_WIDTHS))

KERNELS = {k.name: k for k in (*_ROWS, *_WIDE)}
WIDE = tuple(k.name for k in _WIDE)
PROBES = tuple(k.name for k in _ROWS if k.counter[0] is probes)
SYMBOLS = tuple(dict.fromkeys(s for k in KERNELS.values() for s in k.symbols))


def of(wrapper: str) -> dict:
    """The rows counting one wrapper's launches, by key (None: a plain count)."""
    return {k.counter[2]: k for k in KERNELS.values() if k.counter[1] == wrapper}


def _count(module, attr: str, key) -> int:
    count = getattr(module, attr).launches
    return count if key is None else count[key]


def launch_counts() -> dict:
    """Every kernel's launches so far, by name."""
    return {name: _count(*k.counter) for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for module, attr, key in (k.counter for k in KERNELS.values()):
        if key is None:
            getattr(module, attr).launches = 0
        else:
            getattr(module, attr).launches[key] = 0
