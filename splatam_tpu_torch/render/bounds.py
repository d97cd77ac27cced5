"""The least time the card could take for each kernel's work (its bound).

bound_ms = max(bytes / HBM rate, ops / f32 rate), NVIDIA's data-sheet peaks
of one H100 SXM at its full 700 W limit: 3.35 TB/s of HBM, 67 TFLOP/s of
float32 outside the tensor cores. Bytes count each input read once and each
output written once. Ops count the float32 operations the kernel does on
these inputs, from its source: each arithmetic operator, comparison,
min/max, division and expf is one operation.

The compositing walks stop early, so their work depends on the data:
`walk_counts` runs the plain front-to-back walk over the same inputs and
counts, per pixel inside the image, the pair evaluations up to the pair
where the walk stops (or the tile's end) and which branch each took. The
backward walks evaluate each pixel's pairs below its n_contrib.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatam_tpu_torch.render.composite import (
    ALPHA_MAX,
    ALPHA_MIN,
    T_EPS,
    _pair_alpha,
    _tile_frame,
)

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Per pair-pixel evaluation of the forward walk (the loop body of
# composite_tile, common.cuh):
EVAL_OPS = 13  # dx, dy, power, the power > 0 test
ALPHA_OPS = 4  # expf, opacity * G, the 0.99 clamp, the 1/255 test (power <= 0)
HIT_OPS = 3  # T * (1 - alpha), the T < 1e-4 test (alpha >= 1/255)
APPLY_OPS = 12  # the weight, 5 channels * (mul + add), n_contrib (applied)
# Per pair-pixel evaluation of the backward walks (the reverse loop of
# composite_backward_kernel and fused_backward_kernel), on top of EVAL_OPS
# and ALPHA_OPS:
BWD_APPLY_OPS = 51 + 11  # T / (1 - alpha), the weight, 6 suffix channels, and the
#                          11 adds that sum the pair's gradient over its pixels
BWD_UNCLAMPED_OPS = 22  # dpower and the conic / xy / opacity terms (alpha not clamped)
# Per staged pair:
PROJ_OPS = 79  # project_iso (common.cuh) and tz^2
CHAIN_OPS = 138  # chain_to_world (fused_backward.cu)
# The device functions (csrc/ file, name) each count was made from; the
# tests pin those functions' text, so an edit to one asks for a recount.
OP_SOURCES = {
    "EVAL_OPS": (("common.cuh", "composite_tile"),),
    "ALPHA_OPS": (("common.cuh", "composite_tile"),),
    "HIT_OPS": (("common.cuh", "composite_tile"),),
    "APPLY_OPS": (("common.cuh", "composite_tile"),),
    "BWD_APPLY_OPS": (("composite_backward.cu", "composite_backward_kernel"),
                      ("fused_backward.cu", "fused_backward_kernel")),
    "BWD_UNCLAMPED_OPS": (("composite_backward.cu", "composite_backward_kernel"),
                          ("fused_backward.cu", "fused_backward_kernel")),
    "PROJ_OPS": (("common.cuh", "project_iso"),),
    "CHAIN_OPS": (("fused_backward.cu", "chain_to_world"),),
}


class WalkCounts(NamedTuple):
    """Sums over the pixels inside the image of one forward walk."""

    evals: int  # pair evaluations up to each pixel's stop
    alpha: int  # of those, power <= 0
    hits: int  # of those, alpha >= 1/255 (the terminating pair included)
    applied: int  # pairs composited
    unclamped: int  # of those, opacity * G <= 0.99
    reach: int  # sum over tiles of the deepest stop (pairs a tile must stage)
    bwd_evals: int  # sum of n_contrib (the backward walks' evaluations)
    bwd_alpha: int  # of those, power <= 0
    bwd_reach: int  # sum over tiles of the deepest n_contrib


def walk_counts(xy, conic, opacity, tile_start, width: int, height: int) -> WalkCounts:
    """Counts of composite_pairs_plain's walk over per-pair xy [P, 2],
    conic [P, 3], opacity [P] (same decisions, same order)."""
    n_tiles = tile_start.shape[0] - 1
    device = xy.device
    ox, oy, lx, ly = _tile_frame(tile_start, width)
    inside = ((ox + lx) < width) & ((oy + ly) < height)
    starts = tile_start[:-1].long()
    lens = (tile_start[1:] - tile_start[:-1]).long()
    kmax = int(lens.max()) if n_tiles else 0
    shape = (n_tiles, inside.shape[1])
    zeros = lambda: torch.zeros(shape, dtype=torch.int64, device=device)  # noqa: E731
    t_cur = torch.ones(shape, dtype=torch.float32, device=device)
    done = ~inside
    stop, n_alpha, ncon, alpha_at_nc = zeros(), zeros(), zeros(), zeros()
    hits = applied = unclamped = torch.zeros((), dtype=torch.int64, device=device)
    p_last = max(xy.shape[0] - 1, 0)
    for k in range(kmax):
        idx = torch.clamp(starts + k, max=p_last)
        _, _, power, _, alpha_un, alpha, _ = _pair_alpha(xy, conic, opacity, idx, ox, oy, lx, ly)
        ev = (k < lens)[:, None] & ~done
        a_ok = ev & (power <= 0.0)
        hit = a_ok & (alpha >= ALPHA_MIN)
        test_t = t_cur * (1.0 - alpha)
        term = hit & (test_t < T_EPS)
        apply = hit & ~term
        stop += ev
        n_alpha += a_ok
        hits = hits + hit.sum()
        applied = applied + apply.sum()
        unclamped = unclamped + (apply & (alpha_un <= ALPHA_MAX)).sum()
        alpha_at_nc = torch.where(apply, n_alpha, alpha_at_nc)
        ncon = torch.where(apply, k + 1, ncon)
        t_cur = torch.where(apply, test_t, t_cur)
        done = done | term
    return WalkCounts(
        evals=int(stop.sum()), alpha=int(n_alpha.sum()), hits=int(hits),
        applied=int(applied), unclamped=int(unclamped),
        reach=int(stop.amax(1).sum()) if n_tiles else 0,
        bwd_evals=int(ncon.sum()), bwd_alpha=int(alpha_at_nc.sum()),
        bwd_reach=int(ncon.amax(1).sum()) if n_tiles else 0)


def forward_walk_ops(wc: WalkCounts) -> int:
    return (EVAL_OPS * wc.evals + ALPHA_OPS * wc.alpha + HIT_OPS * wc.hits
            + APPLY_OPS * wc.applied)


def backward_walk_ops(wc: WalkCounts) -> int:
    return (EVAL_OPS * wc.bwd_evals + ALPHA_OPS * wc.bwd_alpha + BWD_APPLY_OPS * wc.applied
            + BWD_UNCLAMPED_OPS * wc.unclamped)


def roofline(n_bytes: int, ops: int) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations": which of the two sets it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def image_rows_bytes(img: torch.Tensor, rows: int) -> int:
    """Bytes of `rows` rows of an image [C, H, W] (a backward reads only the
    silhouette and n_contrib rows of the forward's state)."""
    return rows * img[0].numel() * img.element_size()
