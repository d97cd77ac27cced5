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
backward walks evaluate each pixel's pairs below its n_contrib and apply
exactly the pairs the forward applied there.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from splatam_tpu_torch.render.composite import (
    ALPHA_MAX,
    ALPHA_MIN,
    CH,
    T_EPS,
    WARPS,
    _pair_alpha,
    _tile_frame,
    cull_rows_plain,
    cull_warp_mask,
    warp_pixels,
)

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Per pair-pixel evaluation of the forward walk (composite_pair, common.cuh,
# run once per pixel for every pair walk_words visits, on a pair that
# stage_values staged relative to the tile's origin):
EVAL_OPS = 13  # dx, dy, power, the power > 0 test
ALPHA_OPS = 4  # expf, opacity * G, the 0.99 clamp, the 1/255 test (power <= 0)
HIT_OPS = 3  # T * (1 - alpha), the T < 1e-4 test (alpha >= 1/255)
APPLY_OPS = 2  # the weight, n_contrib (applied) ...
CHAN_APPLY_OPS = 2  # ... and per channel mul + add
# Per pair-pixel evaluation of the backward walks (the reverse loop of
# composite_backward_kernel and fused_backward_kernel), on top of EVAL_OPS
# and ALPHA_OPS, at ch channels (5 in K5):
BWD_APPLY_OPS = 17  # T / (1 - alpha), the weight, dalpha * T, the silhouette's suffix
#                     channel (7), and the 6 adds that sum the geometry columns over
#                     the pair's pixels ...
BWD_CHAN_OPS = 9  # ... and per channel its suffix update (7), its gradient and the add
#                   that sums it over the pixels
BWD_UNCLAMPED_OPS = 22  # dpower and the conic / xy / opacity terms (alpha not clamped)
# Per staged pair:
PROJ_OPS = 79  # project_iso and the tz^2 of ProjectedRows::stage (common.cuh)
CHAIN_OPS = 138  # chain_to_world (fused_backward.cu)
# The device functions (csrc/ file, name) each count was made from; the
# tests pin those functions' text, so an edit to one asks for a recount.
OP_SOURCES = {
    "EVAL_OPS": (("common.cuh", "composite_pair"), ("common.cuh", "walk_words"),
                 ("common.cuh", "stage_values"), ("common.cuh", "stage_pair")),
    "ALPHA_OPS": (("common.cuh", "composite_pair"),),
    "HIT_OPS": (("common.cuh", "composite_pair"),),
    "APPLY_OPS": (("common.cuh", "composite_pair"),),
    "CHAN_APPLY_OPS": (("common.cuh", "composite_pair"),),
    "BWD_APPLY_OPS": (("composite_backward.cu", "composite_backward_kernel"),
                      ("fused_backward.cu", "fused_backward_kernel")),
    "BWD_CHAN_OPS": (("composite_backward.cu", "composite_backward_kernel"),
                     ("fused_backward.cu", "fused_backward_kernel")),
    "BWD_UNCLAMPED_OPS": (("composite_backward.cu", "composite_backward_kernel"),
                          ("fused_backward.cu", "fused_backward_kernel")),
    "PROJ_OPS": (("common.cuh", "project_iso"), ("common.cuh", "ProjectedRows")),
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
    # (pair, warp) steps of the backward walks in which at least one lane of a
    # 32-pixel warp (warp_w pixels across) applies the pair: the steps whose
    # per-pair terms a warp reduces with shuffles
    bwd_warp_steps: int
    # (pair, warp) steps of the forward walk in which a lane that has not
    # stopped finds power <= 0 and alpha >= 1/255: the steps a warp needs
    fwd_warp_steps: int
    # (pair, warp) steps the kernels' cull (composite.cull_rows_plain) keeps:
    # forward, while a lane of the warp has not stopped; backward, below the
    # deepest n_contrib of the warp's pixels
    fwd_kept_steps: int
    bwd_kept_steps: int
    # (pair, warp) steps with no cull: the same limits, every staged pair
    fwd_visited_steps: int
    bwd_visited_steps: int


def walk_counts(xy, conic, opacity, tile_start, width: int, height: int,
                warp_w: int = 16) -> WalkCounts:
    """Counts of composite_pairs_plain's walk over per-pair xy [P, 2],
    conic [P, 3], opacity [P] (same decisions, same order). The warp steps
    group a tile's pixels into warps warp_w across (composite.warp_pixels)."""
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
    steps = torch.zeros(3, dtype=torch.int64, device=device)  # applying, hitting, live warps
    fwd_kept = hits
    lanes = warp_pixels(warp_w, device)  # [8, 32] pixels of each warp
    # [P, 8]: the warps of its tile that must visit each pair under the cull
    keep = cull_warp_mask(cull_rows_plain(xy, conic, opacity, tile_start, width), warp_w)
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
        by_warp = torch.stack([apply, hit, ev])[:, :, lanes].any(3)  # [3, T, 8]
        steps = steps + by_warp.sum((1, 2))
        fwd_kept = fwd_kept + (by_warp[2] & keep[idx]).sum()
        unclamped = unclamped + (apply & (alpha_un <= ALPHA_MAX)).sum()
        alpha_at_nc = torch.where(apply, n_alpha, alpha_at_nc)
        ncon = torch.where(apply, k + 1, ncon)
        t_cur = torch.where(apply, test_t, t_cur)
        done = done | term
    # The backward walks: warp w of a tile visits the pairs below the deepest
    # n_contrib of its pixels.
    warp_nc = ncon[:, lanes].amax(2) if n_tiles else ncon.reshape(0, WARPS)
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=device), lens,
                                      output_size=xy.shape[0])
    depth = torch.arange(xy.shape[0], device=device) - starts[tile_of]  # a pair's place in its tile
    bwd_kept = (keep & (depth[:, None] < warp_nc[tile_of])).sum()
    bwd_steps, fwd_steps, fwd_visited = steps.tolist()
    return WalkCounts(
        evals=int(stop.sum()), alpha=int(n_alpha.sum()), hits=int(hits),
        applied=int(applied), unclamped=int(unclamped),
        reach=int(stop.amax(1).sum()) if n_tiles else 0,
        bwd_evals=int(ncon.sum()), bwd_alpha=int(alpha_at_nc.sum()),
        bwd_reach=int(ncon.amax(1).sum()) if n_tiles else 0,
        bwd_warp_steps=bwd_steps, fwd_warp_steps=fwd_steps,
        fwd_kept_steps=int(fwd_kept), bwd_kept_steps=int(bwd_kept),
        fwd_visited_steps=fwd_visited, bwd_visited_steps=int(warp_nc.sum()))


def forward_walk_ops(wc: WalkCounts, ch: int = CH) -> int:
    """Float32 operations of a forward walk of ch channels."""
    return (EVAL_OPS * wc.evals + ALPHA_OPS * wc.alpha + HIT_OPS * wc.hits
            + (APPLY_OPS + CHAN_APPLY_OPS * ch) * wc.applied)


def backward_walk_ops(wc: WalkCounts, ch: int = CH) -> int:
    """Float32 operations of a backward walk of ch channels."""
    return (EVAL_OPS * wc.bwd_evals + ALPHA_OPS * wc.bwd_alpha
            + (BWD_APPLY_OPS + BWD_CHAN_OPS * ch) * wc.applied
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
