"""Probe kernels of the fused forward (K4): each splits K4's time one way.

Counterparts of the Pallas probes in scripts/probe_unroll.py (fwd2) and
scripts/probe_dma.py (dma_only, dma_bN, math_only), on the port's layout:
per-pair world rows [P, 8] sorted by tile, exact CSR `tile_start` [T + 1],
no padding. Kernels in csrc/fused_probes.cu; each wrapper launches its
kernel for CUDA tensors and takes the plain version for CPU tensors.

  fwd2       K4's function, two 256-pair batches staged per loop step:
             [7, H, W] equal to K4 bit for bit.
  dma_walk   K4's walk over the world rows with no compositing: lane l of
             tile t sums column 0 of the tile's pairs l, l + C, l + 2C, ...
             (b = 1, `dma_only`), or, staging b * C rows per step, only the
             first C of each b * C block (b = 2, 4: `dma_b2`, `dma_b4`).
             [T, C] with C = 128, the TPU's chunk width.
  math_only  K4's per-pair math on the tile's first min(num, C) pairs only,
             composited ceil(num / C) times as list positions i * C + j:
             K4 on rows remapped so that pair k of tile t takes the row of
             pair start_t + (k mod C).
"""
from __future__ import annotations

import torch

from splatam_tpu_torch.render import _cuda
from splatam_tpu_torch.render.composite import CH, PIX
from splatam_tpu_torch.render.fused_iso import _check_common, fused_forward_plain

C = 128  # the TPU kernels' chunk width (lanes), kept as the probes' unit
STEP2 = 2 * PIX  # pairs staged per fwd2 loop step
DMA_BLOCKS = (1, 2, 4)  # chunks staged per step: dma_only, dma_b2, dma_b4


def pair_positions(tile_start: torch.Tensor, n_pairs: int):
    """(tile of each sorted pair [P], its 0-based position in that tile [P])."""
    lens = (tile_start[1:] - tile_start[:-1]).long()
    n_tiles = lens.shape[0]
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=tile_start.device), lens,
                                   output_size=n_pairs)
    pos = torch.arange(n_pairs, device=tile_start.device) - tile_start[:-1].long()[tile]
    return tile, pos


# ---------------------------------------------------------------------------
# fwd2
# ---------------------------------------------------------------------------


def fwd2_plain(world8, pose_vec, tile_start, width: int, height: int):
    """fwd2 computes K4's function: fused_iso.fused_forward_plain."""
    return fused_forward_plain(world8, pose_vec, tile_start, width, height)


def _launch_forward(name, world8, pose_vec, tile_start, width, height):
    gx, gy = _check_common(world8, pose_vec, tile_start, width, height)
    out = torch.empty((CH + 2, height, width), dtype=torch.float32, device=world8.device)
    err = getattr(_cuda.lib(), name)(
        world8.data_ptr(), pose_vec.data_ptr(), tile_start.data_ptr(), gx, gy,
        width, height, out.data_ptr(), _cuda.stream_ptr(world8))
    _cuda.check(err, name)
    return out


def fwd2(world8, pose_vec, tile_start, width: int, height: int):
    """fwd2 wrapper: K4's [7, H, W] from the same inputs, two batches per
    loop step. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if not world8.is_cuda:
        return fwd2_plain(world8, pose_vec, tile_start, width, height)
    out = _launch_forward("fused_forward2", world8, pose_vec, tile_start, width, height)
    fwd2.launches += 1
    return out


fwd2.launches = 0


# ---------------------------------------------------------------------------
# dma_only, dma_b2, dma_b4
# ---------------------------------------------------------------------------


def dma_walk_plain(world8, tile_start, b: int):
    """out[t, l] = sum over j of world8[start_t + j * b * C + l, 0] for
    j * b * C + l < num_t: [T, C]."""
    n_tiles = tile_start.shape[0] - 1
    out = torch.zeros((n_tiles, C), dtype=torch.float32, device=world8.device)
    tile, pos = pair_positions(tile_start, world8.shape[0])
    lane = pos % (b * C)
    keep = lane < C
    return out.view(-1).index_add_(0, (tile * C + lane)[keep], world8[keep, 0]).view(n_tiles, C)


def dma_walk(world8, tile_start, b: int):
    """dma_only (b = 1), dma_b2, dma_b4 wrapper: [T, C] lane sums of
    column 0 (see dma_walk_plain). `launches` counts each b's launches."""
    if not world8.is_cuda:
        return dma_walk_plain(world8, tile_start, b)
    if b not in DMA_BLOCKS:
        raise ValueError(f"b: expected one of {DMA_BLOCKS}, got {b}")
    _cuda.require(world8, "world8", torch.float32, (None, 8))
    _cuda.require(tile_start, "tile_start", torch.int32, (None,))
    if world8.data_ptr() % 16:
        raise ValueError("world8: the kernel copies rows as 16-byte pieces, needs alignment")
    n_tiles = tile_start.shape[0] - 1
    out = torch.empty((n_tiles, C), dtype=torch.float32, device=world8.device)
    name = f"dma_walk{b}"
    err = getattr(_cuda.lib(), name)(world8.data_ptr(), tile_start.data_ptr(), n_tiles,
                                     out.data_ptr(), _cuda.stream_ptr(world8))
    _cuda.check(err, name)
    dma_walk.launches[b] += 1
    return out


dma_walk.launches = dict.fromkeys(DMA_BLOCKS, 0)


# ---------------------------------------------------------------------------
# math_only
# ---------------------------------------------------------------------------


def first_chunk_rows(tile_start: torch.Tensor, n_pairs: int) -> torch.Tensor:
    """[P] row index start_t + (k mod C) for pair k of tile t: the rows
    math_only composites at each list position."""
    tile, pos = pair_positions(tile_start, n_pairs)
    return tile_start[:-1].long()[tile] + pos % C


def math_only_plain(world8, pose_vec, tile_start, width: int, height: int):
    """K4 on the remapped rows world8[first_chunk_rows]: [7, H, W]."""
    rows = world8[first_chunk_rows(tile_start, world8.shape[0])]
    return fused_forward_plain(rows, pose_vec, tile_start, width, height)


def math_only(world8, pose_vec, tile_start, width: int, height: int):
    """math_only wrapper: [7, H, W] (see math_only_plain). CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    if not world8.is_cuda:
        return math_only_plain(world8, pose_vec, tile_start, width, height)
    out = _launch_forward("fused_math_only", world8, pose_vec, tile_start, width, height)
    math_only.launches += 1
    return out


math_only.launches = 0
