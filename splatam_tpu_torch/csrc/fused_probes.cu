// Probe kernels of the fused forward (K4, fused_forward.cu): each splits K4's
// time one way, as the TPU probes split fused_forward_pallas's.
//
// fused_forward2 replaces fwd2 (scripts/probe_unroll.py:118-253): K4's
// function with two batches per loop step. The TPU probe issues two chunks'
// carry-free prefixes back to back so that one chunk's projection hides under
// the other's latency. Here each thread issues the loads of both of its
// pairs' 32-byte world rows before it projects either one, stages both into a
// 2 x 256-pair shared buffer (24 KB, and 16 words per warp), and the block
// walks 512 pairs between barriers: half K4's barriers and
// __syncthreads_count early-exit checks. It is K4's walk (composite_walk,
// common.cuh) at two batches a step: the per-pixel pair order and arithmetic
// are K4's (same expressions, -fmad=false), so the result equals K4's bit for
// bit.
//
// dma_walk<B> replaces dma_only (B = 1, probe_dma.py:117-160) and make_dma_bn
// (B = 2, 4, probe_dma.py:173-224): K4's walk over the world rows and no
// compositing. One block of C = 128 threads per tile; per step every thread
// copies B of the tile's rows into shared memory with cp.async (two 16-byte
// pieces each, so the copies of rows 1-7 cannot be dropped as unused), double
// buffered like the TPU's two DMA slots, and adds column 0 of its first row.
// Rows past the tile's end are not copied: the port's buffers have no padding,
// so no copy reads past the tile or the buffer, and those lanes count as zero.
//
// fused_math_only replaces math_only (probe_dma.py:230-305): K4's per-pair
// math with no walk over memory. The block stages and projects the tile's
// first min(num, C) pairs once, with their warp masks, then every warp walks
// its list of them ceil(num / C) times as list positions i * C + j (j < C,
// i * C + j < num) under K4's rules and early exit: K4 run on rows remapped so
// that pair k takes the row of pair start + (k mod C). Warps stop on their
// own; no barrier after the staging.
//
// What bounds them on an H100: fwd2 and math_only, like K4, the pair-pixel
// evaluations of the sequential compositing walk (PERF.md); dma_walk the
// bytes it streams: its copies run near the memory rate, so staging more
// rows per step (B = 2, 4) buys nothing, unlike the TPU's per-chunk DMA issue.
#include "common.cuh"

namespace splatam {

constexpr int C = 128;  // the TPU kernels' chunk width

__global__ void __launch_bounds__(PIX)
    fused_forward2_kernel(const float* __restrict__ world8, const float* __restrict__ pose,
                          const int* __restrict__ tile_start, int grid_x, int width, int height,
                          float* __restrict__ out) {
  __shared__ WalkShared<2, ProjectedRows::NCH> sh;
  __shared__ Pose s_pose;
  if (threadIdx.x == 0) s_pose = load_pose(pose);
  __syncthreads();
  const ProjectedRows rows = {world8, nullptr, s_pose, float(width), float(height)};
  composite_walk<2>(sh, rows, tile_start[blockIdx.x], tile_start[blockIdx.x + 1], grid_x, width,
                    height, out);
}

__global__ void __launch_bounds__(PIX)
    fused_math_only_kernel(const float* __restrict__ world8, const float* __restrict__ pose,
                           const int* __restrict__ tile_start, int grid_x, int width, int height,
                           float* __restrict__ out) {
  __shared__ WalkShared<1, ProjectedRows::NCH> sh;  // the first C slots and words are used
  __shared__ Pose s_pose;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int start = tile_start[blockIdx.x], num = tile_start[blockIdx.x + 1] - start;
  if (tid == 0) s_pose = load_pose(pose);
  __syncthreads();
  const ProjectedRows rows = {world8, nullptr, s_pose, float(width), float(height)};
  WalkPixel<ProjectedRows::NCH> p(grid_x, width, height);
  unsigned mask = 0;
  if (tid < min(num, C)) mask = rows.stage(sh.pairs[tid], rows.load(start + tid), p.ox, p.oy);
  publish_masks(sh.words, mask, warp);
  __syncthreads();
  for (int base = 0; base < num && !__all_sync(FULL, p.done); base += C)
    walk_words<true>(sh.pairs, sh.words[warp], min(C, num - base), base + 1, p);
  p.write(width, height, out);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {  // all groups but the newest landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int B>
__global__ void __launch_bounds__(C)
    dma_walk_kernel(const float* __restrict__ world8, const int* __restrict__ tile_start,
                    float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][B * C][8];
  const int l = threadIdx.x;
  const int start = tile_start[blockIdx.x], num = tile_start[blockIdx.x + 1] - start;
  const int steps = (num + B * C - 1) / (B * C);
  // Copies step s's rows into slot s & 1, one commit group per step.
  auto stage = [&](int s) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int k = s * B * C + b * C + l;
      if (k < num) {
        const float* row = world8 + size_t(start + k) * 8;
        cp_async16(&buf[s & 1][b * C + l][0], row);
        cp_async16(&buf[s & 1][b * C + l][4], row + 4);
      }
    }
    cp_async_commit();
  };
  float acc = 0.0f;
  if (steps > 0) stage(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1);
    } else {
      cp_async_commit();  // an empty group, so the wait below still covers step s
    }
    cp_async_wait_prior();  // a thread adds only the row it copied itself
    if (s * B * C + l < num) acc += buf[s & 1][l][0];
    __syncthreads();  // slot s & 1 is read before step s + 2 is copied into it
  }
  out[size_t(blockIdx.x) * C + l] = acc;
}

template <int B>
int launch_dma_walk(const float* world8, const int* tile_start, int tiles, float* out,
                    void* stream) {
  if (tiles > 0) {
    dma_walk_kernel<B><<<tiles, C, 0, (cudaStream_t)stream>>>(world8, tile_start, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace splatam

extern "C" int fused_forward2(const float* world8, const float* pose, const int* tile_start,
                              int grid_x, int grid_y, int width, int height, float* out,
                              void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::fused_forward2_kernel<<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        world8, pose, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int fused_math_only(const float* world8, const float* pose, const int* tile_start,
                               int grid_x, int grid_y, int width, int height, float* out,
                               void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::fused_math_only_kernel<<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        world8, pose, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int dma_walk1(const float* world8, const int* tile_start, int tiles, float* out,
                         void* stream) {
  return splatam::launch_dma_walk<1>(world8, tile_start, tiles, out, stream);
}

extern "C" int dma_walk2(const float* world8, const int* tile_start, int tiles, float* out,
                         void* stream) {
  return splatam::launch_dma_walk<2>(world8, tile_start, tiles, out, stream);
}

extern "C" int dma_walk4(const float* world8, const int* tile_start, int tiles, float* out,
                         void* stream) {
  return splatam::launch_dma_walk<4>(world8, tile_start, tiles, out, stream);
}
