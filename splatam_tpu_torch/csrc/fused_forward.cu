// K4: fused isotropic forward.
//
// Replaces fused_forward_pallas / _fused_fwd_kernel
// (splatam_tpu/render/pallas/fused_iso.py:195-336): isotropic EWA projection
// of each pair inside the kernel, then compositing as K1. Writes r, g, b, z,
// z^2, the silhouette and n_contrib ([7, H, W]); the backward reads the last
// two as its saved state.
//
// What bounds it on an H100: operations, as K1: the pair-pixel evaluations of
// the sequential walk, each a dependent chain; reading the world rows is a few
// percent of the time (the dma probes of fused_probes.cu). Design: K1's (one
// block per tile, one thread per pixel, a warp four rows of eight pixels,
// batches of 256 pairs, the warp-granular cull and the per-warp lists of
// composite_walk, common.cuh), behind a staging step that projects: each
// thread reads one pair's 32-byte world row as two float4 loads, in place or
// through pair_gauss, projects it (project_iso) and stages the projected pair
// (ProjectedRows, common.cuh), so a pair is projected once per tile instead of
// once per pixel, and the cull's box comes from the projected centre, conic
// and opacity. The skip mask leaves out in_front and det_ok on purpose
// (fused_iso.py:168-178): a Gaussian pushed behind the near plane within a
// structure-reuse window composites at safe_tz = 1; the depth channels are the
// raw tz and tz^2. The pose lives in shared memory: it is read 256 times per
// batch, and 22 registers a thread would cost the walk resident blocks.
//
// Two input modes: per-Gaussian world rows [N, 8] gathered through pair_gauss
// (mapping, whose rows change every iteration), or, with a null pair_gauss,
// one row per sorted pair (tracking, whose rows are gathered once per rebin).
#include "common.cuh"

namespace splatam {

// Resident blocks per SM asked of the compiler (a cap of 65536 / 256 /
// MIN_BLOCKS registers a thread). Measured on an H100 (PERF.md): up to 5 the
// kernel takes 48 registers with no spill and 5 blocks are resident; 6 cap it
// at 40 with an 8-byte spill (the same time on a map whose walks stop early,
// 5% slower where they run to the tile's end), 8 at 32 (3-20% slower).
constexpr int MIN_BLOCKS = 5;

__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
    fused_forward_kernel(const float* __restrict__ world8, const int* __restrict__ pair_gauss,
                         const float* __restrict__ pose, const int* __restrict__ tile_start,
                         int grid_x, int width, int height, float* __restrict__ out) {
  __shared__ WalkShared<1, ProjectedRows::NCH> sh;
  __shared__ Pose s_pose;
  if (threadIdx.x == 0) s_pose = load_pose(pose);
  __syncthreads();
  const ProjectedRows rows = {world8, pair_gauss, s_pose, float(width), float(height)};
  composite_walk<1>(sh, rows, tile_start[blockIdx.x], tile_start[blockIdx.x + 1], grid_x, width,
                    height, out);
}

}  // namespace splatam

extern "C" int fused_forward(const float* world8, const int* pair_gauss, const float* pose,
                             const int* tile_start, int grid_x, int grid_y, int width, int height,
                             float* out, void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::fused_forward_kernel<<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        world8, pair_gauss, pose, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}

// What the compiler gave K4: registers and local (spill) bytes per thread,
// and resident blocks per SM.
extern "C" int fused_forward_info(int* regs, int* local_bytes, int* blocks_per_sm) {
  return splatam::kernel_info((const void*)splatam::fused_forward_kernel, splatam::PIX, regs,
                              local_bytes, blocks_per_sm);
}
