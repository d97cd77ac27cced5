// K1: composite forward.
//
// Replaces composite_forward_pallas / _fwd_kernel
// (splatam_tpu/render/pallas/composite_pallas.py:184-310): per 16x16 tile,
// front-to-back alpha compositing of the tile's depth-sorted pairs under
// renderCUDA's rules, writing the channels, the silhouette 1 - T_final and
// n_contrib.
//
// What bounds it on an H100: per-pixel latency of the sequential walk (each
// pixel applies its pairs one after another) and reading pair attributes.
// Design: one block per tile, one thread per pixel (renderCUDA's shape). A
// batch of 256 pairs is gathered by Gaussian index into shared memory once
// per block (one pair per thread), so each attribute is read from device
// memory once per tile rather than once per pixel, and the walk reads it from
// shared memory as a broadcast. A block stops as soon as every pixel has
// terminated. The output goes straight into the [C, H, W] image; no
// tile-major intermediate and no assemble pass.
//
// Two input modes: per-Gaussian rows gathered through pair_gauss (the generic
// render), or, with a null pair_gauss, one row per sorted pair (the pair-space
// tracking render, whose rows are projected per pair), read in place.
#include "common.cuh"

namespace splatam {

template <int NCH>
__global__ void __launch_bounds__(PIX)
    composite_forward_kernel(const float* __restrict__ attrs, const int* __restrict__ pair_gauss,
                             const int* __restrict__ tile_start, int grid_x, int width,
                             int height, float* __restrict__ out) {
  __shared__ SharedPairs<NCH> sh;
  const int start = tile_start[blockIdx.x], end = tile_start[blockIdx.x + 1];
  auto stage = [&](int i, int slot) {
    const size_t row = pair_gauss != nullptr ? size_t(pair_gauss[i]) : size_t(i);
    const float* a = attrs + row * (6 + NCH);
#pragma unroll
    for (int r = 0; r < 6 + NCH; ++r) sh.v[r][slot] = a[r];
  };
  composite_tile<NCH>(sh, stage, start, end, grid_x, width, height, out);
}

}  // namespace splatam

extern "C" int composite_forward_ch5(const float* attrs, const int* pair_gauss,
                                     const int* tile_start, int grid_x, int grid_y, int width,
                                     int height, float* out, void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::composite_forward_kernel<5><<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_gauss, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* last_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
