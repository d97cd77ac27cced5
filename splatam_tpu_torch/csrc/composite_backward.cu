// K2: composite backward.
//
// Replaces composite_backward_pallas / _bwd_kernel
// (splatam_tpu/render/pallas/composite_pallas.py:313-550). Each pixel walks its
// tile's depth-sorted pairs back to front from its own n_contrib, keeping
// renderCUDA's suffix accumulators, and every pair gets its screen-space
// gradient: d x, d y, d conic a/b/c, d opacity, d channels ([P, 6 + NCH], in
// sorted-pair order). The silhouette is a constant-1 channel whose cotangent
// joins the per-pixel sum (the TPU kernel's lane-constant addend, :331-334).
// Pairs past the deepest n_contrib of their tile get zeros, so every slot is
// written (the TPU kernel's zero fill, :495-514).
//
// Inputs as K1 takes them: per-Gaussian attribute rows gathered through
// pair_gauss (the generic render), or, with a null pair_gauss, one row per
// sorted pair (the pair-space tracking render).
//
// What bounds it on an H100: per-pixel latency of the reverse walk and the
// per-pair reduction over the tile's 256 pixels. The TPU kernel turns the walk
// into log-space triangular matmuls and a pixel-moment contraction on the MXU;
// here the walk stays sequential per pixel, as in K5 (fused_backward.cu),
// which adds the in-kernel projection and reduces each pair's terms with a
// reduce-scatter instead of this kernel's butterfly per column. Design: one
// block per tile, one thread per pixel, pairs staged 32 at a time in shared
// memory (one row per thread). Each pair slot belongs to exactly one tile,
// so its gradient is a reduction inside the block: the pixel terms are summed
// with warp shuffles (skipped when no lane of the warp touched the pair), the
// eight warp partials in shared memory, and one thread per pair makes one
// plain store per column. No global atomics; the result is deterministic.
#include "common.cuh"

namespace splatam {

constexpr int BB = 32;  // pairs per staged batch
constexpr int WARPS = PIX / 32;

template <int NCH>
__global__ void __launch_bounds__(PIX)
    composite_backward_kernel(const float* __restrict__ attrs, const int* __restrict__ pair_gauss,
                              const int* __restrict__ tile_start, int grid_x, int width,
                              int height, const float* __restrict__ state,
                              const float* __restrict__ g, float* __restrict__ dpair) {
  constexpr int NA = 6 + NCH;  // attribute columns = gradient columns
  __shared__ float s_attr[NA][BB];
  __shared__ float s_red[WARPS][BB][NA];
  __shared__ int s_reach;

  const int tile = blockIdx.x, tid = threadIdx.x;
  const int lx = tid % TILE, ly = tid / TILE;
  const int tx = tile % grid_x, ty = tile / grid_x;
  const int pxi = tx * TILE + lx, pyi = ty * TILE + ly;
  const bool inside = pxi < width && pyi < height;
  const float ox = float(tx * TILE), oy = float(ty * TILE);
  const float fx = float(lx), fy = float(ly);
  const int start = tile_start[tile], end = tile_start[tile + 1];
  const int warp = tid >> 5, lane = tid & 31;

  // T_final = 1 - silhouette: the very float the plain version reconstructs.
  float T = 1.0f;
  int nc = 0;
  float gch[NCH + 1];  // channel cotangents, then the silhouette's
#pragma unroll
  for (int c = 0; c <= NCH; ++c) gch[c] = 0.0f;
  if (inside) {
    const size_t hw = size_t(width) * height, pix = size_t(pyi) * width + pxi;
    T = 1.0f - state[NCH * hw + pix];
    nc = int(state[(NCH + 1) * hw + pix]);
#pragma unroll
    for (int c = 0; c <= NCH; ++c) gch[c] = g[c * hw + pix];
  }
  if (tid == 0) s_reach = 0;
  __syncthreads();
  atomicMax(&s_reach, nc);
  __syncthreads();
  const int reach = start + s_reach;

  for (size_t i = size_t(reach) * NA + tid; i < size_t(end) * NA; i += PIX) dpair[i] = 0.0f;

  float accum[NCH + 1], last_c[NCH + 1];
#pragma unroll
  for (int c = 0; c <= NCH; ++c) accum[c] = last_c[c] = 0.0f;
  float last_alpha = 0.0f;

  for (int bend = reach; bend > start; bend -= BB) {
    const int bstart = max(start, bend - BB);
    const int n = bend - bstart;
    if (tid < n) {
      const int i = bstart + tid;
      const size_t row = pair_gauss != nullptr ? size_t(pair_gauss[i]) : size_t(i);
      const float* a = attrs + row * NA;
#pragma unroll
      for (int r = 0; r < NA; ++r) s_attr[r][tid] = a[r];
    }
    __syncthreads();

    for (int jj = n - 1; jj >= 0; --jj) {
      float r[NA];
#pragma unroll
      for (int c = 0; c < NA; ++c) r[c] = 0.0f;
      bool contrib = false;
      if (bstart + jj - start < nc) {
        const float dx = (s_attr[0][jj] - ox) - fx;
        const float dy = (s_attr[1][jj] - oy) - fy;
        const float ca = s_attr[2][jj], cb = s_attr[3][jj], cc = s_attr[4][jj];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power <= 0.0f) {
          const float op = s_attr[5][jj];
          const float G = expf(power);
          const float alpha_un = op * G;
          const float alpha = fminf(ALPHA_MAX, alpha_un);
          if (alpha >= ALPHA_MIN) {
            contrib = true;
            T = T / (1.0f - alpha);
            const float wgt = alpha * T;
            float dalpha = 0.0f;
#pragma unroll
            for (int c = 0; c <= NCH; ++c) {
              const float val = c < NCH ? s_attr[6 + c][jj] : 1.0f;
              accum[c] = last_alpha * last_c[c] + (1.0f - last_alpha) * accum[c];
              last_c[c] = val;
              dalpha += (val - accum[c]) * gch[c];
              if (c < NCH) r[6 + c] = wgt * gch[c];
            }
            dalpha *= T;
            last_alpha = alpha;
            if (alpha_un <= ALPHA_MAX) {
              const float dpower = op * dalpha * G;
              r[0] = dpower * -(ca * dx + cb * dy);
              r[1] = dpower * -(cc * dy + cb * dx);
              r[2] = dpower * (-0.5f * dx * dx);
              r[3] = dpower * (-dx * dy);
              r[4] = dpower * (-0.5f * dy * dy);
              r[5] = dalpha * G;
            }
          }
        }
      }
      if (__any_sync(FULL, contrib)) {
#pragma unroll
        for (int c = 0; c < NA; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) r[c] += __shfl_down_sync(FULL, r[c], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < NA; ++c) s_red[warp][jj][c] = r[c];
      }
    }
    __syncthreads();

    if (tid < n) {
      float* out = dpair + size_t(bstart + tid) * NA;
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) v += s_red[w][tid][c];
        out[c] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace splatam

extern "C" int composite_backward_ch5(const float* attrs, const int* pair_gauss,
                                      const int* tile_start, int grid_x, int grid_y, int width,
                                      int height, const float* state, const float* g,
                                      float* dpair, void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::composite_backward_kernel<5><<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_gauss, tile_start, grid_x, width, height, state, g, dpair);
  }
  return (int)cudaGetLastError();
}
