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
// What bounds it on an H100: operations, not bytes: the per-pixel reverse walk
// (each evaluation a dependent chain of expf, a division and six suffix
// updates), run by every warp for every staged pair though a pair reaches
// few rows of its tile, and the per-pair reduction of 11 terms over the tile's
// 256 pixels (an SM retires one warp shuffle per clock). The TPU kernel turns
// the walk into log-space triangular matmuls and a pixel-moment contraction on
// the MXU; here the walk stays sequential per pixel. Design (one block per
// tile, one thread per pixel, a warp four rows of eight pixels (WarpShape,
// common.cuh), 64 pairs staged per batch, back to front):
//   - the staging thread computes the warps its pair can reach (pair_reach,
//     common.cuh, K1's cull) and two ballots per warp of the tile turn the
//     masks into one 64-bit word per warp: the batch's pairs it must visit,
//     cut at the deepest n_contrib of its own 32 pixels;
//   - each warp steps through the set bits of its word from the back (__clzll),
//     so a pair it cannot reach costs it nothing;
//   - reduce-scatter (reduce_scatter16, common.cuh, shared with K5): the 11
//     terms, padded to 16 slots, are summed over the warp in 16 shuffles, in a
//     step where some lane applied the pair; the even lanes of the first 11
//     slots publish the totals, and the warp keeps a bitmask of the pairs it
//     touched;
//   - the whole block merges the partials of the touching warps in warp order,
//     one (pair, column) per thread; the merged value is the output, and the
//     batch's rows are contiguous in dpair, so the merge stores them directly,
//     coalesced. Two barriers per batch.
// No global atomics. Every sum is taken in a fixed tree (the lanes' halving
// order, then the warps in order; a warp that did not touch a pair adds
// nothing), so two launches are equal bit for bit.
//
// The channel count NCH is a template parameter, 1 to 10 as the TPU kernel
// takes (6 + ch columns of its 16-row attribute block): the 6 + NCH gradient
// columns fit the reduce-scatter's 16 slots, padded with zeros. The launch
// bounds ask each instance for the resident blocks per SM (K2_MIN_BLOCKS) that
// ran fastest on an NVIDIA H100 80GB HBM3 at 700 W: at five channels four,
// which caps the kernel at 64 registers and spills 32 bytes a thread, and
// still runs faster than three blocks with no spill (PERF.md).
#include "common.cuh"

namespace splatam {

constexpr int BB = 64;  // pairs per staged batch: a warp's list is one 64-bit word
constexpr int NS = 16;  // 6 + NCH padded to a power of two: the reduce-scatter's slots
constexpr int WARPS = PIX / 32;
constexpr int MAX_CH = NS - 6;
// Resident blocks per SM asked of the compiler, by channel count (index 0
// unused): a cap of 65536 / 256 / K2_MIN_BLOCKS registers a thread. Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (scripts/k2_blocks.py, PERF.md): up to
// three channels the kernel fits 64 registers whatever is asked; from 4 to 8
// four blocks with a spill of 16-56 bytes beat three with less or none; at 9
// and 10 the spill grows to 72-96 bytes and three blocks (80 registers) are
// faster.
constexpr int K2_MIN_BLOCKS[MAX_CH + 1] = {0, 4, 4, 4, 4, 4, 4, 4, 4, 3, 3};

template <int NCH>
__global__ void __launch_bounds__(PIX, K2_MIN_BLOCKS[NCH])
    composite_backward_kernel(const float* __restrict__ attrs, const int* __restrict__ pair_gauss,
                              const int* __restrict__ tile_start, int grid_x, int width,
                              int height, const float* __restrict__ state,
                              const float* __restrict__ g, float* __restrict__ dpair) {
  constexpr int NA = 6 + NCH;  // attribute columns = gradient columns
  __shared__ StagedPair<NCH> sh[BB];
  __shared__ float s_red[WARPS][BB * NA];  // warp totals, [pair][column]
  __shared__ unsigned s_words[WARPS][2];  // per warp: the staged pairs its pixels can reach
  __shared__ unsigned long long s_touched[WARPS];  // pairs of the batch each warp reduced
  __shared__ int s_reach;

  const int tile = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int lx = WarpShape::lx(tid), ly = WarpShape::ly(tid);
  const int tx = tile % grid_x, ty = tile / grid_x;
  const int pxi = tx * TILE + lx, pyi = ty * TILE + ly;
  const bool inside = pxi < width && pyi < height;
  const float ox = float(tx * TILE), oy = float(ty * TILE);
  const float fx = float(lx), fy = float(ly);
  const int start = tile_start[tile], end = tile_start[tile + 1];

  // T_final = 1 - silhouette: the very float the plain version reconstructs.
  float T = 1.0f;
  int nc = 0;
  float gch[NCH + 1];  // channel cotangents, the silhouette's
#pragma unroll
  for (int c = 0; c <= NCH; ++c) gch[c] = 0.0f;
  if (inside) {
    const size_t hw = size_t(width) * height, pix = size_t(pyi) * width + pxi;
    T = 1.0f - state[NCH * hw + pix];
    nc = int(state[(NCH + 1) * hw + pix]);
#pragma unroll
    for (int c = 0; c <= NCH; ++c) gch[c] = g[c * hw + pix];
  }
  const int warp_nc = __reduce_max_sync(FULL, nc);  // the deepest pair this warp applies
  if (tid == 0) s_reach = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&s_reach, warp_nc);
  __syncthreads();
  const int reach = start + s_reach;

  for (size_t i = size_t(reach) * NA + tid; i < size_t(end) * NA; i += PIX) dpair[i] = 0.0f;

  // Suffix accumulators. The silhouette's previous value is a constant 1:
  // before the first applied pair last_alpha is 0, which gives the same accum.
  float accum[NCH + 1], last_c[NCH];
#pragma unroll
  for (int c = 0; c <= NCH; ++c) accum[c] = 0.0f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) last_c[c] = 0.0f;
  float last_alpha = 0.0f;

  for (int bend = reach; bend > start; bend -= BB) {
    const int bstart = max(start, bend - BB);
    const int n = bend - bstart;
    const int jlim = nc - (bstart - start);  // this pixel applies pairs jj < jlim
    // The previous batch's walks ended before its merge barrier, so its staged
    // pairs and lists can be overwritten.
    if (tid < BB) {
      unsigned mask = 0;
      if (tid < n) {
        const int i = bstart + tid;
        const size_t row = pair_gauss != nullptr ? size_t(pair_gauss[i]) : size_t(i);
        mask = stage_pair(sh[tid], attrs + row * NA, ox, oy);
      }
      // Staging warp k holds pairs 32k .. 32k + 31: word k of every warp's list.
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const unsigned word = __ballot_sync(FULL, (mask >> w) & 1u);
        if (lane == 0) s_words[w][warp] = word;
      }
    }
    __syncthreads();

    const int wlim = warp_nc - (bstart - start);  // the warp visits pairs jj < wlim
    unsigned long long bits = s_words[warp][0] | (unsigned long long)s_words[warp][1] << 32;
    if (wlim < 64) bits &= wlim > 0 ? (1ull << wlim) - 1ull : 0ull;
    unsigned long long touched = 0;
    // top(bits) is the deepest listed pair, -1 for an empty list.
    for (int jj = 63 - __clzll((long long)bits); jj >= 0; jj = 63 - __clzll((long long)bits)) {
      bits &= ~(1ull << jj);
      float r[NS];
#pragma unroll
      for (int c = 0; c < NS; ++c) r[c] = 0.0f;
      bool contrib = false;
      if (jj < jlim) {
        const StagedPair<NCH>& p = sh[jj];
        const float4 gq = p.geo;
        const float2 gq2 = p.geo2;
        const float dx = gq.x - fx;
        const float dy = gq.y - fy;
        const float ca = gq.z, cb = gq.w, cc = gq2.x;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power <= 0.0f) {
          const float op = gq2.y;
          const float G = expf(power);
          const float alpha_un = op * G;
          const float alpha = fminf(ALPHA_MAX, alpha_un);
          if (alpha >= ALPHA_MIN) {
            contrib = true;
            T = T / (1.0f - alpha);
            const float wgt = alpha * T;
            float val[NCH];
            p.channels(val);
            float dalpha = 0.0f;
#pragma unroll
            for (int c = 0; c <= NCH; ++c) {
              const float v = c < NCH ? val[c] : 1.0f;
              const float prev = c < NCH ? last_c[c] : 1.0f;
              accum[c] = last_alpha * prev + (1.0f - last_alpha) * accum[c];
              dalpha += (v - accum[c]) * gch[c];
              if (c < NCH) {
                last_c[c] = v;
                r[6 + c] = wgt * gch[c];
              }
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
        const float total = reduce_scatter16(r, lane);
        const int slot = lane >> 1;
        if ((lane & 1) == 0 && slot < NA) s_red[warp][jj * NA + slot] = total;
        touched |= 1ull << jj;
      }
    }
    if (lane == 0) s_touched[warp] = touched;
    __syncthreads();

    // Merge and store: one (pair, column) per thread, the touching warps in
    // warp order; dpair[bstart * NA .. (bstart + n) * NA) is contiguous.
    float* out = dpair + size_t(bstart) * NA;
    for (int e = tid; e < n * NA; e += PIX) {
      const int p = e / NA;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if ((s_touched[w] >> p) & 1ull) v += s_red[w][e];
      }
      out[e] = v;
    }
    // No barrier here: the next batch's walks, which write s_red and
    // s_touched, start after its staging barrier, which every thread reaches
    // only after its part of this merge.
  }
}

template <int NCH>
int launch_composite_backward(const float* attrs, const int* pair_gauss, const int* tile_start,
                              int grid_x, int grid_y, int width, int height, const float* state,
                              const float* g, float* dpair, void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    composite_backward_kernel<NCH><<<tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_gauss, tile_start, grid_x, width, height, state, g, dpair);
  }
  return (int)cudaGetLastError();
}

// The instance for ch channels, or null for a count no instance takes.
inline const void* composite_backward_fn(int ch) {
  switch (ch) {
#define K2_CASE(n) \
  case n:          \
    return (const void*)composite_backward_kernel<n>;
    K2_CASE(1) K2_CASE(2) K2_CASE(3) K2_CASE(4) K2_CASE(5)
    K2_CASE(6) K2_CASE(7) K2_CASE(8) K2_CASE(9) K2_CASE(10)
#undef K2_CASE
  }
  return nullptr;
}

}  // namespace splatam

// K2 at ch channels: attrs [N or P, 6 + ch], state [ch + 2, H, W], g
// [ch + 1, H, W], dpair [P, 6 + ch].
extern "C" int composite_backward(int ch, const float* attrs, const int* pair_gauss,
                                  const int* tile_start, int grid_x, int grid_y, int width,
                                  int height, const float* state, const float* g, float* dpair,
                                  void* stream) {
  switch (ch) {
#define K2_LAUNCH(n) \
  case n:            \
    return splatam::launch_composite_backward<n>(attrs, pair_gauss, tile_start, grid_x, grid_y, \
                                                 width, height, state, g, dpair, stream);
    K2_LAUNCH(1) K2_LAUNCH(2) K2_LAUNCH(3) K2_LAUNCH(4) K2_LAUNCH(5)
    K2_LAUNCH(6) K2_LAUNCH(7) K2_LAUNCH(8) K2_LAUNCH(9) K2_LAUNCH(10)
#undef K2_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}

// What the compiler gave K2's instance at ch channels: registers and local
// (spill) bytes per thread, and resident blocks per SM.
extern "C" int composite_backward_info(int ch, int* regs, int* local_bytes, int* blocks_per_sm) {
  const void* fn = splatam::composite_backward_fn(ch);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return splatam::kernel_info(fn, splatam::PIX, regs, local_bytes, blocks_per_sm);
}
