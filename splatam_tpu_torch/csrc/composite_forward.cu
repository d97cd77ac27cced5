// K1: composite forward.
//
// Replaces composite_forward_pallas / _fwd_kernel
// (splatam_tpu/render/pallas/composite_pallas.py:184-310): per 16x16 tile,
// front-to-back alpha compositing of the tile's depth-sorted pairs under
// renderCUDA's rules, writing the channels, the silhouette 1 - T_final and
// n_contrib.
//
// What bounds it on an H100: operations, not bytes. Reading the rows is a few
// percent of the time (the dma probes of fused_probes.cu); the time goes into
// the pair-pixel evaluations, each a dependent chain (dx, dy, power, expf, the
// alpha tests, T) run by every lane of every warp for every staged pair,
// though the map's Gaussians are small: most pairs reach only a few rows of
// their tile. So the design runs fewer evaluations, and fewer instructions
// per evaluation:
//   - one block per tile, one thread per pixel, a warp four rows of eight
//     pixels (WarpShape, common.cuh), batches of 256 pairs staged in
//     shared memory (one pair per thread, gathered by Gaussian index), so a
//     row is read from device memory once per tile;
//   - the staging thread computes once the box outside which its pair cannot
//     contribute (pair_reach, common.cuh) and the warps whose pixels meet it.
//     A warp ballot per warp of the tile turns the batch's masks into one
//     32-bit word per (warp, 32 pairs): the list of pairs that warp must visit;
//   - each warp steps through the set bits of its own words (__ffs), in depth
//     order, so a pair it cannot reach costs it nothing; a culled evaluation
//     is one the plain walk leaves by its power > 0 or alpha < 1/255 test, so
//     the result is unchanged, bit for bit;
//   - a staged pair is one 48-byte structure (StagedPair): one 16-byte and
//     one 8-byte broadcast read per evaluation, two more when it applies, and
//     the centre is stored relative to the tile's origin;
//   - a block stops as soon as every pixel has terminated, a warp as soon as
//     its 32 pixels have (it then only meets the barriers).
// The output goes straight into the [C, H, W] image; no tile-major
// intermediate and no assemble pass. The arithmetic is composite_tile's
// (common.cuh, still the walk of K4 and the probes), expression by expression.
//
// Two input modes: per-Gaussian rows gathered through pair_gauss (the generic
// render), or, with a null pair_gauss, one row per sorted pair (the pair-space
// tracking render, whose rows are projected per pair), read in place.
#include "common.cuh"

namespace splatam {

constexpr int NCH = 5;  // the AoS staging holds exactly five channels
constexpr int WARPS = PIX / 32;
constexpr int WORDS = PIX / 32;  // 32-pair words of one staged batch

// One pixel's evaluation of staged pair j: composite_tile's loop body.
__device__ __forceinline__ void composite_pair(const StagedPair& p, float fx, float fy,
                                               int index, float& T, float* acc, int& last,
                                               bool& done) {
  const float4 g = p.geo;
  const float2 g2 = p.geo2;
  const float dx = g.x - fx;
  const float dy = g.y - fy;
  const float power = -0.5f * (g.z * dx * dx + g2.x * dy * dy) - g.w * dx * dy;
  if (power > 0.0f) return;
  const float alpha = fminf(ALPHA_MAX, g2.y * expf(power));
  if (alpha < ALPHA_MIN) return;
  const float test_T = T * (1.0f - alpha);
  if (test_T < T_EPS) {
    done = true;
    return;
  }
  const float wgt = alpha * T;
  const float4 c = p.chan;
  acc[0] += c.x * wgt;
  acc[1] += c.y * wgt;
  acc[2] += c.z * wgt;
  acc[3] += c.w * wgt;
  acc[4] += p.chan4 * wgt;
  T = test_T;
  last = index;
}

__global__ void __launch_bounds__(PIX, 4)
    composite_forward_kernel(const float* __restrict__ attrs, const int* __restrict__ pair_gauss,
                             const int* __restrict__ tile_start, int grid_x, int width,
                             int height, float* __restrict__ out) {
  __shared__ StagedPair sh[PIX];
  __shared__ unsigned s_words[WARPS][WORDS];  // per warp: the staged pairs it must visit

  const int tile = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int lx = WarpShape::lx(tid), ly = WarpShape::ly(tid);
  const int tx = tile % grid_x, ty = tile / grid_x;
  const int pxi = tx * TILE + lx, pyi = ty * TILE + ly;
  const bool inside = pxi < width && pyi < height;
  const float ox = float(tx * TILE), oy = float(ty * TILE);
  const float fx = float(lx), fy = float(ly);
  const int start = tile_start[tile], end = tile_start[tile + 1];

  float T = 1.0f;
  float acc[NCH] = {0.f, 0.f, 0.f, 0.f, 0.f};
  int last = 0;
  bool done = !inside;

  for (int base = start; base < end; base += PIX) {
    if (__syncthreads_count(done) == PIX) break;
    const int i = base + tid;
    unsigned mask = 0;
    if (i < end) {
      const size_t row = pair_gauss != nullptr ? size_t(pair_gauss[i]) : size_t(i);
      mask = stage_pair(sh[tid], attrs + row * (6 + NCH), ox, oy);
    }
    // Staging warp k holds pairs 32k .. 32k + 31: word k of every warp's list.
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const unsigned word = __ballot_sync(FULL, (mask >> w) & 1u);
      if (lane == 0) s_words[w][warp] = word;
    }
    __syncthreads();
    const int n = min(PIX, end - base);
    const int first = base - start + 1;  // n_contrib of the batch's first pair
    for (int k = 0; k < (n + 31) >> 5; ++k) {
      if (__all_sync(FULL, done)) break;
      unsigned bits = s_words[warp][k];
      while (bits != 0u) {
        const int j = (k << 5) + __ffs(bits) - 1;
        bits &= bits - 1u;
        if (!done) composite_pair(sh[j], fx, fy, first + j, T, acc, last, done);
      }
    }
  }
  if (inside) {
    const size_t hw = size_t(width) * height, pix = size_t(pyi) * width + pxi;
#pragma unroll
    for (int c = 0; c < NCH; ++c) out[c * hw + pix] = acc[c];
    out[NCH * hw + pix] = 1.0f - T;
    out[(NCH + 1) * hw + pix] = float(last);
  }
}

}  // namespace splatam

extern "C" int composite_forward_ch5(const float* attrs, const int* pair_gauss,
                                     const int* tile_start, int grid_x, int grid_y, int width,
                                     int height, float* out, void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::composite_forward_kernel<<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_gauss, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}

// What the compiler gave K1: registers and local (spill) bytes per thread,
// and resident blocks per SM.
extern "C" int composite_forward_info(int* regs, int* local_bytes, int* blocks_per_sm) {
  return splatam::kernel_info((const void*)splatam::composite_forward_kernel, splatam::PIX, regs,
                              local_bytes, blocks_per_sm);
}

extern "C" const char* last_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
