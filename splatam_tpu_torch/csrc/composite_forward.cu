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
//   - a staged pair at five channels is one 48-byte structure (StagedPair):
//     one 16-byte and one 8-byte broadcast read per evaluation, two more when
//     it applies, and the centre is stored relative to the tile's origin;
//   - a block stops as soon as every pixel has terminated, a warp as soon as
//     its 32 pixels have (it then only meets the barriers).
// The output goes straight into the [C, H, W] image; no tile-major
// intermediate and no assemble pass. The walk itself (composite_walk,
// common.cuh) is shared with K4 and the probes fwd2 and math_only; what is
// K1's own is how a pair is read: its 11-column row.
//
// Two input modes: per-Gaussian rows gathered through pair_gauss (the generic
// render), or, with a null pair_gauss, one row per sorted pair (the pair-space
// tracking render, whose rows are projected per pair), read in place.
//
// The channel count is a template parameter, 1 to 10 as the TPU kernel takes
// (composite_pallas.py:256 reads rows 6 .. 6 + ch of its 16-row block): the
// staged pair holds ch channels (StagedPair<ch>, common.cuh) and each pixel
// ch accumulators. The five-channel instance is the SLAM loop's, compiled from
// the same walk as K4 and the probes.
#include "common.cuh"

namespace splatam {

// K1's staging: the pair's (6 + NCH)-column attribute row, gathered by
// Gaussian index or read in place.
template <int CH>
struct AttrRows {
  static constexpr int NCH = CH;
  using Row = const float*;
  const float* __restrict__ attrs;
  const int* __restrict__ pair_gauss;

  __device__ __forceinline__ Row load(int i) const {
    const size_t row = pair_gauss != nullptr ? size_t(pair_gauss[i]) : size_t(i);
    return attrs + row * (6 + NCH);
  }

  __device__ __forceinline__ unsigned stage(StagedPair<NCH>& s, Row a, float ox, float oy) const {
    return stage_pair(s, a, ox, oy);
  }
};

// One instance per channel count 1 .. MAX_CH (the TPU kernel's attribute block
// holds 16 rows: 6 + ch <= 16). Four resident blocks per SM leave 64 registers
// a thread, more than the widest instance's walk holds (PERF.md).
template <int NCH>
__global__ void __launch_bounds__(PIX, 4)
    composite_forward_kernel(const float* __restrict__ attrs, const int* __restrict__ pair_gauss,
                             const int* __restrict__ tile_start, int grid_x, int width,
                             int height, float* __restrict__ out) {
  __shared__ WalkShared<1, NCH> sh;
  const AttrRows<NCH> rows = {attrs, pair_gauss};
  composite_walk<1>(sh, rows, tile_start[blockIdx.x], tile_start[blockIdx.x + 1], grid_x, width,
                    height, out);
}

template <int NCH>
int launch_composite_forward(const float* attrs, const int* pair_gauss, const int* tile_start,
                             int grid_x, int grid_y, int width, int height, float* out,
                             void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    composite_forward_kernel<NCH><<<tiles, PIX, 0, (cudaStream_t)stream>>>(
        attrs, pair_gauss, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}

// The instance for ch channels, or null for a count no instance takes.
inline const void* composite_forward_fn(int ch) {
  switch (ch) {
#define K1_CASE(n) \
  case n:          \
    return (const void*)composite_forward_kernel<n>;
    K1_CASE(1) K1_CASE(2) K1_CASE(3) K1_CASE(4) K1_CASE(5)
    K1_CASE(6) K1_CASE(7) K1_CASE(8) K1_CASE(9) K1_CASE(10)
#undef K1_CASE
  }
  return nullptr;
}

}  // namespace splatam

// K1 at ch channels: attrs [N or P, 6 + ch], out [ch + 2, H, W].
extern "C" int composite_forward(int ch, const float* attrs, const int* pair_gauss,
                                 const int* tile_start, int grid_x, int grid_y, int width,
                                 int height, float* out, void* stream) {
  switch (ch) {
#define K1_LAUNCH(n) \
  case n:            \
    return splatam::launch_composite_forward<n>(attrs, pair_gauss, tile_start, grid_x, grid_y, \
                                                width, height, out, stream);
    K1_LAUNCH(1) K1_LAUNCH(2) K1_LAUNCH(3) K1_LAUNCH(4) K1_LAUNCH(5)
    K1_LAUNCH(6) K1_LAUNCH(7) K1_LAUNCH(8) K1_LAUNCH(9) K1_LAUNCH(10)
#undef K1_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}

// What the compiler gave K1's instance at ch channels: registers and local
// (spill) bytes per thread, and resident blocks per SM.
extern "C" int composite_forward_info(int ch, int* regs, int* local_bytes, int* blocks_per_sm) {
  const void* fn = splatam::composite_forward_fn(ch);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return splatam::kernel_info(fn, splatam::PIX, regs, local_bytes, blocks_per_sm);
}

extern "C" const char* last_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
