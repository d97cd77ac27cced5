// The structure build's per-pair work: the expansion of (gaussian, tile)
// pairs into 32-bit sort keys, and the scatter of the sorted stream into
// pair_gauss, dst and tile_start. One thread a pair in each.
//
// Replaces no TPU kernel: the JAX package leaves its build to XLA
// (splatam_tpu/render/binning.py build_bins: a gather expansion, a key sort,
// searchsorted). In the eager port the same build (render/binning.py
// build_bins_plain) was some 25 PyTorch launches whose int64 intermediates
// (g, j, w, tdy, tx, ty, the key, the sorted key, the order, and the sort's
// own values and workspace) held ~124 bytes a pair at the sort: the top of a
// scan's allocator peak where a build runs in every iteration. Here a pair
// holds its 32-bit key (4 bytes) into the sort; what the sort holds is the
// library's (torch.sort, stable, on the int32 keys: half the radix passes of
// the int64 key); the scatter writes the int32 outputs alone.
//
// The key of slot s of Gaussian g (slots in Gaussian order, then row-major
// over its tile rectangle) is ((ty * grid_x + tx) << bits) | qdepth[g], with
// one more low bit (j >= direct_j) under direct_j: at most 32 bits
// (render/binning.py depth_bits_for). It is stored with its top bit flipped,
// so the int32 order of the stored key is the unsigned order of the key, and
// a stable sort of it is the int64 build's stable sort, tie for tie.
//
// g is found by a binary search of offsets (the first slot of each Gaussian,
// nondecreasing): the last g with offsets[g] <= s is the Gaussian owning s,
// since a Gaussian with no pairs shares its offset with the next one.
//
// What bounds them on an H100: bytes, and few of them. The expansion reads
// ~44 bytes a Gaussian (offsets, the two int64 rectangles, the int64
// quantized depth) and writes 4 a pair; the scatter reads 12 a pair (sorted
// key, int64 order) and writes 8 (pair_gauss, dst) and the tile starts. At
// 623,579 pairs that is ~13 MB, ~4 us at 3.35 TB/s. The searches' loads hit
// L2 (offsets are 4 bytes a Gaussian); neighbouring threads of the expansion
// share their Gaussian and search along the same path.
#include "common.cuh"

namespace splatam {

constexpr int BIN_THREADS = 256;
constexpr unsigned int KEY_FLIP = 0x80000000u;

inline int bin_blocks(int n) { return (n + BIN_THREADS - 1) / BIN_THREADS; }

// The Gaussian owning slot s: the last g with offsets[g] <= s.
__device__ __forceinline__ int owner(const int* __restrict__ offsets, int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= s) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

__global__ void __launch_bounds__(BIN_THREADS) bins_expand_kernel(
    int total, int n, const int* __restrict__ offsets, const long long* __restrict__ rect_min,
    const long long* __restrict__ rect_wh, const long long* __restrict__ qdepth, int grid_x,
    int bits, int direct_j, int* __restrict__ key) {
  const int s = blockIdx.x * BIN_THREADS + threadIdx.x;
  if (s >= total) return;
  const int g = owner(offsets, n, s);
  const int j = s - __ldg(offsets + g);
  const int w = max((int)__ldg(rect_wh + 2 * g), 1);
  const int tdy = j / w;
  const int tx = (int)__ldg(rect_min + 2 * g) + j - tdy * w;
  const int ty = (int)__ldg(rect_min + 2 * g + 1) + tdy;
  unsigned int k = ((unsigned int)(ty * grid_x + tx) << bits) | (unsigned int)__ldg(qdepth + g);
  if (direct_j > 0) k = (k << 1) | (j >= direct_j ? 1u : 0u);
  key[s] = (int)(k ^ KEY_FLIP);
}

// Sorted position i holds slot order[i]: its Gaussian, its slot's sorted
// position, and the starts of the tiles from the previous pair's tile (not
// included) to this one's; the last pair also closes the tiles after it.
__global__ void __launch_bounds__(BIN_THREADS) bins_scatter_kernel(
    int total, int n, const int* __restrict__ sorted_key, const long long* __restrict__ order,
    const int* __restrict__ offsets, int key_bits, int num_tiles, int* __restrict__ pair_gauss,
    int* __restrict__ dst, int* __restrict__ tile_start) {
  const int i = blockIdx.x * BIN_THREADS + threadIdx.x;
  if (i >= total) return;
  const int s = (int)order[i];
  pair_gauss[i] = owner(offsets, n, s);
  dst[s] = i;
  const int tile = (int)(((unsigned int)sorted_key[i] ^ KEY_FLIP) >> key_bits);
  const int first = i == 0 ? 0 : (int)(((unsigned int)sorted_key[i - 1] ^ KEY_FLIP) >> key_bits) + 1;
  for (int t = first; t <= tile; ++t) tile_start[t] = i;
  if (i == total - 1) {
    for (int t = tile + 1; t <= num_tiles; ++t) tile_start[t] = total;
  }
}

}  // namespace splatam

// total > 0 pairs over n Gaussians; key: [total] int32 out.
extern "C" int bins_expand(int total, int n, const int* offsets, const long long* rect_min,
                           const long long* rect_wh, const long long* qdepth, int grid_x,
                           int bits, int direct_j, int* key, void* stream) {
  using namespace splatam;
  bins_expand_kernel<<<bin_blocks(total), BIN_THREADS, 0, (cudaStream_t)stream>>>(
      total, n, offsets, rect_min, rect_wh, qdepth, grid_x, bits, direct_j, key);
  return (int)cudaGetLastError();
}

// total > 0 sorted pairs; pair_gauss, dst: [total] int32, tile_start:
// [num_tiles + 1] int32 out.
extern "C" int bins_scatter(int total, int n, const int* sorted_key, const long long* order,
                            const int* offsets, int key_bits, int num_tiles, int* pair_gauss,
                            int* dst, int* tile_start, void* stream) {
  using namespace splatam;
  bins_scatter_kernel<<<bin_blocks(total), BIN_THREADS, 0, (cudaStream_t)stream>>>(
      total, n, sorted_key, order, offsets, key_bits, num_tiles, pair_gauss, dst, tile_start);
  return (int)cudaGetLastError();
}

// What the compiler gave the expansion (0) or the scatter (1).
extern "C" int bins_info(int scatter, int* regs, int* local_bytes, int* blocks_per_sm) {
  const void* fn = scatter ? (const void*)splatam::bins_scatter_kernel
                           : (const void*)splatam::bins_expand_kernel;
  return splatam::kernel_info(fn, splatam::BIN_THREADS, regs, local_bytes, blocks_per_sm);
}
