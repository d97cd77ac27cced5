// K3: segment reduce (per-pair -> per-Gaussian gradient sums).
//
// Replaces segment_reduce_scan_pallas / _reduce_kernel
// (splatam_tpu/render/pallas/composite_pallas.py:558-647) together with the
// gather before it and the end-slot gather after it (fused_iso.py:812-823,
// composite_pallas.py:751-763). The callers only read each Gaussian's total
// of its per-pair gradient rows, so that is the contract kept; no prefix sums
// are materialized.
//
// Pairs are expanded Gaussian-major: Gaussian g owns expansion slots
// offset[g] .. offset[g] + count[g], and dst maps each one to its tile-sorted
// row of dpair. At the main path's shapes a Gaussian has 1.74 pairs on
// average, so the work is ~1M short gathers.
//
// What bounds it on an H100: memory latency times the number of waves, not
// bytes. Every thread runs a chain of three dependent loads (offset and count,
// then dst, then the row); a layout that gives each Gaussian a whole warp
// leaves most lanes idle and needs ~111 waves of warps for ~1M Gaussians.
// Design: a Gaussian gets a small group of lanes, assigned in flattened
// (Gaussian, piece of row) order, so a warp serves many Gaussians and its
// output store is one coalesced run:
//   - 8 columns (the fused path's world rows, 32-byte aligned): two threads
//     per Gaussian, each summing one 16-byte half of the row as a float4, 16
//     Gaussians per warp (segment_reduce_half_kernel);
//   - 11 columns (the generic path's screen rows at five channels, 44 bytes,
//     not 16-byte aligned), every other width of the generic render's rows
//     (6 + ch columns, 7 to 16 for ch 1 to 10), and 8 columns whose rows are
//     not 16-byte aligned: one thread per (Gaussian, column), ~2.9 Gaussians
//     per warp at 11 with no idle lanes (segment_reduce_kernel<NC>).
// The loop over a Gaussian's slots is unrolled by UNROLL: that many dst loads,
// then that many row loads, are in flight before the adds. Each thread adds
// its Gaussian's rows in slot order, so the summation order is fixed (the
// same in both kernels, two launches are equal bit for bit) and no atomics
// are needed.
#include "common.cuh"

namespace splatam {

constexpr int UNROLL = 4;
constexpr int K3_THREADS = 256;

// One thread per (Gaussian, column): thread t sums column t % NC of Gaussian
// t / NC.
template <int NC>
__global__ void __launch_bounds__(K3_THREADS)
    segment_reduce_kernel(const float* __restrict__ dpair, const int* __restrict__ dst,
                          const int* __restrict__ offsets, const int* __restrict__ counts,
                          int n, float* __restrict__ out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= unsigned(n) * NC) return;
  const int gid = int(t / NC), col = int(t % NC);
  const int off = offsets[gid], cnt = counts[gid];
  float s = 0.0f;
  for (int k = 0; k < cnt; k += UNROLL) {
    int j[UNROLL];
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) j[u] = k + u < cnt ? dst[off + k + u] : 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = k + u < cnt ? dpair[size_t(j[u]) * NC + col] : 0.0f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (k + u < cnt) s += v[u];
    }
  }
  out[t] = s;
}

// 8 columns, rows 16-byte aligned: thread t sums half t % 2 (columns 0-3 or
// 4-7) of Gaussian t / 2 as one float4 per row.
__global__ void __launch_bounds__(K3_THREADS)
    segment_reduce_half_kernel(const float4* __restrict__ dpair, const int* __restrict__ dst,
                               const int* __restrict__ offsets, const int* __restrict__ counts,
                               int n, float4* __restrict__ out) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= unsigned(n) * 2) return;
  const int gid = int(t >> 1), half = int(t & 1);
  const int off = offsets[gid], cnt = counts[gid];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = zero;
  for (int k = 0; k < cnt; k += UNROLL) {
    int j[UNROLL];
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) j[u] = k + u < cnt ? dst[off + k + u] : 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = k + u < cnt ? dpair[size_t(j[u]) * 2 + half] : zero;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (k + u < cnt) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
    }
  }
  out[t] = s;
}

inline int blocks_for(size_t threads) {
  return int((threads + K3_THREADS - 1) / K3_THREADS);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

template <int NC>
int launch_segment_reduce(const float* dpair, const int* dst, const int* offsets,
                          const int* counts, int n, float* out, void* stream) {
  if (n > 0) {
    if (NC == 8 && aligned16(dpair) && aligned16(out)) {
      segment_reduce_half_kernel<<<blocks_for(size_t(n) * 2), K3_THREADS, 0,
                                   (cudaStream_t)stream>>>(
          reinterpret_cast<const float4*>(dpair), dst, offsets, counts, n,
          reinterpret_cast<float4*>(out));
    } else {
      segment_reduce_kernel<NC><<<blocks_for(size_t(n) * NC), K3_THREADS, 0,
                                  (cudaStream_t)stream>>>(dpair, dst, offsets, counts, n, out);
    }
  }
  return (int)cudaGetLastError();
}

// The instance for nc columns (8: the float4 kernel), or null for a width no
// instance takes.
inline const void* segment_reduce_fn(int nc) {
  switch (nc) {
    case 8:
      return (const void*)segment_reduce_half_kernel;
#define K3_CASE(n) \
  case n:          \
    return (const void*)segment_reduce_kernel<n>;
    K3_CASE(7) K3_CASE(9) K3_CASE(10) K3_CASE(11) K3_CASE(12)
    K3_CASE(13) K3_CASE(14) K3_CASE(15) K3_CASE(16)
#undef K3_CASE
  }
  return nullptr;
}

}  // namespace splatam

// K3 at nc columns, 7 to 16: dpair [P, nc] -> out [n, nc].
extern "C" int segment_reduce(int nc, const float* dpair, const int* dst, const int* offsets,
                              const int* counts, int n, float* out, void* stream) {
  switch (nc) {
#define K3_LAUNCH(k) \
  case k:            \
    return splatam::launch_segment_reduce<k>(dpair, dst, offsets, counts, n, out, stream);
    K3_LAUNCH(7) K3_LAUNCH(8) K3_LAUNCH(9) K3_LAUNCH(10) K3_LAUNCH(11)
    K3_LAUNCH(12) K3_LAUNCH(13) K3_LAUNCH(14) K3_LAUNCH(15) K3_LAUNCH(16)
#undef K3_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}

// What the compiler gave K3's kernel at `nc` columns (8: the float4 kernel):
// registers and local (spill) bytes per thread, and resident blocks per SM.
extern "C" int segment_reduce_info(int nc, int* regs, int* local_bytes, int* blocks_per_sm) {
  const void* fn = splatam::segment_reduce_fn(nc);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return splatam::kernel_info(fn, splatam::K3_THREADS, regs, local_bytes, blocks_per_sm);
}
