// K3: segment reduce (per-pair -> per-Gaussian gradient sums).
//
// Replaces segment_reduce_scan_pallas / _reduce_kernel
// (splatam_tpu/render/pallas/composite_pallas.py:558-647) together with the
// gather before it and the end-slot gather after it (fused_iso.py:812-823,
// composite_pallas.py:751-763). The callers only read each Gaussian's total
// of its per-pair gradient rows, so that is the contract kept; no prefix sums
// are materialized.
//
// What bounds it on an H100: gather bandwidth (each pair's row is read once,
// from a tile-sorted position). Design: pairs are expanded Gaussian-major, so
// Gaussian g owns expansion slots offset[g] .. offset[g] + count[g] and dst
// maps each one to its tile-sorted slot. One warp sums one Gaussian. The
// kernel is templated on the row width NC (8 for the fused isotropic path's
// world rows, 11 for the generic path's screen-space rows): each row is read
// by LPR lanes (NC rounded up to a power of two; lanes past NC idle), so a
// warp reads 32 / LPR rows per step, and log2(32 / LPR) shuffles fold the
// row partials before lanes 0 .. NC-1 store the totals. Loads are scalar: an
// 11-float row is not 16-byte aligned, and the lanes of one row still read
// one contiguous run. The summation order is fixed, so the result is
// deterministic, and no atomics are needed.
#include "common.cuh"

namespace splatam {

template <int NC>
__global__ void segment_reduce_kernel(const float* __restrict__ dpair,
                                      const int* __restrict__ dst,
                                      const int* __restrict__ offsets,
                                      const int* __restrict__ counts, int n,
                                      float* __restrict__ out) {
  constexpr int LPR = NC <= 8 ? 8 : 16;  // lanes per row
  constexpr int RPS = 32 / LPR;          // rows per warp step
  const int gid = int((size_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  if (gid >= n) return;  // whole warps exit together (blockDim is a multiple of 32)
  const int lane = threadIdx.x & 31;
  const int comp = lane % LPR, sub = lane / LPR;
  const int off = offsets[gid], cnt = counts[gid];
  float s = 0.0f;
  if (comp < NC) {
    for (int k = sub; k < cnt; k += RPS) s += dpair[size_t(dst[off + k]) * NC + comp];
  }
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1) s += __shfl_down_sync(FULL, s, o);
  if (lane < NC) out[size_t(gid) * NC + lane] = s;
}

template <int NC>
int launch_segment_reduce(const float* dpair, const int* dst, const int* offsets,
                          const int* counts, int n, float* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = int((size_t(n) * 32 + threads - 1) / threads);
    segment_reduce_kernel<NC><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dpair, dst, offsets, counts, n, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace splatam

extern "C" int segment_reduce8(const float* dpair, const int* dst, const int* offsets,
                               const int* counts, int n, float* out, void* stream) {
  return splatam::launch_segment_reduce<8>(dpair, dst, offsets, counts, n, out, stream);
}

extern "C" int segment_reduce11(const float* dpair, const int* dst, const int* offsets,
                                const int* counts, int n, float* out, void* stream) {
  return splatam::launch_segment_reduce<11>(dpair, dst, offsets, counts, n, out, stream);
}
