// K3: segment reduce (per-pair -> per-Gaussian gradient sums).
//
// Replaces segment_reduce_scan_pallas / _reduce_kernel
// (splatam_tpu/render/pallas/composite_pallas.py:558-647) together with the
// gather before it and the end-slot gather after it (fused_iso.py:812-823).
// The callers only read each Gaussian's total of its per-pair gradient rows,
// so that is the contract kept; no prefix sums are materialized.
//
// What bounds it on an H100: gather bandwidth (each pair's 32-byte row is
// read once, from a tile-sorted position). Design: pairs are expanded
// Gaussian-major, so Gaussian g owns expansion slots offset[g] ..
// offset[g] + count[g] and dst maps each one to its tile-sorted slot. One warp
// sums one Gaussian: its 32 lanes read 4 rows per step, 8 lanes per row, so
// each row is one contiguous 32-byte read; two shuffles fold the four row
// partials and lanes 0-7 store the 8 totals. The summation order is fixed,
// so the result is deterministic, and no atomics are needed.
#include "common.cuh"

namespace splatam {

__global__ void segment_reduce8_kernel(const float* __restrict__ dpair,
                                       const int* __restrict__ dst,
                                       const int* __restrict__ offsets,
                                       const int* __restrict__ counts, int n,
                                       float* __restrict__ out) {
  const int gid = int((size_t(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  if (gid >= n) return;  // whole warps exit together (blockDim is a multiple of 32)
  const int lane = threadIdx.x & 31;
  const int comp = lane & 7, sub = lane >> 3;
  const int off = offsets[gid], cnt = counts[gid];
  float s = 0.0f;
  for (int k = sub; k < cnt; k += 4) s += dpair[size_t(dst[off + k]) * 8 + comp];
  s += __shfl_down_sync(FULL, s, 16);
  s += __shfl_down_sync(FULL, s, 8);
  if (lane < 8) out[size_t(gid) * 8 + lane] = s;
}

}  // namespace splatam

extern "C" int segment_reduce8(const float* dpair, const int* dst, const int* offsets,
                               const int* counts, int n, float* out, void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = int((size_t(n) * 32 + threads - 1) / threads);
    splatam::segment_reduce8_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        dpair, dst, offsets, counts, n, out);
  }
  return (int)cudaGetLastError();
}
