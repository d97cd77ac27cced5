// K4: fused isotropic forward.
//
// Replaces fused_forward_pallas / _fused_fwd_kernel
// (splatam_tpu/render/pallas/fused_iso.py:195-336): isotropic EWA projection
// of each pair inside the kernel, then compositing as K1. Writes r, g, b, z,
// z^2, the silhouette and n_contrib ([7, H, W]); the backward reads the last
// two as its saved state.
//
// What bounds it on an H100: per-pixel latency of the sequential walk and
// reading the pairs' world rows. Design: one block per tile, one thread per
// pixel. Each thread of the block projects one pair of the batch (its
// 32-byte world row read as two float4 loads) while staging it in shared
// memory, so a pair is projected once per tile instead of once per pixel,
// and the walk is the same shared-memory loop as K1. The skip mask leaves out
// in_front and det_ok on purpose (fused_iso.py:168-178): a Gaussian pushed
// behind the near plane within a structure-reuse window composites at
// safe_tz = 1; the depth channels are the raw tz and tz^2.
#include "common.cuh"

namespace splatam {

__global__ void __launch_bounds__(PIX)
    fused_forward_kernel(const float* __restrict__ world8, const float* __restrict__ pose,
                         const int* __restrict__ tile_start, int grid_x, int width, int height,
                         float* __restrict__ out) {
  __shared__ SharedPairs<5> sh;
  const Pose P = load_pose(pose);
  const float fw = float(width), fh = float(height);
  const int start = tile_start[blockIdx.x], end = tile_start[blockIdx.x + 1];
  auto stage = [&](int i, int slot) {
    const float4* row = reinterpret_cast<const float4*>(world8 + size_t(i) * 8);
    const float4 lo = row[0], hi = row[1];
    const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const ProjIso q = project_iso(w, P, fw, fh);
    sh.v[0][slot] = q.pix_x;
    sh.v[1][slot] = q.pix_y;
    sh.v[2][slot] = q.conic_a;
    sh.v[3][slot] = q.conic_b;
    sh.v[4][slot] = q.conic_c;
    sh.v[5][slot] = q.opacity;
    sh.v[6][slot] = w[5];
    sh.v[7][slot] = w[6];
    sh.v[8][slot] = w[7];
    sh.v[9][slot] = q.tz;
    sh.v[10][slot] = q.tz * q.tz;
  };
  composite_tile<5>(sh, stage, start, end, grid_x, width, height, out);
}

}  // namespace splatam

extern "C" int fused_forward(const float* world8, const float* pose, const int* tile_start,
                             int grid_x, int grid_y, int width, int height, float* out,
                             void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::fused_forward_kernel<<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        world8, pose, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}
