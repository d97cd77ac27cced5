// Shared pieces of the compositing kernels: renderCUDA's per-pixel rules and
// the isotropic EWA projection of one pair (port of _project_rows in
// splatam_tpu/render/pallas/fused_iso.py, expression by expression).
#pragma once

#include <cuda_runtime.h>

namespace splatam {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;  // one thread per pixel, one block per tile
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float NEAR_CLIP = 0.2f;
constexpr unsigned FULL = 0xffffffffu;

// Pose vector layout (fused_iso.make_pose_vec): R row-major, t, fx, fy, cx,
// cy, limx, limy, then the NDC terms ax, bx, ay, by computed on the host.
struct Pose {
  float r[9], t[3], fx, fy, cx, cy, limx, limy, ax, bx, ay, by;
};

__device__ __forceinline__ Pose load_pose(const float* __restrict__ p) {
  Pose s;
#pragma unroll
  for (int i = 0; i < 9; ++i) s.r[i] = p[i];
  s.t[0] = p[9]; s.t[1] = p[10]; s.t[2] = p[11];
  s.fx = p[12]; s.fy = p[13]; s.cx = p[14]; s.cy = p[15];
  s.limx = p[16]; s.limy = p[17];
  s.ax = p[18]; s.bx = p[19]; s.ay = p[20]; s.by = p[21];
  return s;
}

// Everything the forward composites and the backward chain reads.
struct ProjIso {
  float px, py, tz, safe_tz, p_w, ax, bx, ay, by;
  float inv_z, inv_z2, vx, vy, txtz, tytz, tx, ty;
  float j00, j02, j11, j12, s2, c00, c01, c11, inv_det;
  bool in_front, det_ok;
  float pix_x, pix_y, conic_a, conic_b, conic_c, opacity;
};

__device__ __forceinline__ ProjIso project_iso(const float* __restrict__ w, const Pose& P,
                                               float width, float height) {
  ProjIso q;
  const float mwx = w[0], mwy = w[1], mwz = w[2];
  q.px = P.r[0] * mwx + P.r[1] * mwy + P.r[2] * mwz + P.t[0];
  q.py = P.r[3] * mwx + P.r[4] * mwy + P.r[5] * mwz + P.t[1];
  q.tz = P.r[6] * mwx + P.r[7] * mwy + P.r[8] * mwz + P.t[2];
  q.in_front = q.tz > NEAR_CLIP;
  q.safe_tz = q.in_front ? q.tz : 1.0f;
  q.p_w = 1.0f / (q.safe_tz + 1e-7f);
  q.ax = P.ax;
  q.bx = P.bx;
  q.ay = P.ay;
  q.by = P.by;
  const float x_ndc = (q.ax * q.px - q.bx * q.safe_tz) * q.p_w;
  const float y_ndc = (q.ay * q.py - q.by * q.safe_tz) * q.p_w;
  q.pix_x = ((x_ndc + 1.0f) * width - 1.0f) * 0.5f;
  q.pix_y = ((y_ndc + 1.0f) * height - 1.0f) * 0.5f;
  q.inv_z = 1.0f / q.safe_tz;
  q.vx = q.px * q.inv_z;
  q.vy = q.py * q.inv_z;
  q.txtz = fminf(fmaxf(q.vx, -P.limx), P.limx);
  q.tytz = fminf(fmaxf(q.vy, -P.limy), P.limy);
  q.tx = q.txtz * q.safe_tz;
  q.ty = q.tytz * q.safe_tz;
  q.inv_z2 = q.inv_z * q.inv_z;
  q.j00 = P.fx * q.inv_z;
  q.j02 = -P.fx * q.tx * q.inv_z2;
  q.j11 = P.fy * q.inv_z;
  q.j12 = -P.fy * q.ty * q.inv_z2;
  q.s2 = w[3];
  q.c00 = q.s2 * (q.j00 * q.j00 + q.j02 * q.j02) + 0.3f;
  q.c01 = q.s2 * (q.j02 * q.j12);
  q.c11 = q.s2 * (q.j11 * q.j11 + q.j12 * q.j12) + 0.3f;
  const float det = q.c00 * q.c11 - q.c01 * q.c01;
  q.det_ok = det != 0.0f;
  q.inv_det = 1.0f / (q.det_ok ? det : 1.0f);
  q.conic_a = q.c11 * q.inv_det;
  q.conic_b = -q.c01 * q.inv_det;
  q.conic_c = q.c00 * q.inv_det;
  q.opacity = w[4];
  return q;
}

// Pair attributes staged in shared memory, structure of arrays:
// rows 0-1 xy, 2-4 conic a/b/c, 5 opacity, 6.. channels.
template <int NCH>
struct SharedPairs {
  float v[6 + NCH][PIX];
};

// Front-to-back compositing of one tile, renderCUDA's loop: batches of up to
// PIX pairs are staged in shared memory by `stage(i, slot)` (one pair per
// thread), then every pixel walks the batch. Writes NCH channels, the
// silhouette (1 - T_final) and n_contrib to out [NCH + 2, H, W] for pixels
// inside the image (the bottom and right tiles may be ragged).
template <int NCH, class Stage>
__device__ __forceinline__ void composite_tile(SharedPairs<NCH>& sh, Stage stage, int start,
                                               int end, int grid_x, int width, int height,
                                               float* __restrict__ out) {
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lx = tid % TILE, ly = tid / TILE;
  const int tx = tile % grid_x, ty = tile / grid_x;
  const int pxi = tx * TILE + lx, pyi = ty * TILE + ly;
  const bool inside = pxi < width && pyi < height;
  const float ox = float(tx * TILE), oy = float(ty * TILE);
  const float fx = float(lx), fy = float(ly);

  float T = 1.0f;
  float acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
  int last = 0;
  bool done = !inside;

  for (int base = start; base < end; base += PIX) {
    if (__syncthreads_count(done) == PIX) break;
    const int i = base + tid;
    if (i < end) stage(i, tid);
    __syncthreads();
    const int n = min(PIX, end - base);
    for (int j = 0; j < n && !done; ++j) {
      const float dx = (sh.v[0][j] - ox) - fx;
      const float dy = (sh.v[1][j] - oy) - fy;
      const float power =
          -0.5f * (sh.v[2][j] * dx * dx + sh.v[4][j] * dy * dy) - sh.v[3][j] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(ALPHA_MAX, sh.v[5][j] * expf(power));
      if (alpha < ALPHA_MIN) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_EPS) {
        done = true;
        break;
      }
      const float wgt = alpha * T;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[c] += sh.v[6 + c][j] * wgt;
      T = test_T;
      last = base - start + j + 1;
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
