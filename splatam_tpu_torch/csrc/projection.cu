// The generic render's projection, forward and backward, one thread a Gaussian.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the projection
// (splatam_tpu/render/projection.py project) and takes its gradient with
// jax.vjp inside the jitted render. In the eager port the same projection was
// some 325 PyTorch launches a render forward and 150 (tracking) to 490
// (mapping) more in its autograd backward, whose intermediates autograd held
// from the projection to the end of the render's backward: ~410 bytes a
// Gaussian in mapping, 194 in tracking. These two kernels compute what
// render/projection.py project returns, from the map's leaves
// (render/api.py _prep_gaussians folded in: the quaternion normalised, the
// log scales exponentiated, an [N, 1] column taken for all three axes), and
// its gradient in closed form (render/projection.py project_backward_plain,
// the same chain written in PyTorch, is the backward's specification). The
// autograd Function around them keeps only its inputs; the backward
// recomputes the forward in registers.
//
// Forward: every expression in project's order, in float32, compiled with
// -fmad=false, so each output is the plain version's on the card bit for
// bit: the two places where PyTorch's own kernels round otherwise, the view
// transform (a matmul: multiply-adds in column order) and the quaternion
// norms (a reduction: squares added pairwise), are written as those kernels
// round them (measured on an H100, PERF.md section 6). Backward: PyTorch
// autograd's conventions at each branch of project: a clamp passes the
// gradient on its closed interval, the lanes where safe_tz or safe_det were
// replaced get none, the norm's clamp at 1e-12 passes it where the norm is
// at least that. It writes only the gradients asked for (null outputs are
// skipped), no atomics: the same inputs give the same gradients bit for bit.
//
// What bounds them on an H100: bytes. The forward reads ~40 bytes a Gaussian
// (means, quaternion, logit, log scales, active) and writes 65 (xy, depth,
// conic, opacity, radius, the two int64 rectangles, visible): ~36 MB at
// 330k Gaussians, 11 us at 3.35 TB/s; its few hundred float operations a
// Gaussian are a tenth of that at 67 TFLOP/s. The backward reads the same
// inputs and 28 bytes of cotangents and writes 12 (tracking) to 36 (mapping).
#include "common.cuh"

namespace splatam {

constexpr int PROJ_THREADS = 256;

// What project takes from the camera, rounded to float32 on the host as
// PyTorch rounds a Python scalar against a float32 tensor
// (render/projection.py project_consts).
struct ProjConsts {
  float r[9];            // w2c's rotation, row-major
  float t[3];            // w2c's translation
  float fx, fy;          // the intrinsics
  float ax, bx, ay, by;  // 2 fx / W, (W - 2 cx) / W, 2 fy / H, (H - 2 cy) / H
  float limx, limy;      // 1.3 * lim_w / (2 fx), 1.3 * lim_h / (2 fy)
  float width, height;
  int grid_x, grid_y;    // the tile grid
};

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// Everything the backward reads of the forward, recomputed.
struct ProjState {
  float px, py, tz, safe_tz, p_w;
  float u[4], n1, c1, q1[4], n2, q[4];  // quaternion: raw, |u|, clamped, once, |q1|, twice
  float rq[9];                          // R(q), row-major
  float sc[3], ss[3];                   // exp(log scale), its square
  float sig[6];                         // Sigma: s00, s01, s02, s11, s12, s22
  float v[6];                           // W Sigma W^T: v00, v01, v02, v11, v12, v22
  float vx, vy, txtz, tytz, tx, ty, inv_z, inv_z2, j00, j02, j11, j12;
  float c00, c01, c11, det, inv_det;
  bool in_front, det_ok;
};

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return ((0.0f + a) + b) + c;  // Python's sum(): 0 + a + b + c
}

// |v| of a 4-vector as torch.linalg.vector_norm sums on the card: the
// reduction's threads add their squares as (0 + 2) + (1 + 3).
__device__ __forceinline__ float norm4(const float* v) {
  return sqrtf((v[0] * v[0] + v[2] * v[2]) + (v[1] * v[1] + v[3] * v[3]));
}

// Row i of means @ W^T + t as the card's matmul rounds it: multiply-adds in
// column order, then the translation.
__device__ __forceinline__ float view_row(const ProjConsts& k, int i, float mx, float my,
                                          float mz) {
  return fmaf(mz, k.r[3 * i + 2], fmaf(my, k.r[3 * i + 1], mx * k.r[3 * i])) + k.t[i];
}

__device__ __forceinline__ void project_state(const ProjConsts& k, const float* __restrict__ means,
                                              const float* __restrict__ quats,
                                              const float* __restrict__ log_scales,
                                              int scale_cols, int i, ProjState& s) {
  const float mx = means[3 * i], my = means[3 * i + 1], mz = means[3 * i + 2];
  s.px = view_row(k, 0, mx, my, mz);
  s.py = view_row(k, 1, mx, my, mz);
  s.tz = view_row(k, 2, mx, my, mz);
  s.in_front = s.tz > NEAR_CLIP;
  s.safe_tz = s.in_front ? s.tz : 1.0f;
  s.p_w = 1.0f / (s.safe_tz + 1e-7f);

  // api._prep_gaussians' normalize (norm clamped at 1e-12), then project's own
#pragma unroll
  for (int c = 0; c < 4; ++c) s.u[c] = quats[4 * i + c];
  s.n1 = norm4(s.u);
  s.c1 = s.n1 < 1e-12f ? 1e-12f : s.n1;
#pragma unroll
  for (int c = 0; c < 4; ++c) s.q1[c] = s.u[c] / s.c1;
  s.n2 = norm4(s.q1);
#pragma unroll
  for (int c = 0; c < 4; ++c) s.q[c] = s.q1[c] / s.n2;
  const float r = s.q[0], x = s.q[1], y = s.q[2], z = s.q[3];
  s.rq[0] = 1.0f - 2.0f * (y * y + z * z);
  s.rq[1] = 2.0f * (x * y - r * z);
  s.rq[2] = 2.0f * (x * z + r * y);
  s.rq[3] = 2.0f * (x * y + r * z);
  s.rq[4] = 1.0f - 2.0f * (x * x + z * z);
  s.rq[5] = 2.0f * (y * z - r * x);
  s.rq[6] = 2.0f * (x * z - r * y);
  s.rq[7] = 2.0f * (y * z + r * x);
  s.rq[8] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.sc[c] = expf(log_scales[size_t(i) * scale_cols + (scale_cols == 1 ? 0 : c)]);
    s.ss[c] = s.sc[c] * s.sc[c];
  }
  // _cov3d_components: (a, b) over 00, 01, 02, 11, 12, 22
  const float* R = s.rq;
  const int A[6] = {0, 0, 0, 1, 1, 2}, B[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int a = A[e], b = B[e];
    s.sig[e] = (R[3 * a] * R[3 * b] * s.ss[0] + R[3 * a + 1] * R[3 * b + 1] * s.ss[1]) +
               R[3 * a + 2] * R[3 * b + 2] * s.ss[2];
  }
  // wsig = W Sigma, then v_ij = sum_k wsig[i][k] W[j][k]
  const float sg[9] = {s.sig[0], s.sig[1], s.sig[2], s.sig[1], s.sig[3],
                       s.sig[4], s.sig[2], s.sig[4], s.sig[5]};
  float ws[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      ws[3 * a + b] =
          sum3(k.r[3 * a] * sg[b], k.r[3 * a + 1] * sg[3 + b], k.r[3 * a + 2] * sg[6 + b]);
    }
  }
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int a = A[e], b = B[e];
    s.v[e] = sum3(ws[3 * a] * k.r[3 * b], ws[3 * a + 1] * k.r[3 * b + 1],
                  ws[3 * a + 2] * k.r[3 * b + 2]);
  }

  s.vx = s.px / s.safe_tz;
  s.vy = s.py / s.safe_tz;
  s.txtz = clampf(s.vx, -k.limx, k.limx);
  s.tytz = clampf(s.vy, -k.limy, k.limy);
  s.tx = s.txtz * s.safe_tz;
  s.ty = s.tytz * s.safe_tz;
  s.inv_z = 1.0f / s.safe_tz;
  s.inv_z2 = s.inv_z * s.inv_z;
  s.j00 = k.fx * s.inv_z;
  s.j02 = -k.fx * s.tx * s.inv_z2;
  s.j11 = k.fy * s.inv_z;
  s.j12 = -k.fy * s.ty * s.inv_z2;
  const float v00 = s.v[0], v01 = s.v[1], v02 = s.v[2], v11 = s.v[3], v12 = s.v[4],
              v22 = s.v[5];
  s.c00 = s.j00 * (s.j00 * v00 + s.j02 * v02) + s.j02 * (s.j00 * v02 + s.j02 * v22) + 0.3f;
  s.c01 = s.j11 * (s.j00 * v01 + s.j02 * v12) + s.j12 * (s.j00 * v02 + s.j02 * v22);
  s.c11 = s.j11 * (s.j11 * v11 + s.j12 * v12) + s.j12 * (s.j11 * v12 + s.j12 * v22) + 0.3f;
  s.det = s.c00 * s.c11 - s.c01 * s.c01;
  s.det_ok = s.det != 0.0f;
  s.inv_det = 1.0f / (s.det_ok ? s.det : 1.0f);
}

// C-style truncation of a float to int64, clamped to [0, hi].
__device__ __forceinline__ long long tile_edge(float v, int hi) {
  const long long t = (long long)v;
  return t < 0 ? 0 : (t > hi ? hi : t);
}

__global__ void __launch_bounds__(PROJ_THREADS)
    project_fwd_kernel(int n, ProjConsts k, const float* __restrict__ means,
                       const float* __restrict__ quats, const float* __restrict__ logit_op,
                       const float* __restrict__ log_scales, int scale_cols,
                       const bool* __restrict__ active, float* __restrict__ xy,
                       float* __restrict__ depth, float* __restrict__ conic,
                       float* __restrict__ opacity, int* __restrict__ radius,
                       long long* __restrict__ rect_min, long long* __restrict__ rect_wh,
                       bool* __restrict__ visible) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ProjState s;
  project_state(k, means, quats, log_scales, scale_cols, i, s);
  const float x_ndc = (k.ax * s.px - k.bx * s.safe_tz) * s.p_w;
  const float y_ndc = (k.ay * s.py - k.by * s.safe_tz) * s.p_w;
  const float pix_x = ((x_ndc + 1.0f) * k.width - 1.0f) * 0.5f;
  const float pix_y = ((y_ndc + 1.0f) * k.height - 1.0f) * 0.5f;

  const float mid = 0.5f * (s.c00 + s.c11);
  const float disc = sqrtf(clampf(mid * mid - s.det, 0.1f, INFINITY));
  const float lambda1 = mid + disc;
  const int rad = (int)ceilf(3.0f * sqrtf(nan_max(lambda1, mid - disc)));

  const float op = 1.0f / (1.0f + expf(-logit_op[i]));
  float cut = clampf(2.0f * logf(255.0f * clampf(op, 1e-12f, INFINITY)), -INFINITY, 9.0f);
  cut = clampf(cut, 0.0f, INFINITY);
  const float rx = ceilf(sqrtf(cut * clampf(s.c00, 0.0f, INFINITY)));
  const float ry = ceilf(sqrtf(cut * clampf(s.c11, 0.0f, INFINITY)));
  const long long rmin_x = tile_edge((pix_x - rx) / float(TILE), k.grid_x);
  const long long rmin_y = tile_edge((pix_y - ry) / float(TILE), k.grid_y);
  const long long rmax_x = tile_edge((pix_x + rx + float(TILE) - 1.0f) / float(TILE), k.grid_x);
  const long long rmax_y = tile_edge((pix_y + ry + float(TILE) - 1.0f) / float(TILE), k.grid_y);
  const long long rect_w = rmax_x - rmin_x > 0 ? rmax_x - rmin_x : 0;
  const long long rect_h = rmax_y - rmin_y > 0 ? rmax_y - rmin_y : 0;
  const bool vis = active[i] && s.in_front && s.det_ok && rect_w * rect_h > 0;

  xy[2 * i] = pix_x;
  xy[2 * i + 1] = pix_y;
  depth[i] = s.tz;
  conic[3 * i] = s.c11 * s.inv_det;
  conic[3 * i + 1] = -s.c01 * s.inv_det;
  conic[3 * i + 2] = s.c00 * s.inv_det;
  opacity[i] = op;
  radius[i] = vis ? rad : 0;
  rect_min[2 * i] = rmin_x;
  rect_min[2 * i + 1] = rmin_y;
  rect_wh[2 * i] = rect_w;
  rect_wh[2 * i + 1] = rect_h;
  visible[i] = vis;
}

// A cotangent: null (zero), or elements at (row, col) strides.
struct Cot {
  const float* p;
  int s0, s1;
  __device__ __forceinline__ float at(int i, int c) const {
    return p == nullptr ? 0.0f : p[(long long)i * s0 + (long long)c * s1];
  }
};

__global__ void __launch_bounds__(PROJ_THREADS)
    project_bwd_kernel(int n, ProjConsts k, const float* __restrict__ means,
                       const float* __restrict__ quats, const float* __restrict__ logit_op,
                       const float* __restrict__ log_scales, int scale_cols, Cot g_xy,
                       Cot g_depth, Cot g_conic, Cot g_op, float* __restrict__ d_means,
                       float* __restrict__ d_quats, float* __restrict__ d_logit,
                       float* __restrict__ d_log_scales) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (d_logit != nullptr) {
    const float op = 1.0f / (1.0f + expf(-logit_op[i]));
    d_logit[i] = g_op.at(i, 0) * (1.0f - op) * op;
  }
  if (d_means == nullptr && d_quats == nullptr && d_log_scales == nullptr) return;
  ProjState s;
  project_state(k, means, quats, log_scales, scale_cols, i, s);
  const float v00 = s.v[0], v01 = s.v[1], v02 = s.v[2], v11 = s.v[3], v12 = s.v[4],
              v22 = s.v[5];
  const float j00 = s.j00, j02 = s.j02, j11 = s.j11, j12 = s.j12;

  // conic = (c11, -c01, c00) * inv_det, inv_det = 1 / where(det_ok, det, 1)
  const float ga = g_conic.at(i, 0), gb = g_conic.at(i, 1), gc = g_conic.at(i, 2);
  float dc11 = ga * s.inv_det, dc01 = -(gb * s.inv_det), dc00 = gc * s.inv_det;
  const float d_inv = ga * s.c11 + gb * -s.c01 + gc * s.c00;
  const float d_det = s.det_ok ? -d_inv * s.inv_det * s.inv_det : 0.0f;
  dc00 += d_det * s.c11;
  dc11 += d_det * s.c00;
  dc01 += -2.0f * d_det * s.c01;

  // c00 = j00 A0 + j02 B0, c01 = j11 A1 + j12 B0, c11 = j11 A2 + j12 B2
  const float A0 = j00 * v00 + j02 * v02, B0 = j00 * v02 + j02 * v22;
  const float A1 = j00 * v01 + j02 * v12;
  const float A2 = j11 * v11 + j12 * v12, B2 = j11 * v12 + j12 * v22;
  float dj00 = dc00 * A0, dj02 = dc00 * B0;
  float dj11 = dc01 * A1 + dc11 * A2, dj12 = dc01 * B0 + dc11 * B2;
  const float dA0 = dc00 * j00, dB0 = dc00 * j02 + dc01 * j12, dA1 = dc01 * j11;
  const float dA2 = dc11 * j11, dB2 = dc11 * j12;
  dj00 += dA0 * v00 + dB0 * v02 + dA1 * v01;
  dj02 += dA0 * v02 + dB0 * v22 + dA1 * v12;
  dj11 += dA2 * v11 + dB2 * v12;
  dj12 += dA2 * v12 + dB2 * v22;

  if (d_means != nullptr) {
    // j00 = fx inv_z, j02 = -fx tx inv_z2 (and y), inv_z2 = inv_z^2, inv_z = 1 / safe_tz
    const float dtx = dj02 * s.inv_z2 * -k.fx, dty = dj12 * s.inv_z2 * -k.fy;
    const float dinv_z2 = dj02 * (-k.fx * s.tx) + dj12 * (-k.fy * s.ty);
    const float dinv_z = dj00 * k.fx + dj11 * k.fy + 2.0f * dinv_z2 * s.inv_z;
    float dsafe = -dinv_z * s.inv_z * s.inv_z + dtx * s.txtz + dty * s.tytz;
    // tx = clamp(px / safe_tz) safe_tz: the clamp passes its closed interval
    const float dvx = (s.vx >= -k.limx && s.vx <= k.limx) ? dtx * s.safe_tz : 0.0f;
    const float dvy = (s.vy >= -k.limy && s.vy <= k.limy) ? dty * s.safe_tz : 0.0f;
    float dpx = dvx / s.safe_tz, dpy = dvy / s.safe_tz;
    dsafe += -dvx * s.px / (s.safe_tz * s.safe_tz) - dvy * s.py / (s.safe_tz * s.safe_tz);
    // pix = ((ndc + 1) W - 1) / 2, ndc = (a p - b safe_tz) p_w, p_w = 1 / (safe_tz + 1e-7)
    const float dxn = g_xy.at(i, 0) * 0.5f * k.width, dyn = g_xy.at(i, 1) * 0.5f * k.height;
    dpx += dxn * s.p_w * k.ax;
    dpy += dyn * s.p_w * k.ay;
    const float dp_w = dxn * (k.ax * s.px - k.bx * s.safe_tz) +
                       dyn * (k.ay * s.py - k.by * s.safe_tz);
    dsafe += -(dxn * s.p_w * k.bx) - dyn * s.p_w * k.by - dp_w * s.p_w * s.p_w;
    const float dtz = g_depth.at(i, 0) + (s.in_front ? dsafe : 0.0f);
    // p = W m + t
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      d_means[3 * i + c] = k.r[c] * dpx + k.r[3 + c] * dpy + k.r[6 + c] * dtz;
    }
  }
  if (d_quats == nullptr && d_log_scales == nullptr) return;

  // dv (upper triangle of W Sigma W^T) -> dSigma = W^T D W, D upper-triangular
  const float D[9] = {dA0 * j00, dA1 * j00, dA0 * j02 + dB0 * j00,
                      0.0f,      dA2 * j11, dA1 * j02 + dA2 * j12 + dB2 * j11,
                      0.0f,      0.0f,      dB0 * j02 + dB2 * j12};
  float dw[9];  // D W
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      dw[3 * a + b] = D[3 * a] * k.r[b] + D[3 * a + 1] * k.r[3 + b] + D[3 * a + 2] * k.r[6 + b];
    }
  }
  float G[9];  // W^T (D W)
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      G[3 * a + b] = k.r[a] * dw[b] + k.r[3 + a] * dw[3 + b] + k.r[6 + a] * dw[6 + b];
    }
  }
  // Sigma's six components, each off-diagonal one read at two places
  const float ds[6] = {G[0], G[1] + G[3], G[2] + G[6], G[4], G[5] + G[7], G[8]};
  const int A[6] = {0, 0, 0, 1, 1, 2}, B[6] = {0, 1, 2, 1, 2, 2};
  float dR[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, dS[3] = {0, 0, 0};
  const float* R = s.rq;
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    const int a = A[e], b = B[e];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g = ds[e] * s.ss[c];
      dR[3 * a + c] += g * R[3 * b + c];
      dR[3 * b + c] += g * R[3 * a + c];
      dS[c] += ds[e] * R[3 * a + c] * R[3 * b + c];
    }
  }
  if (d_log_scales != nullptr) {
    // S = exp(l)^2: dl = 2 sc dS sc; an [N, 1] column sums the three axes
    float dl[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) dl[c] = 2.0f * s.sc[c] * dS[c] * s.sc[c];
    if (scale_cols == 1) {
      d_log_scales[i] = (dl[0] + dl[1]) + dl[2];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) d_log_scales[3 * i + c] = dl[c];
    }
  }
  if (d_quats == nullptr) return;
  const float r = s.q[0], x = s.q[1], y = s.q[2], z = s.q[3];
  // R(q) of _cov3d_components
  const float dr = 2.0f * (-z * dR[1] + y * dR[2] + z * dR[3] - x * dR[5] - y * dR[6] +
                           x * dR[7]);
  const float dx = 2.0f * (y * dR[1] + z * dR[2] + y * dR[3] - 2.0f * x * dR[4] - r * dR[5] +
                           z * dR[6] + r * dR[7] - 2.0f * x * dR[8]);
  const float dy = 2.0f * (-2.0f * y * dR[0] + x * dR[1] + r * dR[2] + x * dR[3] + z * dR[5] -
                           r * dR[6] + z * dR[7] - 2.0f * y * dR[8]);
  const float dz = 2.0f * (-2.0f * z * dR[0] - r * dR[1] + x * dR[2] + r * dR[3] -
                           2.0f * z * dR[4] + y * dR[5] + x * dR[6] + y * dR[7]);
  const float dq[4] = {dr, dx, dy, dz};
  // q = q1 / |q1|; q1 = u / max(|u|, 1e-12)
  float dot2 = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) dot2 += dq[c] * s.q1[c];
  const float dn2 = -dot2 / (s.n2 * s.n2);
  float dq1[4], dot1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    dq1[c] = dq[c] / s.n2 + (s.n2 != 0.0f ? s.q1[c] * (dn2 / s.n2) : 0.0f);
    dot1 += dq1[c] * s.u[c];
  }
  const float dc1 = -dot1 / (s.c1 * s.c1);
  const float dn1 = s.n1 >= 1e-12f ? dc1 : 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    d_quats[4 * i + c] = dq1[c] / s.c1 + (s.n1 != 0.0f ? s.u[c] * (dn1 / s.n1) : 0.0f);
  }
}

inline int blocks_for(int n) { return (n + PROJ_THREADS - 1) / PROJ_THREADS; }

inline ProjConsts load_consts(const float* c) {
  ProjConsts k;
  for (int e = 0; e < 9; ++e) k.r[e] = c[e];
  for (int e = 0; e < 3; ++e) k.t[e] = c[9 + e];
  k.fx = c[12]; k.fy = c[13];
  k.ax = c[14]; k.bx = c[15]; k.ay = c[16]; k.by = c[17];
  k.limx = c[18]; k.limy = c[19];
  k.width = c[20]; k.height = c[21];
  k.grid_x = int(c[22]); k.grid_y = int(c[23]);
  return k;
}

}  // namespace splatam

// The projection of n Gaussians. consts: PROJ_CONSTS host floats in
// ProjConsts' order (the grid as whole numbers); log_scales [n, scale_cols].
extern "C" int project_forward(int n, const float* consts, const float* means,
                               const float* quats, const float* logit_op,
                               const float* log_scales, int scale_cols, const bool* active,
                               float* xy, float* depth, float* conic, float* opacity, int* radius,
                               long long* rect_min, long long* rect_wh, bool* visible,
                               void* stream) {
  using namespace splatam;
  if (n > 0) {
    project_fwd_kernel<<<blocks_for(n), PROJ_THREADS, 0, (cudaStream_t)stream>>>(
        n, load_consts(consts), means, quats, logit_op, log_scales, scale_cols, active, xy, depth,
        conic, opacity, radius, rect_min, rect_wh, visible);
  }
  return (int)cudaGetLastError();
}

// Its gradient: each cotangent a pointer (null: zero) with its row and column
// strides in elements; each output null where autograd asks for none.
extern "C" int project_backward(int n, const float* consts, const float* means,
                                const float* quats, const float* logit_op,
                                const float* log_scales, int scale_cols, const float* g_xy,
                                int gxy_s0, int gxy_s1, const float* g_depth, int gd_s0,
                                const float* g_conic, int gc_s0, int gc_s1, const float* g_op,
                                int go_s0,
                                float* d_means, float* d_quats, float* d_logit,
                                float* d_log_scales, void* stream) {
  using namespace splatam;
  if (n > 0) {
    project_bwd_kernel<<<blocks_for(n), PROJ_THREADS, 0, (cudaStream_t)stream>>>(
        n, load_consts(consts), means, quats, logit_op, log_scales, scale_cols,
        Cot{g_xy, gxy_s0, gxy_s1}, Cot{g_depth, gd_s0, 0}, Cot{g_conic, gc_s0, gc_s1},
        Cot{g_op, go_s0, 0}, d_means, d_quats, d_logit, d_log_scales);
  }
  return (int)cudaGetLastError();
}

// What the compiler gave the forward (backward 0) or backward (1) kernel.
extern "C" int project_info(int backward, int* regs, int* local_bytes, int* blocks_per_sm) {
  const void* fn = backward ? (const void*)splatam::project_bwd_kernel
                            : (const void*)splatam::project_fwd_kernel;
  return splatam::kernel_info(fn, splatam::PROJ_THREADS, regs, local_bytes, blocks_per_sm);
}
