// get_loss's loss after the render, and its gradient, in closed form.
//
// Replaces no TPU kernel: the JAX package leaves the loss to XLA, which
// fuses it into the jitted phase (splatam_tpu/slam/steps.py get_loss). In
// the eager port the same loss was some 85 PyTorch launches an iteration,
// forward and backward (masks, products, ten depthwise convolutions for
// SSIM), whose intermediates autograd held until the render's backward
// (~130 MB at 1200x680 in mapping). This kernel
// computes, per the phase's route (slam/steps.py get_loss):
//   tracking: w_depth * sum |gt - d| m + w_im * sum |c - im| (m or 1)
//   mapping:  w_depth * sum |gt - d| m / max(sum m, 1)
//             + w_im * (0.8 mean |im - c| + 0.2 (1 - SSIM(im, c)))
// with m = valid & ~isnan(d) & ~isnan(d2 - d^2) [& d_err < thresh]
// [& sil > sil_thres] [& var_norm < unc^2], and writes the gradient with
// respect to the rendered image and depth in the same pass: the three
// image planes final, the depth plane as -sign(gt - d) m, which the
// backward scales by the reduction's w_depth (tracking) or
// w_depth / max(sum m, 1) (mapping), read on the device.
//
// SSIM (11 taps, sigma 1.5, zero padding as conv2d(padding=5), c1 = 1e-4,
// c2 = 9e-4) from the five blurred moments m1 = b(x), m2 = b(y), m11 =
// b(x^2), m22 = b(y^2), m12 = b(xy) of x = im, y = c. Its gradient is
//   dL/dx = b(A) + 2 x b(B) + y b(C),
//   A = k dS/dm1, B = k dS/dm11 = -k S / B2, C = k dS/dm12 = 2 k A1 / (B1 B2),
// k = -0.2 w_im / (3 H W), with b^T = b (the window is symmetric and the
// padding zero, so A, B and C are zero outside the image). A block takes
// one 32x16 tile of one channel plus a 10-pixel halo of x and y into
// shared memory, blurs the moments over the tile plus a 5-pixel halo
// (vertical, then horizontal), forms A, B and C there, blurs them back
// over the tile and adds the L1 term. The halo is recomputed by each
// block, never stored.
//
// What bounds it on an H100: the bytes, at 1200x680 ten input planes read
// and four gradient planes written (45.7 MB, 13.6 us at 3.35 TB/s); the
// blurs (8 blurs of 22 multiply-adds a pixel and channel, 0.86 GFLOP,
// 12.9 us at 67 TFLOP/s) come close. The design keeps every intermediate
// in shared memory (42 KB a block: two planes of the input region, aliased
// by A, B and C; five of the vertical moments, aliased by the back-blur),
// so nothing but the four gradient planes and the block partials reaches
// device memory. PERF.md section 6 has the times against the bound; the
// mapping tiles' time over it is not split yet (the likely parts: the
// blurs' shared-memory reads, which the halo about doubles, and four
// barriers at 5 blocks a SM).
//
// Sums are fixed-order: each block reduces its pixels by warp shuffles in
// lane order and writes four partials (depth term, mask count, image term,
// SSIM); loss_reduce_kernel adds the partials in a fixed order in double.
// No float atomics: a loss is the same bit for bit from run to run.
#include "common.cuh"

namespace splatam {

constexpr int LT_W = 32;   // output tile width
constexpr int LT_H = 16;   // output tile height
constexpr int LOSS_THREADS = 256;
constexpr int LOSS_PARTS = 4;  // partials a block writes
constexpr int WIN_R = 5;       // window radius (11 taps)
constexpr int IN_W = LT_W + 4 * WIN_R;   // x, y: the tile and a 10-pixel halo
constexpr int IN_H = LT_H + 4 * WIN_R;
constexpr int MID_W = LT_W + 2 * WIN_R;  // moments, A, B, C: a 5-pixel halo
constexpr int MID_H = LT_H + 2 * WIN_R;
constexpr int RED_THREADS = 256;
constexpr float SSIM_C1 = 0.01f * 0.01f;
constexpr float SSIM_C2 = 0.03f * 0.03f;

// core/losses.py _gaussian_window(11, 1.5) in float32.
__constant__ float WIN[2 * WIN_R + 1] = {
    0.0010283801f, 0.007598758f, 0.036000773f, 0.10936069f, 0.21300554f, 0.26601171f,
    0.21300554f,   0.10936069f,  0.036000773f, 0.007598758f, 0.0010283801f};

// The shared memory of a mapping block, in two regions that later stages
// alias: (x, y) then (A, B, C); the vertical moments then the back-blur.
constexpr int REGION_IN = 2 * IN_H * IN_W;
constexpr int REGION_V = 5 * MID_H * IN_W;
static_assert(3 * MID_H * MID_W <= REGION_IN, "A, B, C must fit over x, y");
static_assert(3 * LT_H * MID_W <= REGION_V, "the back-blur must fit over the moments");

struct LossArgs {
  const float* im;        // [3, H, W] contiguous
  const float* depth;     // [H, W] contiguous
  const float* depth_sq;  // [H, W] contiguous
  const float* sil;       // [H, W] contiguous
  const float* color;     // [3, H, W] at strides (c_sc, c_sy, c_sx)
  const float* depth_gt;  // [H, W] at strides (g_sy, g_sx)
  const float* thresh;    // outlier threshold on the device; null: no outlier test
  int c_sc, c_sy, c_sx, g_sy, g_sx;
  int h, w;
  int use_sil, use_unc, masked_im;
  float sil_thres, unc_thres_sq, w_im;
  float* grad;      // [4, H, W]: d/d im (3 planes), -sign(gt - d) m
  float* partials;  // [blocks, LOSS_PARTS]
};

// torch.sign: 0 for 0 and NaN.
__device__ __forceinline__ float sgn(float v) { return float(0.0f < v) - float(v < 0.0f); }

// get_loss's depth mask at one pixel, as 1 or 0.
__device__ __forceinline__ float pixel_mask(const LossArgs& a, float d, float d2, float sil,
                                            float gt) {
  const float valid = gt > 0.0f ? 1.0f : 0.0f;
  bool m = valid != 0.0f;
  if (a.thresh != nullptr) m = (fabsf(gt - d) * valid < *a.thresh) && m;
  const float unc = d2 - d * d;
  m = m && !isnan(d) && !isnan(unc);
  if (a.use_sil) m = m && (sil > a.sil_thres);
  if (a.use_unc) {
    const float s = sil < 1e-6f ? 1e-6f : sil;  // torch.clamp(min=1e-6): NaN stays NaN
    const float ds = d / s;
    m = m && (d2 / s - ds * ds < a.unc_thres_sq);
  }
  return m ? 1.0f : 0.0f;
}

// The depth term at pixel (px, py): adds |gt - d| m and m to acc, writes
// the depth plane's unit gradient; returns m.
__device__ __forceinline__ float depth_term(const LossArgs& a, int px, int py, float* acc) {
  const size_t p = size_t(py) * a.w + px;
  const float d = a.depth[p];
  const float gt = a.depth_gt[size_t(py) * a.g_sy + size_t(px) * a.g_sx];
  const float m = pixel_mask(a, d, a.depth_sq[p], a.sil[p], gt);
  const float e = gt - d;
  acc[0] += fabsf(e) * m;
  acc[1] += m;
  a.grad[size_t(3) * a.h * a.w + p] = -(sgn(e) * m);
  return m;
}

__device__ __forceinline__ float color_at(const LossArgs& a, int c, int px, int py) {
  return a.color[size_t(c) * a.c_sc + size_t(py) * a.c_sy + size_t(px) * a.c_sx];
}

// Sums acc[0..3] over the block in a fixed order and writes them to out.
__device__ __forceinline__ void block_partials(float* acc, float* out) {
  __shared__ float red[LOSS_THREADS / 32][LOSS_PARTS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < LOSS_PARTS; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < LOSS_PARTS) {
    float s = 0.0f;
    for (int i = 0; i < LOSS_THREADS / 32; ++i) s += red[i][threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// Tracking: per pixel, the depth term and the L1 image term (masked or not).
__global__ void __launch_bounds__(LOSS_THREADS) loss_track_tile_kernel(LossArgs a) {
  const int x0 = blockIdx.x * LT_W, y0 = blockIdx.y * LT_H;
  const size_t hw = size_t(a.h) * a.w;
  float acc[LOSS_PARTS] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < LT_W * LT_H; i += LOSS_THREADS) {
    const int px = x0 + i % LT_W, py = y0 + i / LT_W;
    if (px >= a.w || py >= a.h) continue;
    const float m = depth_term(a, px, py, acc);
    const float mi = a.masked_im ? m : 1.0f;
    const float gi = a.w_im * mi;
    const size_t p = size_t(py) * a.w + px;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float e = color_at(a, c, px, py) - a.im[c * hw + p];
      acc[2] += fabsf(e) * mi;
      a.grad[c * hw + p] = -(sgn(e) * gi);
    }
  }
  block_partials(acc, a.partials + size_t(blockIdx.y * gridDim.x + blockIdx.x) * LOSS_PARTS);
}

// Mapping: block (bx, by, c) takes channel c of one tile; the c == 0 blocks
// also take the tile's depth term.
__global__ void __launch_bounds__(LOSS_THREADS) loss_map_tile_kernel(LossArgs a) {
  __shared__ float s_in[REGION_IN];  // x, y; then A, B, C
  __shared__ float s_v[REGION_V];    // the vertical moments; then the back-blur
  const int x0 = blockIdx.x * LT_W, y0 = blockIdx.y * LT_H, c = blockIdx.z;
  const size_t hw = size_t(a.h) * a.w;
  const float n = float(3 * hw);
  const float l1k = (a.w_im * 0.8f) / n;
  const float k = -((a.w_im * 0.2f) / n);
  float* xs = s_in;
  float* ys = s_in + IN_H * IN_W;
  float acc[LOSS_PARTS] = {0.0f, 0.0f, 0.0f, 0.0f};

  // x and y over the tile and a 10-pixel halo, zero outside the image.
  for (int i = threadIdx.x; i < IN_H * IN_W; i += LOSS_THREADS) {
    const int px = x0 - 2 * WIN_R + i % IN_W, py = y0 - 2 * WIN_R + i / IN_W;
    float xv = 0.0f, yv = 0.0f;
    if (px >= 0 && px < a.w && py >= 0 && py < a.h) {
      xv = a.im[c * hw + size_t(py) * a.w + px];
      yv = color_at(a, c, px, py);
    }
    xs[i] = xv;
    ys[i] = yv;
  }
  if (c == 0) {
    for (int i = threadIdx.x; i < LT_W * LT_H; i += LOSS_THREADS) {
      const int px = x0 + i % LT_W, py = y0 + i / LT_W;
      if (px < a.w && py < a.h) depth_term(a, px, py, acc);
    }
  }
  __syncthreads();

  // Each thread's output pixels: rows of 32, one warp a row.
  constexpr int PER = LT_W * LT_H / LOSS_THREADS;
  float xo[PER], yo[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * LOSS_THREADS;
    const int r = i / LT_W + 2 * WIN_R, col = i % LT_W + 2 * WIN_R;
    xo[j] = xs[r * IN_W + col];
    yo[j] = ys[r * IN_W + col];
  }

  // Vertical blur of x, y, x^2, y^2, xy over the moment rows, every column.
  for (int i = threadIdx.x; i < MID_H * IN_W; i += LOSS_THREADS) {
    const int r = i / IN_W, col = i % IN_W;
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f, v4 = 0.0f;
#pragma unroll
    for (int t = 0; t <= 2 * WIN_R; ++t) {
      const float x = xs[(r + t) * IN_W + col], y = ys[(r + t) * IN_W + col];
      const float wt = WIN[t];
      v0 = fmaf(wt, x, v0);
      v1 = fmaf(wt, y, v1);
      v2 = fmaf(wt, x * x, v2);
      v3 = fmaf(wt, y * y, v3);
      v4 = fmaf(wt, x * y, v4);
    }
    s_v[0 * MID_H * IN_W + i] = v0;
    s_v[1 * MID_H * IN_W + i] = v1;
    s_v[2 * MID_H * IN_W + i] = v2;
    s_v[3 * MID_H * IN_W + i] = v3;
    s_v[4 * MID_H * IN_W + i] = v4;
  }
  __syncthreads();

  // Horizontal blur, SSIM and A, B, C over the tile and a 5-pixel halo (x
  // and y are dead now: A, B, C take their place).
  float* abc = s_in;
  for (int i = threadIdx.x; i < MID_H * MID_W; i += LOSS_THREADS) {
    const int r = i / MID_W, col = i % MID_W;
    const int px = x0 - WIN_R + col, py = y0 - WIN_R + r;
    float ga = 0.0f, gb = 0.0f, gc = 0.0f;
    if (px >= 0 && px < a.w && py >= 0 && py < a.h) {
      float m[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t <= 2 * WIN_R; ++t) {
        const float wt = WIN[t];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          m[q] = fmaf(wt, s_v[q * MID_H * IN_W + r * IN_W + col + t], m[q]);
        }
      }
      const float mu1 = m[0], mu2 = m[1];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
      const float s1 = m[2] - mu1_sq, s2 = m[3] - mu2_sq, s12 = m[4] - mu1_mu2;
      const float a1 = 2.0f * mu1_mu2 + SSIM_C1, a2 = 2.0f * s12 + SSIM_C2;
      const float b1 = mu1_sq + mu2_sq + SSIM_C1, b2 = s1 + s2 + SSIM_C2;
      const float den = b1 * b2;
      const float s = (a1 * a2) / den;
      if (r >= WIN_R && r < WIN_R + LT_H && col >= WIN_R && col < WIN_R + LT_W) acc[3] += s;
      // dS/dm1 = 2 (m2 (A2 - A1) - m1 S (B2 - B1)) / (B1 B2)
      ga = k * (2.0f * (mu2 * (a2 - a1) - mu1 * s * (b2 - b1)) / den);
      gb = k * (-s / b2);
      gc = k * (2.0f * a1 / den);
    }
    abc[0 * MID_H * MID_W + i] = ga;
    abc[1 * MID_H * MID_W + i] = gb;
    abc[2 * MID_H * MID_W + i] = gc;
  }
  __syncthreads();

  // Vertical back-blur of A, B, C over the tile rows (the moments are dead).
  float* vb = s_v;
  for (int i = threadIdx.x; i < LT_H * MID_W; i += LOSS_THREADS) {
    const int r = i / MID_W, col = i % MID_W;
    float u[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t <= 2 * WIN_R; ++t) {
      const float wt = WIN[t];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        u[q] = fmaf(wt, abc[q * MID_H * MID_W + (r + t) * MID_W + col], u[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) vb[q * LT_H * MID_W + i] = u[q];
  }
  __syncthreads();

  // Horizontal back-blur; the gradient and the L1 term at each output pixel.
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * LOSS_THREADS;
    const int r = i / LT_W, col = i % LT_W;
    const int px = x0 + col, py = y0 + r;
    if (px >= a.w || py >= a.h) continue;
    float u[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t <= 2 * WIN_R; ++t) {
      const float wt = WIN[t];
#pragma unroll
      for (int q = 0; q < 3; ++q) u[q] = fmaf(wt, vb[q * LT_H * MID_W + r * MID_W + col + t], u[q]);
    }
    const float e = xo[j] - yo[j];
    acc[2] += fabsf(e);
    a.grad[c * hw + size_t(py) * a.w + px] =
        u[0] + 2.0f * xo[j] * u[1] + yo[j] * u[2] + l1k * sgn(e);
  }
  block_partials(
      acc, a.partials + size_t((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                            LOSS_PARTS);
}

// The loss from the blocks' partials, in a fixed order: res = (loss,
// w_depth * depth loss, w_im * image loss, mask count) and the backward's
// scales of the gradient planes, gscale = (1, 1, 1, the depth plane's).
__global__ void __launch_bounds__(RED_THREADS)
    loss_reduce_kernel(const float* __restrict__ partials, int blocks, int mapping, float n,
                       float w_im, float w_depth, float* __restrict__ res,
                       float* __restrict__ gscale) {
  __shared__ double red[RED_THREADS][LOSS_PARTS];
  double s[LOSS_PARTS] = {0.0, 0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < blocks; b += RED_THREADS) {
#pragma unroll
    for (int k = 0; k < LOSS_PARTS; ++k) s[k] += partials[size_t(b) * LOSS_PARTS + k];
  }
#pragma unroll
  for (int k = 0; k < LOSS_PARTS; ++k) red[threadIdx.x][k] = s[k];
  __syncthreads();
  for (int half = RED_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int k = 0; k < LOSS_PARTS; ++k) red[threadIdx.x][k] += red[threadIdx.x + half][k];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float dsum = float(red[0][0]), cnt = float(red[0][1]);
  const float isum = float(red[0][2]), ssum = float(red[0][3]);
  float depth_loss, im_loss, dscale;
  if (mapping) {
    const float c = cnt < 1.0f ? 1.0f : cnt;
    depth_loss = dsum / c;
    im_loss = 0.8f * (isum / n) + 0.2f * (1.0f - ssum / n);
    dscale = w_depth / c;
  } else {
    depth_loss = dsum;
    im_loss = isum;
    dscale = w_depth;
  }
  const float wd = w_depth * depth_loss, wi = w_im * im_loss;
  res[0] = wd + wi;
  res[1] = wd;
  res[2] = wi;
  res[3] = cnt;
  gscale[0] = gscale[1] = gscale[2] = 1.0f;
  gscale[3] = dscale;
}

inline dim3 loss_grid(int mapping, int h, int w) {
  return dim3((w + LT_W - 1) / LT_W, (h + LT_H - 1) / LT_H, mapping ? 3 : 1);
}

}  // namespace splatam

// The loss and its gradient planes in two launches (the tiles, then the
// reduction). partials holds n_partials floats, at least LOSS_PARTS per
// block of the grid; res and gscale 4 floats each.
extern "C" int loss_forward(int mapping, const float* im, const float* depth,
                            const float* depth_sq, const float* sil, const float* color,
                            int c_sc, int c_sy, int c_sx, const float* depth_gt, int g_sy,
                            int g_sx, const float* thresh, int h, int w, int use_sil, int use_unc,
                            int masked_im, float sil_thres, float unc_thres_sq, float w_im,
                            float w_depth, float* grad, float* partials, int n_partials,
                            float* res, float* gscale, void* stream) {
  using namespace splatam;
  const dim3 grid = loss_grid(mapping, h, w);
  const int blocks = int(grid.x * grid.y * grid.z);
  if (h <= 0 || w <= 0 || n_partials < blocks * LOSS_PARTS) return (int)cudaErrorInvalidValue;
  LossArgs a{im, depth, depth_sq, sil, color, depth_gt, thresh, c_sc, c_sy, c_sx, g_sy, g_sx,
             h, w, use_sil, use_unc, masked_im, sil_thres, unc_thres_sq, w_im, grad, partials};
  cudaStream_t s = (cudaStream_t)stream;
  if (mapping) {
    loss_map_tile_kernel<<<grid, LOSS_THREADS, 0, s>>>(a);
  } else {
    loss_track_tile_kernel<<<grid, LOSS_THREADS, 0, s>>>(a);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  loss_reduce_kernel<<<1, RED_THREADS, 0, s>>>(partials, blocks, mapping, 3.0f * h * w, w_im,
                                               w_depth, res, gscale);
  return (int)cudaGetLastError();
}

// What the compiler gave the tile kernel of a route (mapping 1, tracking 0):
// registers and local (spill) bytes per thread, and resident blocks per SM.
extern "C" int loss_info(int mapping, int* regs, int* local_bytes, int* blocks_per_sm) {
  const void* fn = mapping ? (const void*)splatam::loss_map_tile_kernel
                           : (const void*)splatam::loss_track_tile_kernel;
  return splatam::kernel_info(fn, splatam::LOSS_THREADS, regs, local_bytes, blocks_per_sm);
}
