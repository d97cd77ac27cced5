// K5: fused isotropic backward.
//
// Replaces fused_backward_pallas / _fused_bwd_kernel
// (splatam_tpu/render/pallas/fused_iso.py:339-662). Each pixel walks its
// tile's pairs back to front from its n_contrib, keeping renderCUDA's suffix
// accumulators (the silhouette is a constant-1 channel whose cotangent joins
// the per-pixel sum), recomputes the projection and alpha of every pair, and
// the per-pair gradient is chained through the in-kernel projection to the
// pair's world row: mean xyz, s^2, opacity, rgb ([P, 8]). The rows come per
// sorted pair or, as K4 takes them, per Gaussian through pair_gauss; the
// gradients are per sorted pair in both modes.
//
// One block per 16x16 tile, one thread per pixel; pairs are staged BB at a
// time in shared memory, projected once per tile by one thread each. Each
// pair slot belongs to exactly one tile, so its gradient is a reduction inside
// the block, with no global atomics.
//
// What bounds it on an H100: the per-pixel reverse walk (each evaluation a
// dependent chain of expf, a division and six suffix updates, as in K4's
// forward walk) and the per-pair reduction of 11 screen-space terms over the
// tile's 256 pixels. A shuffle butterfly per column costs 11 x 5 = 55 warp
// shuffles for every (pair, warp) step in which a lane of the warp applied
// the pair (an SM retires one warp shuffle per clock), and a batch tail on one
// thread per pair leaves the rest of the block waiting. Design:
//   - reduce-scatter (halve and reduce_scatter16, common.cuh, the one copy K2
//     uses too): the 11 terms, padded to 16 slots, are summed over the warp by
//     recursive halving (8 + 4 + 2 + 1 shuffles, then one for the last lane
//     pair: 16 in all), leaving slot s's warp total in lanes 2s and 2s + 1; a
//     step no lane of the warp contributed to is skipped;
//   - the even lanes publish the 16 totals with one store, and each warp
//     keeps a bitmask of the batch's pairs it touched;
//   - the whole block merges the warp partials, one (pair, column) per
//     thread, reading only the touching warps, in warp order;
//   - the projection terms the chain reads are kept in shared memory from the
//     staging step, so the tail neither reloads the row nor projects again;
//     one thread per pair chains and stores;
//   - the pose lives in shared memory, not in every thread's registers.
// Every sum is taken in a fixed order, so two launches are equal bit for bit.
// Slots past the deepest n_contrib of the tile get zeros, so every slot is
// written.
#include "common.cuh"

namespace splatam {

// Pairs per staged batch: 64 halves the barriers of 32 (3-5% faster on an
// H100). Three resident blocks per SM: ptxas fits the kernel in 80
// registers with no spills; asking for four caps it at 64 and spills.
constexpr int BB = 64;
constexpr int MIN_BLOCKS = 3;
constexpr int NR = 11;  // screen grads per pair: dpix x/y, conic a/b/c, opacity, 5 channels
constexpr int NS = 16;  // NR padded to a power of two: the reduce-scatter's slots
constexpr int WARPS = PIX / 32;

// Chains screen-space sums through the isotropic projection to the world row
// (fused_iso.py:488-562, expression by expression).
__device__ __forceinline__ void chain_to_world(const ProjIso& q, const Pose& P, float width,
                                               float height, const float* s,
                                               float* __restrict__ d) {
  const float dpix_x = s[0], dpix_y = s[1], g_a = s[2], g_b = s[3], g_c = s[4];
  float d_c00 = g_c * q.inv_det;
  float d_c01 = -g_b * q.inv_det;
  float d_c11 = g_a * q.inv_det;
  const float d_invdet = g_a * q.c11 - g_b * q.c01 + g_c * q.c00;
  const float d_det = q.det_ok ? -d_invdet * q.inv_det * q.inv_det : 0.0f;
  d_c00 = d_c00 + d_det * q.c11;
  d_c11 = d_c11 + d_det * q.c00;
  d_c01 = d_c01 - 2.0f * q.c01 * d_det;

  const float j00 = q.j00, j02 = q.j02, j11 = q.j11, j12 = q.j12, s2 = q.s2;
  const float d_s2 = d_c00 * (j00 * j00 + j02 * j02) + d_c01 * (j02 * j12) +
                     d_c11 * (j11 * j11 + j12 * j12);
  const float d_j00 = 2.0f * s2 * j00 * d_c00;
  const float d_j02 = 2.0f * s2 * j02 * d_c00 + s2 * j12 * d_c01;
  const float d_j11 = 2.0f * s2 * j11 * d_c11;
  const float d_j12 = 2.0f * s2 * j12 * d_c11 + s2 * j02 * d_c01;

  float d_invz = P.fx * d_j00 + P.fy * d_j11;
  const float d_tx = -P.fx * q.inv_z2 * d_j02;
  const float d_ty = -P.fy * q.inv_z2 * d_j12;
  const float d_invz2 = -P.fx * q.tx * d_j02 - P.fy * q.ty * d_j12;
  d_invz = d_invz + 2.0f * q.inv_z * d_invz2;
  float d_stz = -q.inv_z * q.inv_z * d_invz;

  d_stz = d_stz + q.txtz * d_tx + q.tytz * d_ty;
  const bool inside_x = (q.vx >= -P.limx) && (q.vx <= P.limx);
  const bool inside_y = (q.vy >= -P.limy) && (q.vy <= P.limy);
  const float d_vx = inside_x ? q.safe_tz * d_tx : 0.0f;
  const float d_vy = inside_y ? q.safe_tz * d_ty : 0.0f;
  float d_px = d_vx * q.inv_z;
  float d_py = d_vy * q.inv_z;
  d_stz = d_stz - d_vx * q.vx * q.inv_z - d_vy * q.vy * q.inv_z;

  const float d_xndc = dpix_x * (0.5f * width);
  const float d_yndc = dpix_y * (0.5f * height);
  d_px = d_px + d_xndc * q.ax * q.p_w;
  d_py = d_py + d_yndc * q.ay * q.p_w;
  d_stz = d_stz - (d_xndc * q.bx + d_yndc * q.by) * q.p_w;
  const float d_pw = d_xndc * (q.ax * q.px - q.bx * q.safe_tz) +
                     d_yndc * (q.ay * q.py - q.by * q.safe_tz);
  d_stz = d_stz - d_pw * q.p_w * q.p_w;

  float d_tz = s[9] + 2.0f * q.tz * s[10];
  d_tz = d_tz + (q.in_front ? d_stz : 0.0f);

  const float* r = P.r;
  d[0] = r[0] * d_px + r[3] * d_py + r[6] * d_tz;
  d[1] = r[1] * d_px + r[4] * d_py + r[7] * d_tz;
  d[2] = r[2] * d_px + r[5] * d_py + r[8] * d_tz;
  d[3] = d_s2;
  d[4] = s[5];
  d[5] = s[6];
  d[6] = s[7];
  d[7] = s[8];
}

// Pair i's world row: row pair_gauss[i] of a per-Gaussian table, or, with a
// null pair_gauss, row i of per-pair rows.
__device__ __forceinline__ void load_row(const float* __restrict__ world8,
                                         const int* __restrict__ pair_gauss, int i, float* w) {
  const size_t r = pair_gauss != nullptr ? size_t(pair_gauss[i]) : size_t(i);
  const float4* row = reinterpret_cast<const float4*>(world8 + r * 8);
  const float4 lo = row[0], hi = row[1];
  w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
  w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
    fused_backward_kernel(const float* __restrict__ world8, const int* __restrict__ pair_gauss,
                          const float* __restrict__ pose, const int* __restrict__ tile_start,
                          int grid_x, int width, int height, const float* __restrict__ state,
                          const float* __restrict__ g, float* __restrict__ dpair) {
  __shared__ float s_attr[11][BB];  // xy, conic a/b/c, opacity, r, g, b, z, z^2
  __shared__ float s_red[WARPS][BB][NS];  // warp totals; s_red[0] then the block's sums
  __shared__ ProjIso s_q[BB];  // each staged pair's projection, for the chain
  __shared__ unsigned long long s_touched[WARPS];  // pairs of the batch each warp reduced
  __shared__ Pose s_pose;
  __shared__ int s_reach;

  const float fw = float(width), fh = float(height);
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int lx = tid % TILE, ly = tid / TILE;
  const int tx = tile % grid_x, ty = tile / grid_x;
  const int pxi = tx * TILE + lx, pyi = ty * TILE + ly;
  const bool inside = pxi < width && pyi < height;
  const float ox = float(tx * TILE), oy = float(ty * TILE);
  const float fx = float(lx), fy = float(ly);
  const int start = tile_start[tile], end = tile_start[tile + 1];
  const int warp = tid >> 5, lane = tid & 31;

  float T = 1.0f;
  int nc = 0;
  float gch[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // r, g, b, z, z^2, silhouette
  if (inside) {
    const size_t hw = size_t(width) * height, pix = size_t(pyi) * width + pxi;
    T = 1.0f - state[5 * hw + pix];
    nc = int(state[6 * hw + pix]);
#pragma unroll
    for (int c = 0; c < 6; ++c) gch[c] = g[c * hw + pix];
  }
  if (tid == 0) {
    s_reach = 0;
    s_pose = load_pose(pose);
  }
  __syncthreads();
  atomicMax(&s_reach, nc);
  __syncthreads();
  const int reach = start + s_reach;
  const Pose& P = s_pose;

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = reach + tid; i < end; i += PIX) {
    float4* row = reinterpret_cast<float4*>(dpair + size_t(i) * 8);
    row[0] = zero4;
    row[1] = zero4;
  }

  // Suffix accumulators. The silhouette's previous value is a constant 1:
  // before the first applied pair last_alpha is 0, which gives the same accum.
  float accum[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float last_c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float last_alpha = 0.0f;

  for (int bend = reach; bend > start; bend -= BB) {
    const int bstart = max(start, bend - BB);
    const int n = bend - bstart;
    const int jlim = nc - (bstart - start);  // this pixel applies pairs jj < jlim
    // Thread tid's slots of s_attr and s_q are read by the previous batch's
    // walk (done before its merge barrier) and its chain (by this thread).
    if (tid < n) {
      float w[8];
      load_row(world8, pair_gauss, bstart + tid, w);
      const ProjIso q = project_iso(w, P, fw, fh);
      s_q[tid] = q;
      s_attr[0][tid] = q.pix_x;
      s_attr[1][tid] = q.pix_y;
      s_attr[2][tid] = q.conic_a;
      s_attr[3][tid] = q.conic_b;
      s_attr[4][tid] = q.conic_c;
      s_attr[5][tid] = q.opacity;
      s_attr[6][tid] = w[5];
      s_attr[7][tid] = w[6];
      s_attr[8][tid] = w[7];
      s_attr[9][tid] = q.tz;
      s_attr[10][tid] = q.tz * q.tz;
    }
    __syncthreads();

    unsigned long long touched = 0;
    for (int jj = n - 1; jj >= 0; --jj) {
      float r[NS];
#pragma unroll
      for (int c = 0; c < NS; ++c) r[c] = 0.0f;
      bool contrib = false;
      if (jj < jlim) {
        const float dx = (s_attr[0][jj] - ox) - fx;
        const float dy = (s_attr[1][jj] - oy) - fy;
        const float ca = s_attr[2][jj], cb = s_attr[3][jj], cc = s_attr[4][jj];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power <= 0.0f) {
          const float op = s_attr[5][jj];
          const float G = expf(power);
          const float alpha_un = op * G;
          const float alpha = fminf(ALPHA_MAX, alpha_un);
          if (alpha >= ALPHA_MIN) {
            contrib = true;
            T = T / (1.0f - alpha);
            const float wgt = alpha * T;
            float dalpha = 0.0f;
#pragma unroll
            for (int c = 0; c < 6; ++c) {
              const float val = c < 5 ? s_attr[6 + c][jj] : 1.0f;
              const float prev = c < 5 ? last_c[c] : 1.0f;
              accum[c] = last_alpha * prev + (1.0f - last_alpha) * accum[c];
              dalpha += (val - accum[c]) * gch[c];
              if (c < 5) {
                last_c[c] = val;
                r[6 + c] = wgt * gch[c];
              }
            }
            dalpha *= T;
            last_alpha = alpha;
            if (alpha_un <= ALPHA_MAX) {
              const float dpower = op * dalpha * G;
              r[0] = dpower * -(ca * dx + cb * dy);
              r[1] = dpower * -(cc * dy + cb * dx);
              r[2] = dpower * (-0.5f * dx * dx);
              r[3] = dpower * (-dx * dy);
              r[4] = dpower * (-0.5f * dy * dy);
              r[5] = dalpha * G;
            }
          }
        }
      }
      if (__any_sync(FULL, contrib)) {
        const float total = reduce_scatter16(r, lane);
        if ((lane & 1) == 0) s_red[warp][jj][lane >> 1] = total;
        touched |= 1ull << jj;
      }
    }
    if (lane == 0) s_touched[warp] = touched;
    __syncthreads();

    // Merge: one (pair, column) per thread, the touching warps in warp order.
    for (int e = tid; e < n * NR; e += PIX) {
      const int p = e / NR, c = e - p * NR;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        if ((s_touched[w] >> p) & 1ull) v += s_red[w][p][c];
      }
      s_red[0][p][c] = v;
    }
    __syncthreads();

    if (tid < n) {
      float s[NR];
#pragma unroll
      for (int c = 0; c < NR; ++c) s[c] = s_red[0][tid][c];
      float d[8];
      chain_to_world(s_q[tid], P, fw, fh, s, d);
      float4* row = reinterpret_cast<float4*>(dpair + size_t(bstart + tid) * 8);
      row[0] = make_float4(d[0], d[1], d[2], d[3]);
      row[1] = make_float4(d[4], d[5], d[6], d[7]);
    }
    // No barrier here: the next batch's writes to s_red and s_touched come
    // after its staging barrier, and its staging writes only slot tid.
  }
}

}  // namespace splatam

extern "C" int fused_backward(const float* world8, const int* pair_gauss, const float* pose,
                              const int* tile_start, int grid_x, int grid_y, int width,
                              int height, const float* state, const float* g, float* dpair,
                              void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::fused_backward_kernel<<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        world8, pair_gauss, pose, tile_start, grid_x, width, height, state, g, dpair);
  }
  return (int)cudaGetLastError();
}

// What the compiler gave K5: registers and local (spill) bytes per thread,
// and resident blocks per SM.
extern "C" int fused_backward_info(int* regs, int* local_bytes, int* blocks_per_sm) {
  return splatam::kernel_info((const void*)splatam::fused_backward_kernel, splatam::PIX, regs,
                              local_bytes, blocks_per_sm);
}
