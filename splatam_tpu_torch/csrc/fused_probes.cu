// Probe kernels of the fused forward (K4, fused_forward.cu): each splits K4's
// time one way, as the TPU probes split fused_forward_pallas's.
//
// fused_forward2 replaces fwd2 (scripts/probe_unroll.py:118-253): K4's
// function with two batches per loop step. The TPU probe issues two chunks'
// carry-free prefixes back to back so that one chunk's projection hides under
// the other's latency. Here each thread issues the loads of both of its
// pairs' 32-byte world rows before it projects either one, stages both into a
// 2 x 256-pair shared buffer (22.5 KB), and the block walks 512 pairs between
// barriers: half K4's barriers and __syncthreads_count early-exit checks. The
// per-pixel pair order and arithmetic are K4's (same expressions, -fmad=false),
// so the result equals K4's bit for bit.
//
// dma_walk<B> replaces dma_only (B = 1, probe_dma.py:117-160) and make_dma_bn
// (B = 2, 4, probe_dma.py:173-224): K4's walk over the world rows and no
// compositing. One block of C = 128 threads per tile; per step every thread
// copies B of the tile's rows into shared memory with cp.async (two 16-byte
// pieces each, so the copies of rows 1-7 cannot be dropped as unused), double
// buffered like the TPU's two DMA slots, and adds column 0 of its first row.
// Rows past the tile's end are not copied: the port's buffers have no padding,
// so no copy reads past the tile or the buffer, and those lanes count as zero.
//
// fused_math_only replaces math_only (probe_dma.py:230-305): K4's per-pair
// math with no walk over memory. The block stages and projects the tile's
// first min(num, C) pairs once, then every pixel composites them ceil(num / C)
// times as list positions i * C + j (j < C, i * C + j < num) under K4's rules
// and early exit: K4 run on rows remapped so that pair k takes the row of pair
// start + (k mod C). Pixels stop on their own; no barrier after the staging.
//
// What bounds them on an H100: fwd2 and math_only, like K4, the per-pixel
// latency of the sequential compositing walk (math_only costs what K4 costs
// per pair-pixel evaluation without reading the rows; PERF.md); dma_walk the
// bytes it streams: its copies run near the memory rate, so staging more
// rows per step (B = 2, 4) buys nothing, unlike the TPU's per-chunk DMA issue.
#include "common.cuh"

namespace splatam {

constexpr int C = 128;            // the TPU kernels' chunk width
constexpr int NATTR = 6 + 5;      // xy, conic a/b/c, opacity, r, g, b, z, z^2
constexpr int STEP2 = 2 * PIX;    // pairs staged per fwd2 step

template <int S>
struct Staged {
  float v[NATTR][S];
};

__device__ __forceinline__ void load_world_row(const float* __restrict__ world8, int i,
                                               float4& lo, float4& hi) {
  const float4* row = reinterpret_cast<const float4*>(world8 + size_t(i) * 8);
  lo = row[0];
  hi = row[1];
}

// K4's staging of one pair (fused_forward.cu:30-46): project, then store the
// eleven compositing attributes into `slot`.
template <int S>
__device__ __forceinline__ void stage_projected(Staged<S>& sh, int slot, const float4& lo,
                                                const float4& hi, const Pose& P, float fw,
                                                float fh) {
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
}

// One pixel's state in the front-to-back walk (composite_tile's registers).
struct PixelWalk {
  float T;
  float acc[5];
  int last;
  bool done;
};

// composite_tile's loop body (common.cuh:126-144) for staged slot j at list
// position pos, expression by expression.
template <int S>
__device__ __forceinline__ void walk_slot(const Staged<S>& sh, int j, int pos, float ox, float oy,
                                          float fx, float fy, PixelWalk& p) {
  const float dx = (sh.v[0][j] - ox) - fx;
  const float dy = (sh.v[1][j] - oy) - fy;
  const float power =
      -0.5f * (sh.v[2][j] * dx * dx + sh.v[4][j] * dy * dy) - sh.v[3][j] * dx * dy;
  if (power > 0.0f) return;
  const float alpha = fminf(ALPHA_MAX, sh.v[5][j] * expf(power));
  if (alpha < ALPHA_MIN) return;
  const float test_T = p.T * (1.0f - alpha);
  if (test_T < T_EPS) {
    p.done = true;
    return;
  }
  const float wgt = alpha * p.T;
#pragma unroll
  for (int c = 0; c < 5; ++c) p.acc[c] += sh.v[6 + c][j] * wgt;
  p.T = test_T;
  p.last = pos + 1;
}

// The pixel of this thread, and the writes of composite_tile's epilogue.
struct TilePixel {
  int pxi, pyi;
  bool inside;
  float ox, oy, fx, fy;

  __device__ __forceinline__ TilePixel(int grid_x, int width, int height) {
    const int tile = blockIdx.x, tid = threadIdx.x;
    const int lx = tid % TILE, ly = tid / TILE;
    const int tx = tile % grid_x, ty = tile / grid_x;
    pxi = tx * TILE + lx;
    pyi = ty * TILE + ly;
    inside = pxi < width && pyi < height;
    ox = float(tx * TILE);
    oy = float(ty * TILE);
    fx = float(lx);
    fy = float(ly);
  }

  __device__ __forceinline__ void write(const PixelWalk& p, int width, int height,
                                        float* __restrict__ out) const {
    if (!inside) return;
    const size_t hw = size_t(width) * height, pix = size_t(pyi) * width + pxi;
#pragma unroll
    for (int c = 0; c < 5; ++c) out[c * hw + pix] = p.acc[c];
    out[5 * hw + pix] = 1.0f - p.T;
    out[6 * hw + pix] = float(p.last);
  }
};

__device__ __forceinline__ PixelWalk start_walk(bool inside) {
  PixelWalk p;
  p.T = 1.0f;
#pragma unroll
  for (int c = 0; c < 5; ++c) p.acc[c] = 0.0f;
  p.last = 0;
  p.done = !inside;
  return p;
}

__global__ void __launch_bounds__(PIX)
    fused_forward2_kernel(const float* __restrict__ world8, const float* __restrict__ pose,
                          const int* __restrict__ tile_start, int grid_x, int width, int height,
                          float* __restrict__ out) {
  __shared__ Staged<STEP2> sh;
  const Pose P = load_pose(pose);
  const float fw = float(width), fh = float(height);
  const TilePixel px(grid_x, width, height);
  const int tid = threadIdx.x;
  const int start = tile_start[blockIdx.x], end = tile_start[blockIdx.x + 1];
  PixelWalk p = start_walk(px.inside);

  for (int base = start; base < end; base += STEP2) {
    if (__syncthreads_count(p.done) == PIX) break;
    const int i0 = base + tid, i1 = base + PIX + tid;
    float4 lo0, hi0, lo1, hi1;
    if (i0 < end) load_world_row(world8, i0, lo0, hi0);
    if (i1 < end) load_world_row(world8, i1, lo1, hi1);
    if (i0 < end) stage_projected(sh, tid, lo0, hi0, P, fw, fh);
    if (i1 < end) stage_projected(sh, PIX + tid, lo1, hi1, P, fw, fh);
    __syncthreads();
    const int n = min(STEP2, end - base);
    for (int j = 0; j < n && !p.done; ++j)
      walk_slot(sh, j, base - start + j, px.ox, px.oy, px.fx, px.fy, p);
  }
  px.write(p, width, height, out);
}

__global__ void __launch_bounds__(PIX)
    fused_math_only_kernel(const float* __restrict__ world8, const float* __restrict__ pose,
                           const int* __restrict__ tile_start, int grid_x, int width, int height,
                           float* __restrict__ out) {
  __shared__ Staged<C> sh;
  const Pose P = load_pose(pose);
  const TilePixel px(grid_x, width, height);
  const int tid = threadIdx.x;
  const int start = tile_start[blockIdx.x], num = tile_start[blockIdx.x + 1] - start;
  if (tid < min(num, C)) {
    float4 lo, hi;
    load_world_row(world8, start + tid, lo, hi);
    stage_projected(sh, tid, lo, hi, P, float(width), float(height));
  }
  __syncthreads();
  PixelWalk p = start_walk(px.inside);
  for (int base = 0; base < num && !p.done; base += C) {
    const int n = min(C, num - base);
    for (int j = 0; j < n && !p.done; ++j)
      walk_slot(sh, j, base + j, px.ox, px.oy, px.fx, px.fy, p);
  }
  px.write(p, width, height, out);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {  // all groups but the newest landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int B>
__global__ void __launch_bounds__(C)
    dma_walk_kernel(const float* __restrict__ world8, const int* __restrict__ tile_start,
                    float* __restrict__ out) {
  __shared__ __align__(16) float buf[2][B * C][8];
  const int l = threadIdx.x;
  const int start = tile_start[blockIdx.x], num = tile_start[blockIdx.x + 1] - start;
  const int steps = (num + B * C - 1) / (B * C);
  // Copies step s's rows into slot s & 1, one commit group per step.
  auto stage = [&](int s) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int k = s * B * C + b * C + l;
      if (k < num) {
        const float* row = world8 + size_t(start + k) * 8;
        cp_async16(&buf[s & 1][b * C + l][0], row);
        cp_async16(&buf[s & 1][b * C + l][4], row + 4);
      }
    }
    cp_async_commit();
  };
  float acc = 0.0f;
  if (steps > 0) stage(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      stage(s + 1);
    } else {
      cp_async_commit();  // an empty group, so the wait below still covers step s
    }
    cp_async_wait_prior();  // a thread adds only the row it copied itself
    if (s * B * C + l < num) acc += buf[s & 1][l][0];
    __syncthreads();  // slot s & 1 is read before step s + 2 is copied into it
  }
  out[size_t(blockIdx.x) * C + l] = acc;
}

template <int B>
int launch_dma_walk(const float* world8, const int* tile_start, int tiles, float* out,
                    void* stream) {
  if (tiles > 0) {
    dma_walk_kernel<B><<<tiles, C, 0, (cudaStream_t)stream>>>(world8, tile_start, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace splatam

extern "C" int fused_forward2(const float* world8, const float* pose, const int* tile_start,
                              int grid_x, int grid_y, int width, int height, float* out,
                              void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::fused_forward2_kernel<<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        world8, pose, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int fused_math_only(const float* world8, const float* pose, const int* tile_start,
                               int grid_x, int grid_y, int width, int height, float* out,
                               void* stream) {
  const int tiles = grid_x * grid_y;
  if (tiles > 0) {
    splatam::fused_math_only_kernel<<<tiles, splatam::PIX, 0, (cudaStream_t)stream>>>(
        world8, pose, tile_start, grid_x, width, height, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int dma_walk1(const float* world8, const int* tile_start, int tiles, float* out,
                         void* stream) {
  return splatam::launch_dma_walk<1>(world8, tile_start, tiles, out, stream);
}

extern "C" int dma_walk2(const float* world8, const int* tile_start, int tiles, float* out,
                         void* stream) {
  return splatam::launch_dma_walk<2>(world8, tile_start, tiles, out, stream);
}

extern "C" int dma_walk4(const float* world8, const int* tile_start, int tiles, float* out,
                         void* stream) {
  return splatam::launch_dma_walk<4>(world8, tile_start, tiles, out, stream);
}
