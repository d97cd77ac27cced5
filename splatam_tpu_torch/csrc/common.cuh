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

// What the compiler gave a kernel: registers and local (spill) bytes per
// thread, and the blocks of `threads` threads resident on one SM (its static
// shared memory included). Returns a cudaError_t.
inline int kernel_info(const void* fn, int threads, int* regs, int* local_bytes,
                       int* blocks_per_sm) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  *local_bytes = int(a.localSizeBytes);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, 0);
}

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

// ---------------------------------------------------------------------------
// Shared by the composite kernels (K1, K2) and the fused kernels (K4, K5).
// ---------------------------------------------------------------------------

// One step of the reduce-scatter: lanes whose `BIT` is set keep the upper H
// slots of v[0 .. 2H), the others the lower H, and each adds its xor partner's
// copy of the half it keeps into v[0 .. H).
template <int H, int BIT>
__device__ __forceinline__ void halve(float* v, int lane) {
  const bool upper = (lane & BIT) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, BIT);
  }
}

// Warp sums of v[0 .. 16) by recursive halving (16 shuffles): returns the
// warp total of slot lane / 2, the same in lanes 2s and 2s + 1.
__device__ __forceinline__ float reduce_scatter16(float* v, int lane) {
  halve<8, 16>(v, lane);
  halve<4, 8>(v, lane);
  halve<2, 4>(v, lane);
  halve<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// The pixels of a warp of K1, K2 and K4 inside its 16x16 tile: four rows of eight
// (warp w holds columns 8 (w % 2) .. + 7 of rows 4 (w / 2) .. + 3), which a
// small round footprint cuts less often than two rows of 16 (measured,
// PERF.md). WARP_W in render/composite.py is the plain version's copy. The map
// is private to a kernel: the images stay [C, H, W].
constexpr int WARP_W = 8;
struct WarpShape {
  static constexpr int W = WARP_W, H = 32 / WARP_W;
  static constexpr int ACROSS = TILE / W;  // warps side by side in a tile
  __device__ static __forceinline__ int x0(int warp) { return (warp % ACROSS) * W; }
  __device__ static __forceinline__ int y0(int warp) { return (warp / ACROSS) * H; }
  __device__ static __forceinline__ int lx(int tid) { return x0(tid >> 5) + (tid & 31) % W; }
  __device__ static __forceinline__ int ly(int tid) { return y0(tid >> 5) + (tid & 31) / W; }
};

// The warp-granular cull (plain version: cull_rows_plain and cull_warp_mask in
// render/composite.py). A pair contributes at a pixel only where power <= 0
// and opacity * exp(power) >= 1/255, that is where
//   q = 0.5 (a dx^2 + c dy^2) + b dx dy <= L,  L = ln(255 opacity).
// For a positive definite conic (a, c, det = a c - b^2 > 0) that ellipse lies
// in the box |dx| <= sqrt(2 L c / det), |dy| <= sqrt(2 L a / det) around the
// pair's centre. The walk decides in float32: its q is off by at most a few
// roundings times the conic's condition number (<= (a + c)^2 / det) relative
// to q, and expf, the product and dx, dy by a few 1e-7. So the rule is used
// only while (a + c)^2 <= CULL_MAX_COND det (the walk's q within 0.3% of the
// exact one), L is widened to 1.01 L + 0.01 and each half width to 1.01 h +
// 0.01 px: far more than those errors, and seldom a whole pixel. An opacity
// below 1/255 contributes nowhere (opacity * G <= opacity in float32 too). A
// pair the rule cannot bound (det <= 0, a or c <= 0, ill conditioned, or not
// tame: a term that is not finite, or so large that the walk's power could
// overflow to NaN, which none of its tests skips) gets the whole plane: the
// cull only skips what the walk skips.
constexpr float CULL_MAX_COND = 1e4f;
constexpr float CULL_REL = 1.01f;
constexpr float CULL_ABS = 0.01f;
constexpr float CULL_MAX_COORD = 1e6f;  // |centre - tile origin| of a tame pair, pixels
constexpr float CULL_MAX_TERM = 1e18f;  // |a|, |b|, |c|, |opacity| of a tame pair

// The box, in pixels from the tile's origin, outside which a pair contributes
// nowhere; x_lo > x_hi where it contributes nowhere at all.
struct Reach {
  float x_lo, x_hi, y_lo, y_hi;
};

__device__ __forceinline__ Reach pair_reach(float rx, float ry, float a, float b, float c,
                                            float opacity) {
  const float inf = __int_as_float(0x7f800000);
  Reach r = {-inf, inf, -inf, inf};
  const bool tame = fabsf(rx) <= CULL_MAX_COORD && fabsf(ry) <= CULL_MAX_COORD &&
                    fabsf(a) <= CULL_MAX_TERM && fabsf(b) <= CULL_MAX_TERM &&
                    fabsf(c) <= CULL_MAX_TERM && fabsf(opacity) <= CULL_MAX_TERM;
  if (!tame) return r;
  if (opacity < ALPHA_MIN) {
    r.x_lo = r.y_lo = inf;
    r.x_hi = r.y_hi = -inf;
    return r;
  }
  const float det = a * c - b * b, tr = a + c;
  if (a > 0.0f && c > 0.0f && det > 0.0f && tr * tr <= CULL_MAX_COND * det) {
    const float L = logf(255.0f * opacity) * CULL_REL + CULL_ABS;
    const float hx = sqrtf(2.0f * L * c / det) * CULL_REL + CULL_ABS;
    const float hy = sqrtf(2.0f * L * a / det) * CULL_REL + CULL_ABS;
    r.x_lo = rx - hx;
    r.x_hi = rx + hx;
    r.y_lo = ry - hy;
    r.y_hi = ry + hy;
  }
  return r;
}

// Bit w is set when warp w of the tile must visit the pair: its pixels'
// rectangle meets the box. A NaN bound excludes nothing.
__device__ __forceinline__ unsigned reach_warp_mask(const Reach& r) {
  using S = WarpShape;
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < PIX / 32; ++w) {
    const float x0 = float(S::x0(w)), y0 = float(S::y0(w));
    const bool out = r.x_lo > x0 + float(S::W - 1) || r.x_hi < x0 ||
                     r.y_lo > y0 + float(S::H - 1) || r.y_hi < y0;
    mask |= out ? 0u : 1u << w;
  }
  return mask;
}

// A pair staged for the composite walks: its geometry and NCH channels, the
// channels as QUADS float4 and the rest as single floats. At NCH = 5 it is one
// 48-byte structure (geo, channels 0-3, geo2, channel 4): an evaluation is one
// 16-byte and one 8-byte broadcast read at one base address, an applied pair
// two more. Fewer than four channels take the first lanes of one float4. rx,
// ry are the centre minus the tile's origin, the walk's own first
// subtraction, so dx = rx - lx rounds as (x - ox) - lx does.
template <int NCH>
struct __align__(16) StagedPair {
  static constexpr int QUADS = NCH < 4 ? 1 : NCH / 4;
  static constexpr int REST = NCH > 4 * QUADS ? NCH - 4 * QUADS : 0;
  float4 geo;  // rx, ry, conic a, conic b
  float4 quad[QUADS];  // channels 0 .. 4 QUADS - 1
  float2 geo2;  // conic c, opacity
  float rest[REST > 0 ? REST : 1];  // channels 4 QUADS .. NCH - 1

  __device__ __forceinline__ void set_channels(const float* c) {
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      const int i = 4 * q;
      quad[q] = make_float4(c[i], i + 1 < NCH ? c[i + 1] : 0.0f, i + 2 < NCH ? c[i + 2] : 0.0f,
                            i + 3 < NCH ? c[i + 3] : 0.0f);
    }
#pragma unroll
    for (int r = 0; r < REST; ++r) rest[r] = c[4 * QUADS + r];
  }

  __device__ __forceinline__ void channels(float* c) const {
#pragma unroll
    for (int q = 0; q < QUADS; ++q) {
      const float4 v = quad[q];
      const float lanes[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * q + j < NCH) c[4 * q + j] = lanes[j];
      }
    }
#pragma unroll
    for (int r = 0; r < REST; ++r) c[4 * QUADS + r] = rest[r];
  }
};

// Stages one pair from its compositing attributes (centre x, y in image pixels,
// conic, opacity, NCH channels c) and returns the mask of the warps that must
// visit it.
template <int NCH>
__device__ __forceinline__ unsigned stage_values(StagedPair<NCH>& s, float x, float y, float ca,
                                                 float cb, float cc, float op, const float* c,
                                                 float ox, float oy) {
  const float rx = x - ox, ry = y - oy;
  s.geo = make_float4(rx, ry, ca, cb);
  s.set_channels(c);
  s.geo2 = make_float2(cc, op);
  return reach_warp_mask(pair_reach(rx, ry, ca, cb, cc, op));
}

// Stages the (6 + NCH)-column row `a` of one pair and returns the mask of the
// warps that must visit it.
template <int NCH>
__device__ __forceinline__ unsigned stage_pair(StagedPair<NCH>& s, const float* __restrict__ a,
                                               float ox, float oy) {
  float c[NCH];
#pragma unroll
  for (int i = 0; i < NCH; ++i) c[i] = a[6 + i];
  return stage_values(s, a[0], a[1], a[2], a[3], a[4], a[5], c, ox, oy);
}

// ---------------------------------------------------------------------------
// The forward walk of K1 (composite_forward.cu), K4 (fused_forward.cu) and the
// probes fwd2 and math_only (fused_probes.cu): front-to-back compositing of
// one tile, renderCUDA's loop. Batches of 256 pairs are staged in shared
// memory, one pair per thread, by a `Stager` (how a kernel reads a pair and
// turns it into a StagedPair); eight ballots per staging warp turn the pairs'
// warp masks into one 32-bit word per (warp, 32 pairs); each warp steps through
// the set bits of its own words in depth order. A block stops when every
// pixel has, a warp when its 32 pixels have.
// ---------------------------------------------------------------------------

// One pixel's evaluation of a staged pair; `index` is the pair's 1-based place
// in its tile's list (the pixel's n_contrib if the pair is applied).
template <int NCH>
__device__ __forceinline__ void composite_pair(const StagedPair<NCH>& p, float fx, float fy,
                                               int index, float& T, float* acc, int& last,
                                               bool& done) {
  const float4 g = p.geo;
  const float2 g2 = p.geo2;
  const float dx = g.x - fx;
  const float dy = g.y - fy;
  const float power = -0.5f * (g.z * dx * dx + g2.x * dy * dy) - g.w * dx * dy;
  if (power > 0.0f) return;
  const float alpha = fminf(ALPHA_MAX, g2.y * expf(power));
  if (alpha < ALPHA_MIN) return;
  const float test_T = T * (1.0f - alpha);
  if (test_T < T_EPS) {
    done = true;
    return;
  }
  const float wgt = alpha * T;
  float c[NCH];
  p.channels(c);
#pragma unroll
  for (int i = 0; i < NCH; ++i) acc[i] += c[i] * wgt;
  T = test_T;
  last = index;
}

// The pixel a thread owns in its tile (WarpShape) and its state in the walk.
template <int NCH>
struct WalkPixel {
  int pxi, pyi;
  bool inside, done;
  float ox, oy, fx, fy;  // the tile's origin; the pixel inside the tile
  float T, acc[NCH];
  int last;

  __device__ __forceinline__ WalkPixel(int grid_x, int width, int height) {
    const int tile = blockIdx.x, tid = threadIdx.x;
    const int lx = WarpShape::lx(tid), ly = WarpShape::ly(tid);
    const int tx = tile % grid_x, ty = tile / grid_x;
    pxi = tx * TILE + lx;
    pyi = ty * TILE + ly;
    inside = pxi < width && pyi < height;
    ox = float(tx * TILE);
    oy = float(ty * TILE);
    fx = float(lx);
    fy = float(ly);
    T = 1.0f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[c] = 0.0f;
    last = 0;
    done = !inside;
  }

  // The channels, the silhouette 1 - T_final and n_contrib into out
  // [NCH + 2, H, W]; the bottom and right tiles may be ragged.
  __device__ __forceinline__ void write(int width, int height, float* __restrict__ out) const {
    if (!inside) return;
    const size_t hw = size_t(width) * height, pix = size_t(pyi) * width + pxi;
#pragma unroll
    for (int c = 0; c < NCH; ++c) out[c * hw + pix] = acc[c];
    out[NCH * hw + pix] = 1.0f - T;
    out[(NCH + 1) * hw + pix] = float(last);
  }
};

// What one walk step stages: BATCHES batches of 256 pairs and, per warp of the
// tile, the list of staged pairs it must visit, a bit per pair.
template <int BATCHES, int NCH>
struct WalkShared {
  static constexpr int PAIRS = BATCHES * PIX;
  static constexpr int WORDS = PAIRS / 32;
  StagedPair<NCH> pairs[PAIRS];
  unsigned words[PIX / 32][WORDS];
};

// The staging warp holds 32 pairs, one per lane with its warp mask: they are
// word `word` of every warp's list.
template <int WORDS>
__device__ __forceinline__ void publish_masks(unsigned (*words)[WORDS], unsigned mask, int word) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 0; w < PIX / 32; ++w) {
    const unsigned bits = __ballot_sync(FULL, (mask >> w) & 1u);
    if (lane == 0) words[w][word] = bits;
  }
}

// A warp walks the first n staged pairs of its list; the list's first pair is
// pair `first` (1-based) of the tile. With TRIM the list may hold set bits
// past n, which are masked off (a walk that stages once and walks a part).
template <bool TRIM, int NCH>
__device__ __forceinline__ void walk_words(const StagedPair<NCH>* pairs, const unsigned* words,
                                           int n, int first, WalkPixel<NCH>& p) {
  for (int k = 0; k < (n + 31) >> 5; ++k) {
    if (__all_sync(FULL, p.done)) break;
    unsigned bits = words[k];
    if (TRIM && n - (k << 5) < 32) bits &= (1u << (n - (k << 5))) - 1u;
    while (bits != 0u) {
      const int j = (k << 5) + __ffs(bits) - 1;
      bits &= bits - 1u;
      if (!p.done) composite_pair(pairs[j], p.fx, p.fy, first + j, p.T, p.acc, p.last, p.done);
    }
  }
}

// The whole walk of the tile's pairs [start, end). A Stager has a channel
// count NCH, a type Row, load(i) -> Row (pair i's numbers from device memory)
// and stage(StagedPair<NCH>&, Row, ox, oy) -> the pair's warp mask. With
// BATCHES > 1 a thread loads the rows of all its pairs of the step before it
// stages one.
template <int BATCHES, class Stager>
__device__ __forceinline__ void composite_walk(WalkShared<BATCHES, Stager::NCH>& sh,
                                               const Stager& stager, int start, int end,
                                               int grid_x, int width, int height,
                                               float* __restrict__ out) {
  constexpr int STEP = WalkShared<BATCHES, Stager::NCH>::PAIRS;
  const int tid = threadIdx.x, warp = tid >> 5;
  WalkPixel<Stager::NCH> p(grid_x, width, height);
  for (int base = start; base < end; base += STEP) {
    if (__syncthreads_count(p.done) == PIX) break;
    typename Stager::Row rows[BATCHES];
#pragma unroll
    for (int b = 0; b < BATCHES; ++b) {
      const int i = base + b * PIX + tid;
      if (i < end) rows[b] = stager.load(i);
    }
#pragma unroll
    for (int b = 0; b < BATCHES; ++b) {
      const int i = base + b * PIX + tid;
      unsigned mask = 0;
      if (i < end) mask = stager.stage(sh.pairs[b * PIX + tid], rows[b], p.ox, p.oy);
      publish_masks(sh.words, mask, b * (PIX / 32) + warp);
    }
    __syncthreads();
    walk_words<false>(sh.pairs, sh.words[warp], min(STEP, end - base), base - start + 1, p);
  }
  p.write(width, height, out);
}

// K4's staging (and fwd2's, math_only's): the pair's 32-byte world row, read
// in place or through pair_gauss as two float4, projected (project_iso) and
// staged as K1 stages an 11-column row: centre, conic, opacity, then the
// channels r, g, b, tz, tz * tz. The cull's box is taken from the projected
// values, so it bounds the pair the walk composites: one behind the near plane
// is projected at safe_tz = 1 and composited there (in_front and det_ok stay
// out of the skip mask, splatam_tpu/render/pallas/fused_iso.py:168-178); with
// det == 0 the conic is degenerate and the rule gives it the whole plane.
struct ProjectedRows {
  static constexpr int NCH = 5;
  struct Row {
    float4 lo, hi;
  };
  const float* __restrict__ world8;
  const int* __restrict__ pair_gauss;  // null: world8 holds one row per sorted pair
  const Pose& pose;
  float width, height;

  __device__ __forceinline__ Row load(int i) const {
    const size_t row = pair_gauss != nullptr ? size_t(pair_gauss[i]) : size_t(i);
    const float4* r = reinterpret_cast<const float4*>(world8 + row * 8);
    return {r[0], r[1]};
  }

  __device__ __forceinline__ unsigned stage(StagedPair<NCH>& s, const Row& r, float ox,
                                            float oy) const {
    const float w[8] = {r.lo.x, r.lo.y, r.lo.z, r.lo.w, r.hi.x, r.hi.y, r.hi.z, r.hi.w};
    const ProjIso q = project_iso(w, pose, width, height);
    const float c[NCH] = {w[5], w[6], w[7], q.tz, q.tz * q.tz};
    return stage_values(s, q.pix_x, q.pix_y, q.conic_a, q.conic_b, q.conic_c, q.opacity, c, ox,
                        oy);
  }
};

}  // namespace splatam
