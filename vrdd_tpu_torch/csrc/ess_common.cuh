// The empty-space-skipping (ESS) interval test of one (tile, chunk) pair,
// shared by the sweep kernels (slice_sweep.cu: K1/K3/K4, both fetch paths,
// which test every chunk of their tile at block start, a group of lanes a
// chunk: ess_tile_bits) and the standalone bitmap kernel (ess_bitmap.cu, a
// thread a pair), which the bench's roofline and the tests still call.
//
// Replaces the XLA computation _ess_bitmap (vrdd_tpu/pallas/slice_kernel.py
// :397-506), which JAX fuses into the frame's jitted graph in front of the
// kernel's ess mode (:835-851). Its plain torch version is
// ess_bitmap_reference in kernels/slice_kernel.py. A tile is the sweep
// kernel's CUDA block (kernels/slice_kernel.py ESS_TILE), a chunk
// plane_chunk planes. The test
//   1. takes the chunk's depth range [z_lo, z_hi] from zs;
//   2. bounds the world (x, y) of the tile's rays over that range by the
//      four corner rays (a ray's position on a plane is affine in depth and
//      slope), maps it to the 1-voxel-dilated texel range and then to the
//      range of the 8 x 8 blocks of the plane statistics;
//   3. takes the min / max of those blocks over the chunk's planes;
//   4. takes the largest |alpha| of the clamped piecewise-linear LUT over the
//      LUT-coordinate interval of [min, max] (widened by q_margin): at the
//      interval's ends or at a knot inside;
// and is live where that alpha is nonzero, dead where every sample of the
// tile in the chunk provably has alpha exactly 0.
//
// The arithmetic is the plain version's, operation for operation: the
// geometry in float64 (numpy there), the LUT part in float32 (torch there),
// each with explicitly rounded intrinsics so that nvcc contracts nothing
// into an FMA. The knots inside the interval are those from ceil(q_lo) to
// floor(q_hi); their largest |alpha| is one query of a sparse table built
// in shared memory once per block (level j holds the max of 2^j consecutive
// knots, a query the max of two overlapping runs). A max is exact, so the
// bit is the one a scan of every knot gives: byte for byte the plain
// version's, which the card tests check, and the brute-force CPU test of
// the plain version's conservativeness covers the kernels too.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// The geometry of the test, from the host: the standalone kernel's
// parameters, and SweepParams.ess of a sweep that tests ESS itself (must
// match EssParams in vrdd_tpu_torch/kernels/_build.py field for field).
// Outside any namespace: the exported C entry points take it.
struct EssParams {
  double ox, oy, oz;            // camera origin (float32 values)
  double mx0, dmx, my0, dmy;    // ray slope grids mx0 + dmx * j, my0 + dmy * i
  double xlo, xhi, ylo, yhi;    // the box in x and y
  double tex_offset, sx, sy;    // texel-centre offset, per-axis grid scale
  float tf_off, tf_scale, q_margin;
  int n_planes, plane_chunk, height, width, tile_h, tile_w;
  int ny, nx, n_lut, n_by, n_bx;
  // tracing (vrdd_tpu_torch/utils/profiling.py ess_counts): the (tile,
  // chunk) pairs the sweep kernels tested, and those they found live, are
  // added to counts[0] and counts[1]; null when the tracer is off
  unsigned long long* counts;
};

namespace vrdd {

// Levels of the sparse table over n knots: floor(log2 n) + 1.
__host__ __device__ inline int ess_table_levels(int n) {
  int l = 1;
  while ((2 << (l - 1)) <= n) ++l;
  return l;
}

// Floats of the sparse table over n knots (level j at j * n).
__host__ __device__ inline int ess_table_floats(int n) {
  return n * ess_table_levels(n);
}

// Build the sparse table of |alpha| of the (n, 4) LUT into shared memory t.
// Every thread of the block calls it (barriers between the levels and at
// the end).
__device__ __forceinline__ void ess_table_build(const float* __restrict__ lut,
                                                int n, float* t, int tid,
                                                int nthreads) {
  for (int i = tid; i < n; i += nthreads) t[i] = fabsf(lut[4 * i + 3]);
  const int levels = ess_table_levels(n);
  for (int j = 1; j < levels; ++j) {
    __syncthreads();
    float* row = t + j * n;
    const float* prev = row - n;
    const int half = 1 << (j - 1);
    for (int i = tid; i + 2 * half <= n; i += nthreads)
      row[i] = fmaxf(prev[i], prev[i + half]);
  }
  __syncthreads();
}

// The largest |alpha| of knots lo..hi (lo <= hi) from the sparse table.
__device__ __forceinline__ float ess_range_max(const float* t, int n, int lo,
                                               int hi) {
  const int j = 31 - __clz(hi - lo + 1);
  return fmaxf(t[j * n + lo], t[j * n + hi - (1 << j) + 1]);
}

// The corner rays' world coordinate on one axis over the tile's rays
// [t * size, min(t * size + size, extent) - 1] and the chunk's depth range.
__device__ __forceinline__ void corner_range(double o, double m0, double dm,
                                             int size, int t, int extent,
                                             double dz_lo, double dz_hi,
                                             double& lo, double& hi) {
  const double first = (double)(t * size);
  const double last = (double)(min(t * size + size, extent) - 1);
  const double ma = __dadd_rn(m0, __dmul_rn(dm, first));
  const double mb = __dadd_rn(m0, __dmul_rn(dm, last));
  const double c0 = __dadd_rn(o, __dmul_rn(dz_lo, ma));
  const double c1 = __dadd_rn(o, __dmul_rn(dz_lo, mb));
  const double c2 = __dadd_rn(o, __dmul_rn(dz_hi, ma));
  const double c3 = __dadd_rn(o, __dmul_rn(dz_hi, mb));
  lo = fmin(fmin(c0, c1), fmin(c2, c3));
  hi = fmax(fmax(c0, c1), fmax(c2, c3));
}

// World range [lo_w, hi_w] on one axis -> 1-voxel-dilated texel range ->
// the range [b_lo, b_hi] of the nb statistic blocks of an N-texel axis.
__device__ __forceinline__ void block_range(double lo_w, double hi_w,
                                            double lo_box, double hi_box,
                                            int N, int nb, double scale,
                                            double tex_offset, int& b_lo,
                                            int& b_hi) {
  const double ext = __dsub_rn(hi_box, lo_box);
  const double ns = __dmul_rn((double)N, scale);
  const double bsz = (double)((N + nb - 1) / nb);
  const double u_lo = __ddiv_rn(__dsub_rn(lo_w, lo_box), ext);
  const double u_hi = __ddiv_rn(__dsub_rn(hi_w, lo_box), ext);
  const double v_lo =
      __dsub_rn(floor(__dsub_rn(__dmul_rn(u_lo, ns), tex_offset)), 1.0);
  const double v_hi =
      __dadd_rn(ceil(__dsub_rn(__dmul_rn(u_hi, ns), tex_offset)), 2.0);
  const double top = (double)(nb - 1);
  b_lo = (int)fmin(fmax(floor(__ddiv_rn(v_lo, bsz)), 0.0), top);
  b_hi = (int)fmin(fmax(floor(__ddiv_rn(v_hi, bsz)), 0.0), top);
}

// The statistic blocks [by0, by1] x [bx0, bx1] the rays of tile (ty, tx)
// can touch while their depth lies in [z_lo, z_hi].
__device__ __forceinline__ void ess_tile_blocks(const EssParams& g, int ty,
                                                int tx, float z_lo,
                                                float z_hi, int& by0,
                                                int& by1, int& bx0,
                                                int& bx1) {
  const double dz_lo = __dsub_rn((double)z_lo, g.oz);
  const double dz_hi = __dsub_rn((double)z_hi, g.oz);
  double y_lo, y_hi, x_lo, x_hi;
  corner_range(g.oy, g.my0, g.dmy, g.tile_h, ty, g.height, dz_lo, dz_hi,
               y_lo, y_hi);
  corner_range(g.ox, g.mx0, g.dmx, g.tile_w, tx, g.width, dz_lo, dz_hi,
               x_lo, x_hi);
  block_range(y_lo, y_hi, g.ylo, g.yhi, g.ny, g.n_by, g.sy, g.tex_offset,
              by0, by1);
  block_range(x_lo, x_hi, g.xlo, g.xhi, g.nx, g.n_bx, g.sx, g.tex_offset,
              bx0, bx1);
}

// Fold the blocks [by0, by1] x [bx0, bx1] of plane k into [vmin, vmax].
__device__ __forceinline__ void ess_plane_range(
    const EssParams& g, const float* __restrict__ pmin,
    const float* __restrict__ pmax, int k, int by0, int by1, int bx0,
    int bx1, float& vmin, float& vmax) {
  for (int by = by0; by <= by1; ++by) {
    const size_t row = ((size_t)k * g.n_by + by) * g.n_bx;
    for (int bx = bx0; bx <= bx1; ++bx) {
      vmin = fminf(vmin, __ldg(pmin + row + bx));
      vmax = fmaxf(vmax, __ldg(pmax + row + bx));
    }
  }
}

// |alpha| of the clamped linear LUT at coordinate q in [0, n_lut - 1]; la
// is the sparse table's level 0.
__device__ __forceinline__ float alpha_at(const float* la, int n_lut,
                                          float q) {
  const float fl = floorf(q);
  const int i0 = min(max((int)fl, 0), n_lut - 1);
  const int i1 = min(i0 + 1, n_lut - 1);
  const float f = __fsub_rn(q, fl);
  return __fadd_rn(__fmul_rn(la[i0], __fsub_rn(1.0f, f)),
                   __fmul_rn(la[i1], f));
}

// Whether some value in [vmin, vmax] maps to a nonzero alpha (step 4).
__device__ __forceinline__ bool ess_lut_live(const EssParams& g,
                                             const float* t, float vmin,
                                             float vmax) {
  const float n = (float)g.n_lut;
  const float qa = __fsub_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(vmin, g.tf_off), g.tf_scale), n), 0.5f);
  const float qb = __fsub_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(vmax, g.tf_off), g.tf_scale), n), 0.5f);
  const float top = n - 1.0f;
  const float q_lo =
      fminf(fmaxf(__fsub_rn(fminf(qa, qb), g.q_margin), 0.0f), top);
  const float q_hi =
      fminf(fmaxf(__fadd_rn(fmaxf(qa, qb), g.q_margin), 0.0f), top);
  float amax = fmaxf(alpha_at(t, g.n_lut, q_lo), alpha_at(t, g.n_lut, q_hi));
  const int k_lo = (int)ceilf(q_lo), k_hi = (int)floorf(q_hi);
  if (k_lo <= k_hi) amax = fmaxf(amax, ess_range_max(t, g.n_lut, k_lo, k_hi));
  return amax > 0.0f;
}

// The bitmap's index of (chunk c, tile row ty, tile column tx).
__device__ __forceinline__ size_t ess_index(const EssParams& g, int c, int ty,
                                            int tx) {
  const int n_ty = (g.height + g.tile_h - 1) / g.tile_h;
  const int n_tx = (g.width + g.tile_w - 1) / g.tile_w;
  return ((size_t)c * n_ty + ty) * n_tx + tx;
}

// The min and max of lo / hi over the G lanes of this lane's group (G a
// power of two up to 32, groups aligned in the warp; G = 1: no shuffle).
// Every lane of the warp calls it with the same G.
__device__ __forceinline__ void ess_group_min_max(float& lo, float& hi,
                                                  int G) {
  for (int o = G >> 1; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// The test of (chunk c, tile (ty, tx)) by lane `sub` of G lanes: each lane
// folds the chunk's planes c * plane_chunk + sub, + sub + G, ... (depths,
// then block statistics), the group combines them after each fold, and
// every lane of the group returns the bit. min and max are exact in any
// order, so the bit does not depend on G. G = 1: one thread (the standalone
// kernel).
__device__ __forceinline__ bool ess_chunk_live(const EssParams& g,
                                               const float* __restrict__ pmin,
                                               const float* __restrict__ pmax,
                                               const float* __restrict__ zs,
                                               const float* t, int c, int ty,
                                               int tx, int sub = 0,
                                               int G = 1) {
  const int k0 = c * g.plane_chunk;
  const int k1 = min(k0 + g.plane_chunk, g.n_planes);
  float z_lo = INFINITY, z_hi = -INFINITY;
  for (int k = k0 + sub; k < k1; k += G) {
    z_lo = fminf(z_lo, __ldg(zs + k));
    z_hi = fmaxf(z_hi, __ldg(zs + k));
  }
  ess_group_min_max(z_lo, z_hi, G);
  int by0, by1, bx0, bx1;
  ess_tile_blocks(g, ty, tx, z_lo, z_hi, by0, by1, bx0, bx1);
  float vmin = INFINITY, vmax = -INFINITY;
  for (int k = k0 + sub; k < k1; k += G)
    ess_plane_range(g, pmin, pmax, k, by0, by1, bx0, bx1, vmin, vmax);
  ess_group_min_max(vmin, vmax, G);
  return ess_lut_live(g, t, vmin, vmax);
}

// Lanes that test one chunk together in ess_tile_bits: the largest power of
// two up to 32 with a group for every chunk among nthreads threads, at
// least 1.
__device__ __forceinline__ int ess_group(int n_chunks, int nthreads) {
  int G = 1;
  while (G < 32 && 2 * G * n_chunks <= nthreads) G *= 2;
  return G;
}

// The bits of every chunk of tile (ty, tx) into bits[c]: the sweep kernels'
// prologue. The block's threads form groups of ess_group lanes, a chunk a
// group (in passes while the chunks outnumber the groups), so that the
// whole block shares the test; with `out` also at the bitmap's index. Every
// thread calls it, nthreads a multiple of 32; the caller makes the bits
// visible with a barrier.
__device__ __forceinline__ void ess_tile_bits(
    const EssParams& g, const float* __restrict__ pmin,
    const float* __restrict__ pmax, const float* __restrict__ zs,
    const float* t, int ty, int tx, unsigned char* bits, unsigned char* out,
    int tid, int nthreads) {
  const int n_chunks = (g.n_planes + g.plane_chunk - 1) / g.plane_chunk;
  const int G = ess_group(n_chunks, nthreads);
  const int sub = tid & (G - 1);
  const int groups = nthreads / G;
  // every lane takes every pass (the shuffles need the whole warp); a group
  // past the last chunk repeats it and writes nothing
  for (int base = 0; base < n_chunks; base += groups) {
    const int c = base + tid / G;
    const bool live = ess_chunk_live(g, pmin, pmax, zs, t,
                                     min(c, n_chunks - 1), ty, tx, sub, G);
    if (sub == 0 && c < n_chunks) {
      bits[c] = live ? 1 : 0;
      if (out != nullptr) out[ess_index(g, c, ty, tx)] = live ? 1 : 0;
    }
  }
}

// Tracing: one thread of the block adds its tile's pairs and live pairs
// (the bytes ess_tile_bits wrote, after the barrier that made them visible)
// to g.counts; two atomics a block, none while g.counts is null.
__device__ __forceinline__ void ess_count(const EssParams& g,
                                          const unsigned char* bits,
                                          int tid) {
  if (g.counts == nullptr || tid != 0) return;
  const int n_chunks = (g.n_planes + g.plane_chunk - 1) / g.plane_chunk;
  unsigned long long live = 0;
  for (int c = 0; c < n_chunks; ++c) live += bits[c];
  atomicAdd(g.counts, (unsigned long long)n_chunks);
  atomicAdd(g.counts + 1, live);
}

}  // namespace vrdd
