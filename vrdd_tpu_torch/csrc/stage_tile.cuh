// Staged fetch shared by the forward sweep (slice_sweep.cu: K1-K4) and the
// reverse sweep (slice_vjp_staged.cu: K5): a block's footprint on one plane
// is copied into shared memory with cp.async and decoded there once, and its
// rays resample their four taps from the decoded tile.
//
// The footprint. axis_taps (sweep_common.cuh) is a chain of correctly
// rounded, monotone operations of a ray's slope, and the slope of ray (i, j)
// is monotone in j (x) and in i (y). So over a block the extreme taps on a
// plane are those of its corner rays: block_rect computes the exact tap
// rectangle [x_lo, x_hi] x [y_lo, y_hi] from the first and the last valid
// ray of the block, with the same arithmetic as plane_taps. The wrapper
// (kernels/slice_kernel.py stage_bound) bounds its size over every plane of
// the launch on the host and sizes shared memory from that bound (tw_b x
// th_b voxels); a plane whose rectangle would not fit (a geometry the host
// bound missed) is fetched directly, tap by tap, with the same bits. Warp 0
// plans 32 planes at once, a lane each (plan_batch), with a mask of the
// planes some ray of the block samples: the kernels visit only those, and a
// plane no ray samples costs no barrier.
//
// The copies. Each staged row (one bin of one voxel row) is copied in 16-byte
// cp.async chunks from the 16-byte boundary at or below its first element,
// so any row stride works (odd nx, bf16); rowoff records where the row's
// x_lo landed. A chunk only covers bytes of an aligned 16-byte block that
// holds a byte of the row, so it never leaves the row's pages.
//
// The decode runs the one chain of sweep_common.cuh (decode, decode_var)
// over the tile: each footprint voxel's value is bitwise the value the
// direct path computes at each of its taps.

#pragma once

#include <stdint.h>

#include "sweep_common.cuh"

namespace vrdd {

// A plane's footprint: nothing to stage (no ray of the block can sample the
// plane, or its ESS chunk is culled), staged, or fetched directly.
enum FootKind { kSkip = 0, kStaged = 1, kDirect = 2 };

struct Foot {
  int x_lo, y_lo, tw, th, layer, kind;
};

// Byte offsets of the staged kernels' dynamic shared memory: `nslot` ring
// slots of raw rows, the LUT, the decode rows, the decoded tile, the slots'
// row offsets, then `extra` bytes of the kernel's own. The wrapper's
// kernels/slice_kernel.py stage_smem_bytes mirrors it.
struct StageLayout {
  int rc;  // 16-byte chunks per staged row
  size_t ring, off_lut, off_rows, off_dec, off_rowoff, off_extra, total;
};

__host__ __device__ inline StageLayout stage_layout(int tw_b, int th_b, int B,
                                                    int es, int n_lut,
                                                    int row_floats, int nslot,
                                                    size_t extra) {
  StageLayout l;
  l.rc = (tw_b * es + 30) / 16;
  l.ring = (size_t)th_b * B * l.rc * 16;
  l.off_lut = nslot * l.ring;
  l.off_rows = l.off_lut + 4 * sizeof(float) * (size_t)n_lut;
  l.off_dec = l.off_rows + sizeof(float) * (size_t)row_floats;
  l.off_rowoff = l.off_dec + sizeof(float) * (size_t)tw_b * th_b;
  l.off_extra = l.off_rowoff + nslot * sizeof(int) * (size_t)th_b * B;
  l.total = l.off_extra + extra;
  return l;
}

// The tap rectangle on the plane at depth z of the rays between `ra` (the
// block's first valid ray) and `rb` (its last): false when none of them can
// sample the plane (behind the camera, or every ray outside the box on one
// axis). The position in the box is monotone in the slope too, so no ray is
// inside on an axis exactly when both corners are outside on the same side.
__device__ __forceinline__ bool block_rect(const SweepParams& p, float z,
                                           const Ray& ra, const Ray& rb,
                                           int& x_lo, int& x_hi, int& y_lo,
                                           int& y_hi) {
  const bool in_front = p.dz_sign < 0 ? (z < p.oz) : (z > p.oz);
  if (!in_front) return false;
  const float dz = __fsub_rn(z, p.oz);
  const bool linear = p.filter_linear != 0;
  const float xa = __fadd_rn(p.ox, __fmul_rn(dz, ra.mx));
  const float xb = __fadd_rn(p.ox, __fmul_rn(dz, rb.mx));
  const float ya = __fadd_rn(p.oy, __fmul_rn(dz, ra.my));
  const float yb = __fadd_rn(p.oy, __fmul_rn(dz, rb.my));
  int a0, a1, b0, b1;
  float w0, w1;
  axis_taps(xa, p.nx, p.xlo, p.xhi, p.sx, p.tex_offset, linear, a0, a1, w0,
            w1);
  axis_taps(xb, p.nx, p.xlo, p.xhi, p.sx, p.tex_offset, linear, b0, b1, w0,
            w1);
  x_lo = min(a0, b0);
  x_hi = max(a1, b1);
  axis_taps(ya, p.ny, p.ylo, p.yhi, p.sy, p.tex_offset, linear, a0, a1, w0,
            w1);
  axis_taps(yb, p.ny, p.ylo, p.yhi, p.sy, p.tex_offset, linear, b0, b1, w0,
            w1);
  y_lo = min(a0, b0);
  y_hi = max(a1, b1);
  const float pxa = axis_p01(xa, p.xlo, p.xhi), pxb = axis_p01(xb, p.xlo, p.xhi);
  const float pya = axis_p01(ya, p.ylo, p.yhi), pyb = axis_p01(yb, p.ylo, p.yhi);
  const bool out_x = (pxa < 0.0f && pxb < 0.0f) || (pxa > 1.0f && pxb > 1.0f);
  const bool out_y = (pya < 0.0f && pyb < 0.0f) || (pya > 1.0f && pyb > 1.0f);
  return !(out_x || out_y);
}

// The footprint of plane k for the block whose corner rays are ra, rb.
// ess_blk: the block's byte of ESS chunk 0 (chunk c is c * ess_stride bytes
// on), or null.
__device__ __forceinline__ Foot plan_plane(const SweepParams& p,
                                           const float* __restrict__ zs, int k,
                                           const Ray& ra, const Ray& rb,
                                           int tw_b, int th_b,
                                           const unsigned char* ess_blk,
                                           size_t ess_stride, int ess_chunk) {
  Foot f;
  f.x_lo = f.y_lo = f.tw = f.th = f.layer = 0;
  f.kind = kSkip;
  if (k < 0 || k >= p.n_planes) return f;
  if (ess_blk != nullptr && ess_blk[(size_t)(k / ess_chunk) * ess_stride] == 0)
    return f;
  int xl, xh, yl, yh;
  if (!block_rect(p, __ldg(zs + k), ra, rb, xl, xh, yl, yh)) return f;
  f.x_lo = xl;
  f.y_lo = yl;
  f.tw = xh - xl + 1;
  f.th = yh - yl + 1;
  f.layer = p.reverse ? p.n_layers - 1 - k : k;
  f.kind = (f.tw <= tw_b && f.th <= th_b) ? kStaged : kDirect;
  return f;
}

// Planes are planned kPlanBatch at a time, one per lane of warp 0.
constexpr int kPlanBatch = 32;

// Warp 0 (threads 0-31 of the block) plans planes [kb, kb + 32) into
// feet[0..31] and sets bit l of *visit where plane kb + l has a sample to
// take (staged or direct). The caller makes it visible with a barrier.
__device__ __forceinline__ void plan_batch(const SweepParams& p,
                                           const float* __restrict__ zs,
                                           int kb, const Ray& ra,
                                           const Ray& rb, int tw_b, int th_b,
                                           const unsigned char* ess_blk,
                                           size_t ess_stride, int ess_chunk,
                                           int tid, Foot* feet,
                                           unsigned* visit) {
  if (tid >= kPlanBatch) return;
  const Foot f = plan_plane(p, zs, kb + tid, ra, rb, tw_b, th_b, ess_blk,
                            ess_stride, ess_chunk);
  feet[tid] = f;
  const unsigned m = __ballot_sync(0xffffffffu, f.kind != kSkip);
  if (tid == 0) *visit = m;
}

// Exact n / d for 0 <= n < 2^16 and 1 <= d < 2^16 by one multiply-high
// (m = floor((2^32 - 1) / d) + 1), instead of an integer division.
struct FastDiv {
  unsigned m;
  int d;
  __device__ __forceinline__ explicit FastDiv(int d_)
      : m(d_ > 1 ? 0xFFFFFFFFu / (unsigned)d_ + 1u : 0u), d(d_) {}
  __device__ __forceinline__ int operator()(int n) const {
    return d > 1 ? (int)__umulhi((unsigned)n, m) : n;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue this thread's share of the copies of footprint f (B bins of each
// voxel row) into ring slot `dst`; row r = b * f.th + (y - y_lo) starts at
// dst + r * rc * 16 and its x_lo sits rowoff[r] elements into the slot.
// Each row's chunks take a power-of-two run of consecutive threads.
template <typename T>
__device__ __forceinline__ void stage_issue(const SweepParams& p,
                                            const T* __restrict__ vol, int B,
                                            const Foot& f, int rc,
                                            unsigned char* dst, int* rowoff,
                                            int tid, int nthreads) {
  constexpr int es = (int)sizeof(T);
  const int rcp = (f.tw * es + 30) / 16;  // chunks this footprint needs, >= 2
  const int lg = 32 - __clz(rcp - 1);     // ceil(log2(rcp))
  const int n = (f.th * B) << lg;
  const FastDiv by_th(f.th);
  const size_t plane_elems = (size_t)p.ny * (size_t)p.nx;
  const T* layer = vol + (size_t)f.layer * B * plane_elems +
                   (size_t)f.y_lo * p.nx + f.x_lo;
  for (int t = tid; t < n; t += nthreads) {
    const int r = t >> lg, c = t & ((1 << lg) - 1);
    if (c >= rcp) continue;
    const int b = by_th(r);
    const T* row = layer + (size_t)b * plane_elems +
                   (size_t)(r - b * f.th) * p.nx;
    const uintptr_t start = reinterpret_cast<uintptr_t>(row);
    const uintptr_t a16 = start & ~(uintptr_t)15;
    const uintptr_t src = a16 + 16 * (uintptr_t)c;
    if (src < start + (uintptr_t)f.tw * es)
      cp_async16(dst + ((size_t)r * rc + c) * 16,
                 reinterpret_cast<const void*>(src));
    if (c == 0) rowoff[r] = (r * rc * 16 + (int)(start - a16)) / es;
  }
}

// Decode the landed footprint f from ring slot `src` into the f32 tile dec
// ((y - y_lo) * f.tw + (x - x_lo)). With MOMT (K5, variance mode, volume
// cotangent) also each voxel's chain moments m and 2(mC0 - C1) into mt, et.
// `uniform`: every row of a plane starts at the same 16-byte phase (nx and
// ny * nx elements are multiples of 16 bytes), so bin b of a voxel sits a
// fixed stride after bin b - 1 and the row offsets need not be read.
template <int MODE, typename T, bool MOMT>
__device__ __forceinline__ void stage_decode(const unsigned char* src,
                                             const int* rowoff, int rc, int B,
                                             const Foot& f, bool uniform,
                                             const float* __restrict__ rows,
                                             float* dec, float* mt, float* et,
                                             int tid, int nthreads) {
  const T* s = reinterpret_cast<const T*>(src);
  const int n = f.tw * f.th;
  const FastDiv by_tw(f.tw);
  const int rstride = rc * 16 / (int)sizeof(T);  // elements per staged row
  const int bstride = f.th * rstride;            // ... per bin
  const int s0 = rowoff[0];
  for (int v = tid; v < n; v += nthreads) {
    const int yy = by_tw(v), xx = v - yy * f.tw;
    const int base = s0 + yy * rstride + xx;
    auto hu = [&](int b) { return widen(s[base + b * bstride]); };
    auto hr = [&](int b) { return widen(s[rowoff[b * f.th + yy] + xx]); };
    if (MOMT && MODE == kVar) {
      float m, c1, c0;
      dec[v] = uniform ? decode_var(hu, B, rows, m, c1, c0)
                       : decode_var(hr, B, rows, m, c1, c0);
      mt[v] = m;
      et[v] = chain_e(m, c1, c0);
    } else {
      dec[v] = uniform ? decode<MODE>(hu, B, rows) : decode<MODE>(hr, B, rows);
    }
  }
}

// Whether every staged row of a plane starts at the same 16-byte phase.
__device__ __forceinline__ bool rows_uniform(const SweepParams& p, int es) {
  return ((size_t)p.nx * es) % 16 == 0 &&
         ((size_t)p.ny * p.nx * es) % 16 == 0;
}

// The resample of a scalar plane (B = 1) straight from its raw ring slot
// `s`, whose row y - y_lo starts rowoff[y - y_lo] elements in: the values
// the direct path loads, widened the same way.
template <typename T>
__device__ __forceinline__ float resample_raw(const T* s, const int* rowoff,
                                              const Foot& f, const Taps& t) {
  const T* r0 = s + rowoff[t.y0 - f.y_lo] - f.x_lo;
  const T* r1 = s + rowoff[t.y1 - f.y_lo] - f.x_lo;
  return bilerp(t, widen(r0[t.x0]), widen(r0[t.x1]), widen(r1[t.x0]),
                widen(r1[t.x1]));
}

// Tile index of tap (y, x) of footprint f.
__device__ __forceinline__ int tile_index(const Foot& f, int y, int x) {
  return (y - f.y_lo) * f.tw + (x - f.x_lo);
}

// The resample from the decoded tile: the same four values and the same
// bilerp as the direct path's resample.
__device__ __forceinline__ float resample_tile(const float* dec,
                                               const Foot& f, const Taps& t) {
  return bilerp(t, dec[tile_index(f, t.y0, t.x0)],
                dec[tile_index(f, t.y0, t.x1)],
                dec[tile_index(f, t.y1, t.x0)],
                dec[tile_index(f, t.y1, t.x1)]);
}

}  // namespace vrdd
