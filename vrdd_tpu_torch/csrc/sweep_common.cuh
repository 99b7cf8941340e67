// Per-sample arithmetic shared by the forward sweep (slice_sweep.cu: K1-K4)
// and the reverse sweep (slice_vjp.cu: K5).
//
// The backward replays the forward's transmittance recursion from the
// checkpoints K4 wrote, and its freeze masks must come out bitwise equal
// (vrdd_tpu/pallas/slice_vjp.py:329-333). So everything that feeds a
// sample's alpha lives here, once, and is written with the explicitly
// rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fmaf_rn): nvcc
// never contracts those into other FMAs, so the same source gives the same
// bits in every kernel that inlines it, whatever the code around it.
//
// Counterparts in the JAX package: _tent_weights (slice_kernel.py:222),
// _decode_block (:586), the tent-basis TF of march/slice.py, and the
// alpha expression of _make_kernel (:1039).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

// Must match SweepParams in vrdd_tpu_torch/kernels/_build.py field for
// field. Outside any anonymous namespace: the exported C entry points take it.
struct SweepParams {
  float ox, oy, oz;
  float density, brightness, tf_off, tf_scale, spacing;
  float mx0, dmx, my0, dmy;
  float xlo, ylo, xhi, yhi;
  float tstep, threshold, tex_offset, sx, sy;
  int height, width, ny, nx;
  int n_planes, n_layers, n_lut, n_bins, n_rows;
  int dz_sign, reverse, length_correction, filter_linear;
};

namespace vrdd {

enum DecodeMode { kNone = 0, kLinear = 1, kVar = 2, kEntropy = 3 };

// smallest positive value fed to log2 in the entropy decode; it only ever
// multiplies an exactly-zero bin (vrdd_tpu/pallas/slice_kernel.py _ENT_TINY)
constexpr float kEntTiny = 1e-30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Per-ray constants: the slope (mx, my) of ray (i, j) and its opacity scale,
// the slab length spacing * |d| / |d_z| over tstep. Rounded as the plain
// version's numpy float32 grid (mul, then add).
struct Ray {
  float mx, my, ascale;
};

__device__ __forceinline__ Ray make_ray(const SweepParams& p, int i, int j) {
  Ray r;
  r.mx = __fadd_rn(p.mx0, __fmul_rn(p.dmx, (float)j));
  r.my = __fadd_rn(p.my0, __fmul_rn(p.dmy, (float)i));
  if (p.length_correction) {
    const float s2 =
        __fadd_rn(__fadd_rn(1.0f, __fmul_rn(r.my, r.my)), __fmul_rn(r.mx, r.mx));
    r.ascale = __fdiv_rn(__fmul_rn(p.spacing, sqrtf(s2)), p.tstep);
  } else {
    r.ascale = 1.0f;
  }
  return r;
}

// Two tent taps of one axis (slice_kernel.py _tent_weights): q is the
// clamped filter coordinate, w0/w1 the weights of texels i0 and i1 = i0 + 1
// (w1 == 0 when i0 is the last texel); returns the coverage predicate.
// The coordinate's position in the box, [0, 1] inside: a chain of correctly
// rounded operations, monotone in the coordinate.
__device__ __forceinline__ float axis_p01(float coord, float lo, float hi) {
  return __fdiv_rn(__fsub_rn(coord, lo), __fsub_rn(hi, lo));
}

__device__ __forceinline__ bool axis_taps(float coord, int n, float lo,
                                          float hi, float scale,
                                          float tex_offset, bool linear,
                                          int& i0, int& i1, float& w0,
                                          float& w1) {
  const float p01 = axis_p01(coord, lo, hi);
  float q = __fsub_rn(__fmul_rn(p01, __fmul_rn((float)n, scale)), tex_offset);
  q = fminf(fmaxf(q, 0.0f), (float)(n - 1));
  if (!linear) q = floorf(__fadd_rn(q, 0.5f));
  const float f = floorf(q);
  i0 = (int)f;
  i1 = min(i0 + 1, n - 1);
  w0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(q, f))));
  w1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(q, __fadd_rn(f, 1.0f)))));
  return p01 >= 0.0f && p01 <= 1.0f;
}

// The four resample taps of one ray on one plane.
struct Taps {
  int x0, x1, y0, y1;
  float wx0, wx1, wy0, wy1;
};

// Taps of ray `r` on the plane at depth z; false when the plane is behind
// the camera or the ray misses the box there (alpha exactly 0).
__device__ __forceinline__ bool plane_taps(const SweepParams& p, float z,
                                           const Ray& r, Taps& t) {
  const bool in_front = p.dz_sign < 0 ? (z < p.oz) : (z > p.oz);
  if (!in_front) return false;
  const float dz = __fsub_rn(z, p.oz);
  const float xw = __fadd_rn(p.ox, __fmul_rn(dz, r.mx));
  const float yw = __fadd_rn(p.oy, __fmul_rn(dz, r.my));
  const bool linear = p.filter_linear != 0;
  const bool in_x = axis_taps(xw, p.nx, p.xlo, p.xhi, p.sx, p.tex_offset,
                              linear, t.x0, t.x1, t.wx0, t.wx1);
  const bool in_y = axis_taps(yw, p.ny, p.ylo, p.yhi, p.sy, p.tex_offset,
                              linear, t.y0, t.y1, t.wy0, t.wy1);
  return in_x && in_y;
}

// Variance decode of one voxel whose bin b is h(b), rows [m, s*e, s*e^2, s]:
// dec = C2 - 2 m C1 + m^2 C0, with the moments m, C1, C0 handed back for
// the backward's chain (d h_b = rows2 - 2m rows1 + m^2 rows3 + 2(mC0-C1) rows0).
template <typename Get>
__device__ __forceinline__ float decode_var(Get h, int B,
                                            const float* __restrict__ rows,
                                            float& m, float& c1, float& c0) {
  float c2 = 0.0f;
  m = c1 = c0 = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float hb = h(b);
    m = __fmaf_rn(rows[b], hb, m);
    c1 = __fmaf_rn(rows[B + b], hb, c1);
    c2 = __fmaf_rn(rows[2 * B + b], hb, c2);
    c0 = __fmaf_rn(rows[3 * B + b], hb, c0);
  }
  return __fadd_rn(__fsub_rn(c2, __fmul_rn(__fmul_rn(2.0f, m), c1)),
                   __fmul_rn(__fmul_rn(m, m), c0));
}

// The scalar value of one voxel whose bin b is h(b) (widened to f32): the
// plane value itself, or the decode of its B bins. The one decode chain of
// every kernel, whether the bins come from device memory (tap) or from a
// staged tile in shared memory (stage_tile.cuh): K5's replay rebuilds K4's
// freeze masks from it bitwise. A length-B dot product of __fmaf_rn, on the
// FP32 units: a tensor-core product would round it otherwise.
template <int MODE, typename Get>
__device__ __forceinline__ float decode(Get h, int B,
                                        const float* __restrict__ rows) {
  if (MODE == kNone) return h(0);
  if (MODE == kLinear) {
    float acc = __fmul_rn(rows[0], h(0));
    for (int b = 1; b < B; ++b) acc = __fmaf_rn(rows[b], h(b), acc);
    return acc;
  }
  if (MODE == kVar) {
    float m, c1, c0;
    return decode_var(h, B, rows, m, c1, c0);
  }
  // entropy: rows[0] = 1 / log2(B); exactly 0 at h == 0
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float hb = h(b);
    acc = __fmaf_rn(-hb, log2f(fmaxf(hb, kEntTiny)), acc);
  }
  return __fmul_rn(rows[0], acc);
}

// The chain moments [m, 2(mC0 - C1)] of a variance decode.
__device__ __forceinline__ float chain_e(float m, float c1, float c0) {
  return __fmul_rn(2.0f, __fsub_rn(__fmul_rn(m, c0), c1));
}

// One tap voxel at element offset `off` of layer `layer` (bins-major: bin b
// sits plane_elems elements after bin b - 1). With MOM (the backward,
// variance mode) it also writes the voxel's chain moments to mom (nz, 2, ny,
// nx): every thread that decodes a voxel writes the same two values, so the
// race is benign.
template <int MODE, typename T, bool MOM>
__device__ __forceinline__ float tap(const SweepParams& p,
                                     const T* __restrict__ base, size_t off,
                                     size_t plane_elems, int B,
                                     const float* __restrict__ rows,
                                     int layer, float* __restrict__ mom) {
  const T* v = base + off;
  auto h = [&](int b) { return widen(v[(size_t)b * plane_elems]); };
  if (MOM && MODE == kVar) {
    float m, c1, c0;
    const float dec = decode_var(h, B, rows, m, c1, c0);
    float* mp = mom + (size_t)layer * 2 * plane_elems + off;
    mp[0] = m;
    mp[plane_elems] = chain_e(m, c1, c0);
    return dec;
  }
  return decode<MODE>(h, B, rows);
}

// The bilinear combination of four tap values, y first, then x (the order
// of the plain version's two matmuls).
__device__ __forceinline__ float bilerp(const Taps& t, float v00, float v01,
                                        float v10, float v11) {
  const float c0 = __fmaf_rn(t.wy1, v10, __fmul_rn(t.wy0, v00));
  const float c1 = __fmaf_rn(t.wy1, v11, __fmul_rn(t.wy0, v01));
  return __fmaf_rn(c1, t.wx1, __fmul_rn(c0, t.wx0));
}

// Bilinear resample of layer `layer` at the taps, fetching each tap from
// device memory (the direct path). Decode modes decode each tap voxel from
// its bins first: variance and entropy are nonlinear.
template <int MODE, typename T, bool MOM = false>
__device__ __forceinline__ float resample(const SweepParams& p,
                                          const T* __restrict__ vol,
                                          int layer, const Taps& t,
                                          const float* __restrict__ rows,
                                          float* __restrict__ mom = nullptr) {
  const int B = MODE == kNone ? 1 : p.n_bins;
  const size_t plane_elems = (size_t)p.ny * (size_t)p.nx;
  const T* base = vol + (size_t)layer * plane_elems * (size_t)B;
  const size_t r0 = (size_t)t.y0 * p.nx, r1 = (size_t)t.y1 * p.nx;
  const float v00 =
      tap<MODE, T, MOM>(p, base, r0 + t.x0, plane_elems, B, rows, layer, mom);
  const float v01 =
      tap<MODE, T, MOM>(p, base, r0 + t.x1, plane_elems, B, rows, layer, mom);
  const float v10 =
      tap<MODE, T, MOM>(p, base, r1 + t.x0, plane_elems, B, rows, layer, mom);
  const float v11 =
      tap<MODE, T, MOM>(p, base, r1 + t.x1, plane_elems, B, rows, layer, mom);
  return bilerp(t, v00, v01, v10, v11);
}

// Clamped linear LUT lookup in the tent basis: two nonzero taps l0, l1
// with weights ta, tb. qraw is the unclamped coordinate (its interior
// (0, n-1) is where the lookup has a slope).
struct Tent {
  int l0, l1;
  float ta, tb, qraw;
};

__device__ __forceinline__ Tent tent(const SweepParams& p, float res) {
  const float n = (float)p.n_lut;
  Tent t;
  t.qraw = __fsub_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(res, p.tf_off), p.tf_scale), n), 0.5f);
  const float q = fminf(fmaxf(t.qraw, 0.0f), n - 1.0f);
  const float fl = floorf(q);
  t.l0 = (int)fl;
  t.l1 = min(t.l0 + 1, p.n_lut - 1);
  t.ta = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(q, fl))));
  t.tb = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(q, __fadd_rn(fl, 1.0f)))));
  return t;
}

// Channel c of the looked-up colour; lut is (n_lut, 4) row-major.
__device__ __forceinline__ float lut_channel(const float* __restrict__ lut,
                                             const Tent& t, int c) {
  return __fmaf_rn(t.tb, lut[4 * t.l1 + c], __fmul_rn(t.ta, lut[4 * t.l0 + c]));
}

// Unclamped opacity of a sample: TF alpha x density x slab-length scale.
// The one expression K4 and K5 both evaluate; alpha is fminf(raw, 1).
__device__ __forceinline__ float alpha_raw(float ca, float density,
                                           float ascale) {
  return __fmul_rn(__fmul_rn(ca, density), ascale);
}

// One step of the backward's transmittance recursion
// T <- T - [T >= 1 - thr] T a  (thr1 = 1 - thr), the same in K4 and K5.
__device__ __forceinline__ float t_step(float T, float a, float thr1) {
  return T >= thr1 ? __fsub_rn(T, __fmul_rn(T, a)) : T;
}

}  // namespace vrdd
