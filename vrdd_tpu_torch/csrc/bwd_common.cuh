// What the two fetch paths of K5 share (slice_vjp.cu: the direct path and
// the entry point; slice_vjp_staged.cu: the staged path): the parameter
// block, the block shape, and the per-sample reverse arithmetic with its
// LUT accumulation. Both paths evaluate the same samples in the same order
// per ray with this code, written with explicitly rounded intrinsics, so
// their LUT and parameter partials are bitwise equal.

#pragma once

#include "stage_tile.cuh"

// Must match BwdParams in vrdd_tpu_torch/kernels/_build.py field for field.
// dtmp: null, or in bf16 mode (SweepParams.precision) the zeroed
// (n_planes, H, nx) row buffer the plane cotangent goes to instead of
// d_planes (scatter_row below).
struct BwdParams {
  int ck_stride, n_chunks, g_planes, g_lut, g_params;
  float* dtmp;
};

namespace vrdd {

// K5's block: 32 x 4 rays, one thread each, for both fetch paths (the LUT
// partials are per block, so the two paths' sums line up block for block).
constexpr int kBwdX = 32, kBwdY = 4, kBwdThreads = kBwdX * kBwdY;

// Per-ray parameter cotangents and the suffix sum S of P_j over the planes
// behind.
struct RevState {
  float S, d_dens, d_toff, d_tscl;
};

// The LUT cotangent of one ray over a run of samples that share a knot pair
// (l0, l1 = min(l0 + 1, n_lut - 1)), in registers; added to the thread's
// column of shared memory (stride kBwdThreads) when the pair changes and at
// the end. On smooth data consecutive samples mostly share a pair, so the
// column sees a few read-modify-writes per ray instead of 8 per sample. The
// order of the sums is fixed per ray: deterministic.
struct LutRun {
  int l0, l1;
  float e[8];  // channels 0-3 of knot l0, then of knot l1

  __device__ __forceinline__ void reset() {
    l0 = l1 = -1;
#pragma unroll
    for (int c = 0; c < 8; ++c) e[c] = 0.0f;
  }

  __device__ __forceinline__ void flush(float* col) {
    if (l0 < 0) return;
    float* c0 = col + 4 * l0 * kBwdThreads;
    float* c1 = col + 4 * l1 * kBwdThreads;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      c0[c * kBwdThreads] = __fadd_rn(c0[c * kBwdThreads], e[c]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      c1[c * kBwdThreads] = __fadd_rn(c1[c * kBwdThreads], e[4 + c]);
  }

  // d lut[l, c] += w_l * d_col[c] for the two live taps (tent basis)
  __device__ __forceinline__ void add(const Tent& tn, float mta, float4 gv,
                                      float d_ca, float* col) {
    if (tn.l0 != l0) {
      flush(col);
      reset();
      l0 = tn.l0;
      l1 = tn.l1;
    }
    const float wa = __fmul_rn(tn.ta, mta), wb = __fmul_rn(tn.tb, mta);
    e[0] = __fmaf_rn(wa, gv.x, e[0]);
    e[1] = __fmaf_rn(wa, gv.y, e[1]);
    e[2] = __fmaf_rn(wa, gv.z, e[2]);
    e[3] = __fmaf_rn(tn.ta, d_ca, e[3]);
    e[4] = __fmaf_rn(wb, gv.x, e[4]);
    e[5] = __fmaf_rn(wb, gv.y, e[5]);
    e[6] = __fmaf_rn(wb, gv.z, e[6]);
    e[7] = __fmaf_rn(tn.tb, d_ca, e[7]);
  }
};

// One live sample of the reverse loop (slice_vjp.py:403-492), planes back
// to front: T0 is the transmittance before the plane, res the resampled
// value, ca the TF alpha. Updates S, the parameter sums and the LUT run;
// returns the cotangent of the resampled value when `want_dres` (0 outside
// the LUT's interior, where the lookup has no slope).
//     dL/dc[rgb] = T0 g[rgb],  dL/dc[a] = T0 g[a] - S / (1 - a)
__device__ __forceinline__ float reverse_sample(
    const SweepParams& p, const float* __restrict__ s_lut, float4 gv,
    float T0, float res, float ca, float ascale, bool g_lut, bool g_par,
    bool want_dres, RevState& st, LutRun& run, float* col) {
  const float nl = (float)p.n_lut;
  const Tent tn = tent(p, res);
  const float raw = alpha_raw(ca, p.density, ascale);
  const float a = fminf(raw, 1.0f);
  const float cr = lut_channel(s_lut, tn, 0);
  const float cg = lut_channel(s_lut, tn, 1);
  const float cb = lut_channel(s_lut, tn, 2);
  const float gc3 =  // g . col_rgb
      __fmaf_rn(gv.z, cb, __fmaf_rn(gv.y, cg, __fmul_rn(gv.x, cr)));
  const float one_minus_a = __fsub_rn(1.0f, a);
  const float chain =
      fabsf(one_minus_a) > 1e-6f ? __fdiv_rn(st.S, one_minus_a) : 0.0f;
  const float d_a = __fadd_rn(__fsub_rn(__fmul_rn(T0, gv.w), chain),
                              __fmul_rn(T0, gc3));
  st.S = __fmaf_rn(__fmul_rn(__fadd_rn(gc3, gv.w), a), T0, st.S);
  const float mta = __fmul_rn(T0, a);
  // a = min(col_a * density * ascale, 1): the clamp kills d_a
  const float d_open = raw < 1.0f ? d_a : 0.0f;
  const float d_ca = __fmul_rn(d_open, __fmul_rn(p.density, ascale));
  if (g_par) st.d_dens = __fmaf_rn(__fmul_rn(d_open, ca), ascale, st.d_dens);
  if (g_lut) run.add(tn, mta, gv, d_ca, col);
  if (!want_dres || !(tn.qraw > 0.0f && tn.qraw < nl - 1.0f)) return 0.0f;
  // inside the clamp the lookup's slope is that of the knot interval below
  // q, JAX's c_0 + sum_l c_l [q > l] (vrdd_tpu/pallas/slice_vjp.py:466): at
  // a knot (q an integer, frequent in the bf16 mode) the interval that ends
  // there, not the one that starts there
  const int ls = tn.qraw == floorf(tn.qraw) ? tn.l0 - 1 : tn.l0;
  const float* L0 = s_lut + 4 * ls;
  const float* L1 = L0 + 4;
  const float grgb = __fmaf_rn(
      gv.z, __fsub_rn(L1[2], L0[2]),
      __fmaf_rn(gv.y, __fsub_rn(L1[1], L0[1]),
                __fmul_rn(gv.x, __fsub_rn(L1[0], L0[0]))));
  const float dq =
      __fmaf_rn(d_ca, __fsub_rn(L1[3], L0[3]), __fmul_rn(mta, grgb));
  const float d_res = __fmul_rn(dq, __fmul_rn(p.tf_scale, nl));
  if (g_par) {
    st.d_toff = __fsub_rn(st.d_toff, d_res);
    st.d_tscl = __fmaf_rn(__fmul_rn(dq, __fsub_rn(res, p.tf_off)), nl,
                          st.d_tscl);
  }
  return d_res;
}

// The bf16 mode's plane cotangent of one live sample of plane k, image row
// i: the x-transpose dtmp[k, i, :] += bf16(d_res) bf16(wx) of JAX's
// bf16 backward (vrdd_tpu/pallas/slice_vjp.py:486-492), a sum over the
// row's pixels in f32 (two atomics; a product of two bf16 values is
// exact). Its y-transpose d_plane = bf16(wy)^T bf16(dtmp) rounds the
// whole-row sums, which no per-ray scatter can do: dplane_bf16.cu.
__device__ __forceinline__ void scatter_row(const SweepParams& p,
                                            float* dtmp, int k, int i,
                                            const Taps& t, float d_res) {
  const float dr = bf16r(d_res);
  float* row = dtmp + ((size_t)k * p.height + i) * p.nx;
  const float d0 = __fmul_rn(dr, bf16r(t.wx0));
  const float d1 = __fmul_rn(dr, bf16r(t.wx1));
  if (d0 != 0.0f) atomicAdd(row + t.x0, d0);
  if (d1 != 0.0f) atomicAdd(row + t.x1, d1);
}

// Per-block partials of the LUT and parameter cotangents: each thread's
// column (its LUT run flushed, its parameter sums appended), summed over the
// block's threads in a fixed order.
__device__ __forceinline__ void block_partials(const SweepParams& p,
                                               LutRun& run, const RevState& st,
                                               float* s_acc, int tid,
                                               float* partials) {
  const int n_small = 4 * p.n_lut + 3;
  run.flush(s_acc + tid);
  const int base = 4 * p.n_lut * kBwdThreads + tid;
  s_acc[base] = st.d_dens;
  s_acc[base + kBwdThreads] = st.d_toff;
  s_acc[base + 2 * kBwdThreads] = st.d_tscl;
  __syncthreads();
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int e = tid; e < n_small; e += kBwdThreads) {
    float s = 0.0f;
    for (int t = 0; t < kBwdThreads; ++t)
      s = __fadd_rn(s, s_acc[e * kBwdThreads + t]);
    partials[blk * n_small + e] = s;
  }
}

// The staged K5 launch (slice_vjp_staged.cu) for every mode, element type,
// chunk and `wrt` combination; footprints of at most tw_b x th_b voxels.
cudaError_t launch_bwd_staged(const SweepParams& p, const BwdParams& bp,
                              int mode, int bf16, const void* vol,
                              const float* zs, const float* lut,
                              const float* rows, const float* g,
                              const float* tck, float* d_planes,
                              float* partials, float* mom, float* s_out,
                              int tw_b, int th_b, cudaStream_t stream);

}  // namespace vrdd
