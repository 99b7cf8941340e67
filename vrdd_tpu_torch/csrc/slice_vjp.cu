// K5: the reverse sweep of the differentiable slice sweep, for Hopper
// (sm_90a).
//
// Replaces the backward Pallas launch vrdd_tpu/pallas/slice_vjp.py:787
// (_make_diff_sweep._bwd_call, body _make_bwd_kernel :127). The plain torch
// version is the analytic VJP of vrdd_tpu_torch/march/slice.py
// (_AnalyticSweep); the wrapper is kernels/slice_vjp.py sweep_bwd.
//
// With per-plane premultiplied colours c_k = (col_rgb a_k, a_k), prefix
// transmittance T_{k-1}, freeze mask m_k = [T_{k-1} >= 1 - thr] and
// P_k = m_k (g . c_k) T_{k-1}, the cotangents are
//     dL/dc_k[rgb] = m_k T_{k-1} g[rgb]
//     dL/dc_k[a]   = m_k (T_{k-1} g[a] - S_k / (1 - a_k)),  S_k = sum_{j>k} P_j
// so one back-to-front walk per ray gets S_k for free, and T_{k-1} comes
// from replaying the chunk front to back from K4's checkpoint.
//
// Design: one thread per ray, as the forward. Per ray, the chunks of CK
// planes are walked back to front. A chunk whose checkpointed T is below
// 1 - thr is skipped: the ray was frozen there, so it and every later chunk
// contribute exactly zero. Otherwise the chunk is replayed front to back
// with the shared sample code of sweep_common.cuh (so T and the freeze
// masks are bitwise the forward's), caching T, the resampled value and the
// TF alpha in registers (CK is a template constant: 4 or 8), and then the
// reverse loop of slice_vjp.py:403-492 runs on the cached values. The
// cotangent of the resampled value is scattered to the <= 4 tap voxels
// with f32 atomicAdd into a zero-filled d_planes, at layer nz-1-p when the
// walk is reversed (no flip copy on either side). In the decode modes the
// taps are re-decoded from their bins and d_planes is the decoded-plane
// cotangent d_dec; the chain to the histograms is plain torch
// (kernels/slice_vjp.py), with the variance moments written here.
//
// LUT and render-parameter cotangents accumulate per thread in the tent
// basis (only the two live LUT taps) into the thread's own column of shared
// memory, are summed per block in a fixed order and written as per-block
// partials that torch sums: deterministic, run to run. Only d_planes uses
// atomics, so it is reproducible to rounding, not bitwise.
//
// `wrt` pruning: GVOL compiles the d_planes scatter in or out, GSMALL the
// LUT and parameter accumulation; pruned outputs stay zero.
//
// Bound on the H100: load issue and latency, in three parts of about equal
// cost at 512^3 x 16 bf16 -> 1024^2 (mean, 20.5 ms on an H100 80GB HBM3 at
// 700 W): the replay re-reads and re-decodes the forward's samples (the
// histogram stream again, through L1/L2; about what K4 costs), the scatter
// issues up to 4 atomics per live sample into d_planes, which neighbouring
// rays hit at the same addresses (6.5 ms), and the LUT sums make 8 shared
// read-modify-writes per live sample (7.2 ms). Left for later: a warp-level
// reduction per LUT tap, and decoding each voxel once per block.

#include "sweep_common.cuh"

// Must match BwdParams in vrdd_tpu_torch/kernels/_build.py field for field.
struct BwdParams {
  int ck_stride, n_chunks, g_planes, g_lut, g_params;
};

namespace {

using namespace vrdd;

constexpr int kBwdX = 32, kBwdY = 4, kBwdThreads = kBwdX * kBwdY;

template <int MODE, typename T, int CK, bool GVOL, bool GSMALL>
__global__ void __launch_bounds__(kBwdThreads)
slice_bwd_kernel(const SweepParams p, const BwdParams bp,
                 const T* __restrict__ vol, const float* __restrict__ zs,
                 const float* __restrict__ lut,
                 const float* __restrict__ rows,
                 const float* __restrict__ g, const float* __restrict__ tck,
                 float* __restrict__ d_planes, float* __restrict__ partials,
                 float* __restrict__ mom) {
  extern __shared__ float smem[];
  const int n_small = 4 * p.n_lut + 3;
  float* s_lut = smem;                                   // (n_lut, 4)
  float* s_rows = s_lut + 4 * p.n_lut;                   // (n_rows, B)
  float* s_acc = s_rows + (MODE == kNone ? 0 : p.n_rows * p.n_bins);
  // s_acc: (n_small, kBwdThreads), one column per thread
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < 4 * p.n_lut; t += kBwdThreads) s_lut[t] = lut[t];
  if (MODE != kNone)
    for (int t = tid; t < p.n_rows * p.n_bins; t += kBwdThreads)
      s_rows[t] = rows[t];
  if (GSMALL)
    for (int e = 0; e < n_small; ++e) s_acc[e * kBwdThreads + tid] = 0.0f;
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  float d_dens = 0.0f, d_toff = 0.0f, d_tscl = 0.0f;
  if (i < p.height && j < p.width) {
    const Ray ray = make_ray(p, i, j);
    const size_t pix = (size_t)i * p.width + j;
    const size_t hw = (size_t)p.height * p.width;
    const float4 gv = reinterpret_cast<const float4*>(g)[pix];
    const float thr1 = __fsub_rn(1.0f, p.threshold);
    const float abd = p.density * ray.ascale;  // d raw / d col_a
    const float nl = (float)p.n_lut;
    const size_t plane_elems = (size_t)p.ny * (size_t)p.nx;
    const bool g_lut = GSMALL && bp.g_lut;
    const bool g_par = GSMALL && bp.g_params;
    float S = 0.0f;  // suffix sum of P_j over the planes behind

    for (int kk = bp.n_chunks - 1; kk >= 0; --kk) {
      const float t0 = tck[(size_t)kk * hw + pix];
      if (!(t0 >= thr1)) continue;  // frozen: this chunk contributes 0

      // replay front to back: T before each plane, res and TF alpha
      float tk[CK], resk[CK], cak[CK];
      unsigned live = 0u;
      float tr = t0;
#pragma unroll
      for (int ii = 0; ii < CK; ++ii) {
        tk[ii] = tr;
        resk[ii] = 0.0f;
        cak[ii] = 0.0f;
        const int k = kk * CK + ii;
        if (k >= p.n_planes || !(tr >= thr1)) continue;
        Taps tp;
        if (!plane_taps(p, __ldg(zs + k), ray, tp)) continue;
        const int layer = p.reverse ? p.n_layers - 1 - k : k;
        const float res =
            resample<MODE, T, GVOL>(p, vol, layer, tp, s_rows, mom);
        const float ca = lut_channel(s_lut, tent(p, res), 3);
        resk[ii] = res;
        cak[ii] = ca;
        live |= 1u << ii;
        tr = t_step(tr, fminf(alpha_raw(ca, p.density, ray.ascale), 1.0f),
                    thr1);
      }

      // reverse loop (slice_vjp.py:403-492) on the cached values
#pragma unroll
      for (int ii = CK - 1; ii >= 0; --ii) {
        if (!((live >> ii) & 1u)) continue;
        const int k = kk * CK + ii;
        const float T0 = tk[ii];
        const float res = resk[ii], ca = cak[ii];
        const Tent tn = tent(p, res);
        const float raw = alpha_raw(ca, p.density, ray.ascale);
        const float a = fminf(raw, 1.0f);
        const float cr = lut_channel(s_lut, tn, 0);
        const float cg = lut_channel(s_lut, tn, 1);
        const float cb = lut_channel(s_lut, tn, 2);
        const float gc3 = gv.x * cr + gv.y * cg + gv.z * cb;  // g . col_rgb
        const float one_minus_a = 1.0f - a;
        const float chain =
            fabsf(one_minus_a) > 1e-6f ? S / one_minus_a : 0.0f;
        const float d_a = T0 * gv.w - chain + T0 * gc3;
        S += (gc3 + gv.w) * a * T0;
        const float mta = T0 * a;
        // a = min(col_a * density * ascale, 1): the clamp kills d_a
        const float d_open = raw < 1.0f ? d_a : 0.0f;
        const float d_ca = d_open * abd;
        if (g_par) d_dens += d_open * ca * ray.ascale;
        if (g_lut) {
          // tent-basis LUT cotangent: d lut[l, c] += w_l * d_col[c]
          float* e0 = s_acc + 4 * tn.l0 * kBwdThreads + tid;
          float* e1 = s_acc + 4 * tn.l1 * kBwdThreads + tid;
          const float wa = tn.ta * mta, wb = tn.tb * mta;
          e0[0] += wa * gv.x;
          e0[kBwdThreads] += wa * gv.y;
          e0[2 * kBwdThreads] += wa * gv.z;
          e0[3 * kBwdThreads] += tn.ta * d_ca;
          e1[0] += wb * gv.x;
          e1[kBwdThreads] += wb * gv.y;
          e1[2 * kBwdThreads] += wb * gv.z;
          e1[3 * kBwdThreads] += tn.tb * d_ca;
        }
        if ((GVOL || g_par) && tn.qraw > 0.0f && tn.qraw < nl - 1.0f) {
          // inside the clamp the lookup's slope is lut[l1] - lut[l0]
          const float* L0 = s_lut + 4 * tn.l0;
          const float* L1 = s_lut + 4 * tn.l1;
          const float dq =
              mta * (gv.x * (L1[0] - L0[0]) + gv.y * (L1[1] - L0[1]) +
                     gv.z * (L1[2] - L0[2])) +
              d_ca * (L1[3] - L0[3]);
          const float d_res = dq * (p.tf_scale * nl);
          if (g_par) {
            d_toff -= d_res;
            d_tscl += dq * (res - p.tf_off) * nl;
          }
          if (GVOL) {
            Taps tp;
            plane_taps(p, __ldg(zs + k), ray, tp);  // covered: replayed above
            const int layer = p.reverse ? p.n_layers - 1 - k : k;
            float* dp = d_planes + (size_t)layer * plane_elems;
            const size_t r0 = (size_t)tp.y0 * p.nx, r1 = (size_t)tp.y1 * p.nx;
            const float d0 = d_res * tp.wy0, d1 = d_res * tp.wy1;
            if (d0 * tp.wx0 != 0.0f) atomicAdd(dp + r0 + tp.x0, d0 * tp.wx0);
            if (d0 * tp.wx1 != 0.0f) atomicAdd(dp + r0 + tp.x1, d0 * tp.wx1);
            if (d1 * tp.wx0 != 0.0f) atomicAdd(dp + r1 + tp.x0, d1 * tp.wx0);
            if (d1 * tp.wx1 != 0.0f) atomicAdd(dp + r1 + tp.x1, d1 * tp.wx1);
          }
        }
      }
    }
  }
  if (GSMALL) {
    const int base = 4 * p.n_lut * kBwdThreads + tid;
    s_acc[base] = d_dens;
    s_acc[base + kBwdThreads] = d_toff;
    s_acc[base + 2 * kBwdThreads] = d_tscl;
    __syncthreads();
    // fixed-order per-block sums: deterministic partials
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    for (int e = tid; e < n_small; e += kBwdThreads) {
      float s = 0.0f;
      for (int t = 0; t < kBwdThreads; ++t) s += s_acc[e * kBwdThreads + t];
      partials[blk * n_small + e] = s;
    }
  }
}

template <int MODE, typename T, int CK, bool GVOL, bool GSMALL>
cudaError_t launch_bwd(const SweepParams& p, const BwdParams& bp,
                       const void* vol, const float* zs, const float* lut,
                       const float* rows, const float* g, const float* tck,
                       float* d_planes, float* partials, float* mom,
                       cudaStream_t stream) {
  const dim3 block(kBwdX, kBwdY);
  const dim3 grid((p.width + kBwdX - 1) / kBwdX,
                  (p.height + kBwdY - 1) / kBwdY);
  const size_t smem =
      sizeof(float) *
      (4 * (size_t)p.n_lut +
       (MODE == kNone ? 0 : (size_t)p.n_rows * p.n_bins) +
       (GSMALL ? (4 * (size_t)p.n_lut + 3) * kBwdThreads : 0));
  slice_bwd_kernel<MODE, T, CK, GVOL, GSMALL><<<grid, block, smem, stream>>>(
      p, bp, static_cast<const T*>(vol), zs, lut, rows, g, tck, d_planes,
      partials, mom);
  return cudaGetLastError();
}

template <int MODE, typename T, int CK>
cudaError_t dispatch_wrt(const SweepParams& p, const BwdParams& bp,
                         const void* vol, const float* zs, const float* lut,
                         const float* rows, const float* g, const float* tck,
                         float* d_planes, float* partials, float* mom,
                         cudaStream_t s) {
  const bool gvol = bp.g_planes != 0;
  const bool gsmall = bp.g_lut != 0 || bp.g_params != 0;
  if (gvol && gsmall)
    return launch_bwd<MODE, T, CK, true, true>(p, bp, vol, zs, lut, rows, g,
                                               tck, d_planes, partials, mom, s);
  if (gvol)
    return launch_bwd<MODE, T, CK, true, false>(p, bp, vol, zs, lut, rows, g,
                                                tck, d_planes, partials, mom, s);
  if (gsmall)
    return launch_bwd<MODE, T, CK, false, true>(p, bp, vol, zs, lut, rows, g,
                                                tck, d_planes, partials, mom, s);
  return cudaErrorInvalidValue;
}

template <int MODE, typename T>
cudaError_t dispatch_ck(const SweepParams& p, const BwdParams& bp,
                        const void* vol, const float* zs, const float* lut,
                        const float* rows, const float* g, const float* tck,
                        float* d_planes, float* partials, float* mom,
                        cudaStream_t s) {
  if (bp.ck_stride == 4)
    return dispatch_wrt<MODE, T, 4>(p, bp, vol, zs, lut, rows, g, tck,
                                    d_planes, partials, mom, s);
  if (bp.ck_stride == 8)
    return dispatch_wrt<MODE, T, 8>(p, bp, vol, zs, lut, rows, g, tck,
                                    d_planes, partials, mom, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 none, 1 linear, 2 var, 3 entropy; bf16: volume element type.
// g (H, W, 4) f32 image cotangent, tck the checkpoints K4 wrote with the
// same ck_stride. d_planes (n_layers, ny, nx) f32 zero-filled when
// bp->g_planes; partials (n_blocks, 4 n_lut + 3) when bp->g_lut or
// bp->g_params; mom (n_layers, 2, ny, nx) f32 zero-filled in variance mode
// with g_planes. Launches on `stream`; returns cudaGetLastError().
extern "C" __attribute__((visibility("default"))) int vrdd_slice_bwd(
    const SweepParams* p, const BwdParams* bp, int mode, int bf16,
    const void* vol, const float* zs, const float* lut, const float* rows,
    const float* g, const float* tck, float* d_planes, float* partials,
    float* mom, void* stream) {
  if (p->height <= 0 || p->width <= 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define VRDD_BWD(M, TYPE)                                                   \
  dispatch_ck<M, TYPE>(*p, *bp, vol, zs, lut, rows, g, tck, d_planes,       \
                       partials, mom, s)
  switch (mode * 2 + (bf16 ? 1 : 0)) {
    case 0: return (int)VRDD_BWD(kNone, float);
    case 1: return (int)VRDD_BWD(kNone, bf);
    case 2: return (int)VRDD_BWD(kLinear, float);
    case 3: return (int)VRDD_BWD(kLinear, bf);
    case 4: return (int)VRDD_BWD(kVar, float);
    case 5: return (int)VRDD_BWD(kVar, bf);
    case 6: return (int)VRDD_BWD(kEntropy, float);
    case 7: return (int)VRDD_BWD(kEntropy, bf);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VRDD_BWD
}
