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
// Design: one thread per ray, blocks of 32 x 4 rays (bwd_common.cuh).
// Per ray, the chunks of CK planes are walked back to front. A chunk whose
// checkpointed T is below 1 - thr is skipped: the ray was frozen there, so
// it and every later chunk contribute exactly zero. Otherwise the chunk is
// replayed front to back with the shared sample code of sweep_common.cuh (so
// T and the freeze masks are bitwise the forward's), caching T, the
// resampled value and the TF alpha in registers (CK is a template constant:
// 4 or 8), and then the reverse loop of slice_vjp.py:403-492 runs on the
// cached values (reverse_sample). The cotangent of the resampled value goes
// to the <= 4 tap voxels of d_planes (zero-filled; layer nz-1-p when the
// walk is reversed, no flip copy on either side). In the decode modes
// d_planes is the decoded-plane cotangent d_dec; the chain to the
// histograms is decode_chain.cu, which reads the variance moments written
// here.
//
// Two fetch paths. The direct path (slice_bwd_kernel, this file) replays
// tap by tap from device memory, as the forward's direct path, and
// scatters with up to 4 global atomicAdds per live sample. The staged path
// (slice_bwd_staged, slice_vjp_staged.cu; the wrapper's default wherever
// the footprint fits shared memory) replays block-synchronously from the
// forward's decoded shared-memory tiles, writes each touched voxel's
// variance moments once per block and plane, and scatters through a
// shared-memory d tile of the plane's footprint that it flushes with one
// global atomicAdd per voxel.
//
// What bounds it on the H100 (the direct path at 512^3 x 16 bf16 -> 1024^2,
// mean, 20.6 ms on an H100 80GB HBM3 at 700 W; PERF.md): load issue and
// latency, in three parts of about equal cost: the replay re-reads and
// re-decodes the forward's samples tap by tap, the scatter issues up to 4
// atomics per live sample into addresses neighbouring rays share, and the
// LUT sums made 8 shared read-modify-writes per live sample. The staged
// path answers the first two; for the third both paths now keep a run of
// LUT sums in registers (LutRun), which meets the column only when the
// knot pair changes.
//
// LUT and render-parameter cotangents accumulate per thread in the tent
// basis into the thread's own column of shared memory, are summed per
// block in a fixed order and written as per-block partials that torch sums:
// deterministic, run to run, and bitwise the same on both paths. Only
// d_planes uses atomics, so it is reproducible to rounding, not bitwise.
//
// `wrt` pruning: GVOL compiles the d_planes scatter in or out, GSMALL the
// LUT and parameter accumulation; pruned outputs stay zero.
//
// bf16 mode (SweepParams.precision, JAX's precision='bf16'): the replay
// resamples as K4 did (sweep_common.cuh bilerp), and the plane cotangent
// goes to the row buffer bp.dtmp (bwd_common.cuh scatter_row) on both
// paths; the wrapper then launches dplane_bf16.cu for d_planes. The LUT,
// parameter and seed cotangents see only the bf16 res.
//
// Seeded sweeps (S_img of slice_vjp.py:787-826): once the walk reaches plane
// 0 the suffix sum S is P_total = sum_k P_k, the total the seed cotangent
// needs (d seed_a = g_a - S / T0, formed in torch). With a non-null s_out
// each ray writes it there. The replay needs nothing else: K4's checkpoint
// row 0 already holds T0 = 1 - seed_a, and a seed frozen past the cutoff
// skips every chunk, so S = 0.

#include "bwd_common.cuh"

namespace {

using namespace vrdd;

template <int MODE, typename T, int CK, bool GVOL, bool GSMALL>
__global__ void __launch_bounds__(kBwdThreads)
slice_bwd_kernel(const SweepParams p, const BwdParams bp,
                 const T* __restrict__ vol, const float* __restrict__ zs,
                 const float* __restrict__ lut,
                 const float* __restrict__ rows,
                 const float* __restrict__ g, const float* __restrict__ tck,
                 float* __restrict__ d_planes, float* __restrict__ partials,
                 float* __restrict__ mom, float* __restrict__ s_out) {
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
  RevState st{0.0f, 0.0f, 0.0f, 0.0f};
  LutRun run;
  run.reset();
  if (i < p.height && j < p.width) {
    const Ray ray = make_ray(p, i, j);
    const size_t pix = (size_t)i * p.width + j;
    const size_t hw = (size_t)p.height * p.width;
    const float4 gv = reinterpret_cast<const float4*>(g)[pix];
    const float thr1 = p.thr1;
    const size_t plane_elems = (size_t)p.ny * (size_t)p.nx;
    const bool g_lut = GSMALL && bp.g_lut;
    const bool g_par = GSMALL && bp.g_params;

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

      // reverse loop on the cached values
#pragma unroll
      for (int ii = CK - 1; ii >= 0; --ii) {
        if (!((live >> ii) & 1u)) continue;
        const int k = kk * CK + ii;
        const float d_res = reverse_sample(
            p, s_lut, gv, tk[ii], resk[ii], cak[ii], ray.ascale, g_lut, g_par,
            GVOL || g_par, st, run, s_acc + tid);
        if (GVOL && d_res != 0.0f && bp.dtmp != nullptr) {
          Taps tp;
          plane_taps(p, __ldg(zs + k), ray, tp);  // covered: replayed above
          scatter_row(p, bp.dtmp, k, i, tp, d_res);
        } else if (GVOL && d_res != 0.0f) {
          Taps tp;
          plane_taps(p, __ldg(zs + k), ray, tp);  // covered: replayed above
          const int layer = p.reverse ? p.n_layers - 1 - k : k;
          float* dp = d_planes + (size_t)layer * plane_elems;
          const size_t r0 = (size_t)tp.y0 * p.nx, r1 = (size_t)tp.y1 * p.nx;
          const float d0 = __fmul_rn(d_res, tp.wy0);
          const float d1 = __fmul_rn(d_res, tp.wy1);
          const float d00 = __fmul_rn(d0, tp.wx0), d01 = __fmul_rn(d0, tp.wx1);
          const float d10 = __fmul_rn(d1, tp.wx0), d11 = __fmul_rn(d1, tp.wx1);
          if (d00 != 0.0f) atomicAdd(dp + r0 + tp.x0, d00);
          if (d01 != 0.0f) atomicAdd(dp + r0 + tp.x1, d01);
          if (d10 != 0.0f) atomicAdd(dp + r1 + tp.x0, d10);
          if (d11 != 0.0f) atomicAdd(dp + r1 + tp.x1, d11);
        }
      }
    }
    if (s_out != nullptr) s_out[pix] = st.S;
  }
  if (GSMALL) block_partials(p, run, st, s_acc, tid, partials);
}

template <int MODE, typename T, int CK, bool GVOL, bool GSMALL>
cudaError_t launch_bwd(const SweepParams& p, const BwdParams& bp,
                       const void* vol, const float* zs, const float* lut,
                       const float* rows, const float* g, const float* tck,
                       float* d_planes, float* partials, float* mom,
                       float* s_out, cudaStream_t stream) {
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
      partials, mom, s_out);
  return cudaGetLastError();
}

template <int MODE, typename T, int CK>
cudaError_t dispatch_wrt(const SweepParams& p, const BwdParams& bp,
                         const void* vol, const float* zs, const float* lut,
                         const float* rows, const float* g, const float* tck,
                         float* d_planes, float* partials, float* mom,
                         float* s_out, cudaStream_t s) {
  const bool gvol = bp.g_planes != 0;
  const bool gsmall = bp.g_lut != 0 || bp.g_params != 0;
  if (gvol && gsmall)
    return launch_bwd<MODE, T, CK, true, true>(
        p, bp, vol, zs, lut, rows, g, tck, d_planes, partials, mom, s_out, s);
  if (gvol)
    return launch_bwd<MODE, T, CK, true, false>(
        p, bp, vol, zs, lut, rows, g, tck, d_planes, partials, mom, s_out, s);
  if (gsmall)
    return launch_bwd<MODE, T, CK, false, true>(
        p, bp, vol, zs, lut, rows, g, tck, d_planes, partials, mom, s_out, s);
  return cudaErrorInvalidValue;
}

template <int MODE, typename T>
cudaError_t dispatch_ck(const SweepParams& p, const BwdParams& bp,
                        const void* vol, const float* zs, const float* lut,
                        const float* rows, const float* g, const float* tck,
                        float* d_planes, float* partials, float* mom,
                        float* s_out, cudaStream_t s) {
  if (bp.ck_stride == 4)
    return dispatch_wrt<MODE, T, 4>(p, bp, vol, zs, lut, rows, g, tck,
                                    d_planes, partials, mom, s_out, s);
  if (bp.ck_stride == 8)
    return dispatch_wrt<MODE, T, 8>(p, bp, vol, zs, lut, rows, g, tck,
                                    d_planes, partials, mom, s_out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 none, 1 linear, 2 var, 3 entropy; bf16: volume element type.
// g (H, W, 4) f32 image cotangent, tck the checkpoints K4 wrote with the
// same ck_stride. d_planes (n_layers, ny, nx) f32 zero-filled when
// bp->g_planes; partials (n_blocks, 4 n_lut + 3) when bp->g_lut or
// bp->g_params; mom (n_layers, 2, ny, nx) f32 zero-filled in variance mode
// with g_planes; s_out (H, W) f32 receives each ray's P_total for a seeded
// sweep's cotangent, or null. stage_w x stage_h > 0: the staged path with
// footprints of at most that many voxels (the host's bound); 0: the direct
// path. Launches on `stream`; returns cudaGetLastError().
extern "C" __attribute__((visibility("default"))) int vrdd_slice_bwd(
    const SweepParams* p, const BwdParams* bp, int mode, int bf16,
    const void* vol, const float* zs, const float* lut, const float* rows,
    const float* g, const float* tck, float* d_planes, float* partials,
    float* mom, float* s_out, int stage_w, int stage_h, void* stream) {
  if (p->height <= 0 || p->width <= 0) return (int)cudaSuccess;
  if (stage_w < 0 || stage_h < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage_w > 0 && stage_h > 0)
    return (int)launch_bwd_staged(*p, *bp, mode, bf16, vol, zs, lut, rows, g,
                                  tck, d_planes, partials, mom, s_out,
                                  stage_w, stage_h, s);
  using bf = __nv_bfloat16;
#define VRDD_BWD(M, TYPE)                                                   \
  dispatch_ck<M, TYPE>(*p, *bp, vol, zs, lut, rows, g, tck, d_planes,       \
                       partials, mom, s_out, s)
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
