// Fused front-to-back slice sweep for Hopper (sm_90a), with an optional
// per-voxel histogram decode prologue and optional transmittance
// checkpoints for the backward.
//
// Replaces four Pallas launches whose body is _make_kernel
// (vrdd_tpu/pallas/slice_kernel.py:657):
//   - K1, MODE = kNone, CKPT off: the scalar sweep, pallas_call at :1351
//     (sweep_preblended_planes, :1274);
//   - K2, MODE = kLinear / kVar / kEntropy, CKPT off: the in-kernel decode
//     sweep of pallas_hist_render (:1495, pallas_call :1595), whose
//     prologue is _decode_block (:586);
//   - K3, any MODE, CKPT off: the primal of the differentiable sweeps,
//     vrdd_tpu/pallas/slice_vjp.py:698 (_make_diff_sweep._fwd_call), the
//     same kernel launched with brightness 1 (folded outside, so it stays
//     differentiable);
//   - K4, any MODE, CKPT on: slice_vjp.py:714 (_fwd_ckpt_call,
//     _make_kernel emit_ckpt=True): the image plus one transmittance
//     checkpoint per ck_stride planes, tck[c, i, j] = T at the start of
//     plane c * ck_stride, for the reverse sweep in slice_vjp.cu (K5).
// The plain torch versions live in vrdd_tpu_torch/march/slice.py
// (sweep_preblended_planes_xla, transmittance_checkpoints); the wrappers in
// kernels/slice_kernel.py (K1, K2) and kernels/slice_vjp.py (K3, K4).
//
// Design. One thread per ray, 2-D blocks over the (H, W) image. The TPU
// kernel's sequential (chunk, strip) grid, with its accumulator and
// early-termination flags carried across grid steps in VMEM/SMEM, becomes a
// front-to-back loop over planes inside the thread with the state in
// registers. Once a ray's alpha passes the cutoff the "over" recursion
// freezes it, so every later contribution is exactly zero and a per-ray
// `break` is exact: it takes the place of the strip/tile flags and the
// footprint predicates of the TPU kernel.
//
// The resample Wy * plane * Wx^T has at most two nonzero tent weights per
// axis, so each sample fetches its four taps directly with f32 weights,
// never through the texture unit (whose 9-bit filter weights the JAX
// package designed away). In the decode modes each tap voxel is decoded
// from its B bins first and interpolated after. bf16 histograms stay bf16
// in device memory and are widened in registers. For n_planes == nz the
// plane walk reads layer nz-1-p for front-to-back plane p (`reverse`),
// streaming the volume without a flipped copy. The per-sample arithmetic
// is in sweep_common.cuh, shared with K5.
//
// Checkpoints (CKPT). T follows the backward's own recursion
// T <- T - [T >= 1-thr] T a, not 1 - acc_a. The ray breaks only when both
// the image (acc_a > thr) and T (T < 1-thr) are frozen, so T never stops
// early; the rows past a break are filled with the frozen T, and a plane
// that is skipped (behind the camera, outside the box, culled by ESS)
// still gets its chunk-start row, so K5 never reads an unwritten row. The
// image arithmetic is the same code in the same order as with CKPT off:
// K4's image is bitwise K3's.
//
// Empty-space skipping (ESS, K1/K3/K4; the ess mode of _make_kernel,
// slice_kernel.py:835-860). The block is the ESS tile: its shape
// (tile_w, tile_h) comes from the wrapper (kernels/slice_kernel.py
// ESS_TILE), and `ess` holds one byte per (chunk of ess_chunk planes, block
// row, block column), 0 where the host's TF-interval bound shows that
// every sample of the block in the chunk has alpha exactly 0. At each
// chunk start a thread reads its block's byte (the same byte for every
// thread of the block: a block-uniform branch) and skips the chunk's
// planes when it is 0. Skipping is exact: with a == 0 the "over" step
// fmaf(c * 0, t, acc) and t_step(T, 0) leave the state bitwise unchanged,
// so the image (and K4's checkpoints) with ESS is bitwise the one without.
// K5 takes no bitmap: it replays culled samples, whose alpha and slope are
// zero.
//
// Bound on the H100: the histogram stream. At 512^3 x 16 bf16 -> 1024^2
// every in-box sample reads 4 taps x B bins; neighbouring rays share taps, so
// the traffic is served mostly from L1/L2, and the 4.3 GB volume is read
// from HBM at least once. Left for later: staging plane tiles in shared
// memory (TMA, double-buffered along z) so each voxel is decoded once per
// block instead of once per tap.
//
// Seeded resume (K1/K3/K4; the seed mode of _make_kernel, slice_kernel.py
// :815-823 and :1081-1090, acc_init in JAX). `seed` (H, W, 4) is a
// premultiplied RGBA image the "over" recursion resumes from: the ray's
// accumulator starts at the seed and K4's transmittance at T0 = 1 - seed_a,
// so a pixel seeded past the cutoff freezes before its first sample and its
// checkpoint rows are all T0. The TPU kernel accumulates the sweep alone and
// adds the seed at the end (A_sweep = A - seed_a); starting from the seed is
// the same algebra rounded in another order. A null seed is the unseeded
// sweep, bitwise as before. Brightness scales seed and sweep together, as on
// the TPU. Seed and ESS together are refused, as JAX asserts
// (slice_vjp.py:596).
//
// No atomics and one thread per ray: results are bitwise reproducible.

#include "sweep_common.cuh"

namespace {

using namespace vrdd;

template <int MODE, typename T, bool CKPT>
__global__ void __launch_bounds__(256)
slice_sweep_kernel(const SweepParams p, const T* __restrict__ vol,
                   const float* __restrict__ zs,
                   const float* __restrict__ lut,
                   const float* __restrict__ rows, float* __restrict__ out,
                   int ck_stride, float* __restrict__ tck,
                   const unsigned char* __restrict__ ess, int ess_chunk,
                   const float* __restrict__ seed) {
  extern __shared__ float smem[];
  float* s_lut = smem;                  // (n_lut, 4)
  float* s_rows = smem + 4 * p.n_lut;   // (n_rows, B)
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int t = tid; t < 4 * p.n_lut; t += nthreads) s_lut[t] = lut[t];
  if (MODE != kNone)
    for (int t = tid; t < p.n_rows * p.n_bins; t += nthreads)
      s_rows[t] = rows[t];
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= p.height || j >= p.width) return;

  const Ray ray = make_ray(p, i, j);
  const size_t pix = (size_t)i * p.width + j;
  const size_t hw = (size_t)p.height * p.width;
  const float thr1 = __fsub_rn(1.0f, p.threshold);
  // ESS: this block's byte of the next chunk (chunk c is c * ess_stride
  // bytes after chunk 0), read when the plane loop reaches ess_next
  const unsigned char* ess_cur =
      ess == nullptr ? nullptr
                     : ess + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t ess_stride = (size_t)gridDim.x * gridDim.y;
  int ess_next = ess == nullptr ? p.n_planes : 0;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
  float tr = 1.0f;  // CKPT: the backward's transmittance
  if (seed != nullptr) {
    const float4 s0 = reinterpret_cast<const float4*>(seed)[pix];
    acc_r = s0.x;
    acc_g = s0.y;
    acc_b = s0.z;
    acc_a = s0.w;
    tr = __fsub_rn(1.0f, s0.w);
  }
  int k = 0;
  for (; k < p.n_planes; ++k) {
    // frozen: nothing more can accumulate (and, with CKPT, T is frozen too)
    if (acc_a > p.threshold && (!CKPT || !(tr >= thr1))) break;
    if (k == ess_next) {
      ess_next += ess_chunk;
      const bool culled = *ess_cur == 0;
      ess_cur += ess_stride;
      if (culled) {
        // alpha is 0 at all the chunk's samples, the state stays as it is;
        // only its checkpoint rows are due
        const int k_end = min(ess_next, p.n_planes);
        if (CKPT)
          for (int kk = k; kk < k_end; ++kk)
            if (kk % ck_stride == 0)
              tck[(size_t)(kk / ck_stride) * hw + pix] = tr;
        k = k_end - 1;
        continue;
      }
    }
    if (CKPT && k % ck_stride == 0) tck[(size_t)(k / ck_stride) * hw + pix] = tr;
    Taps tp;
    if (!plane_taps(p, __ldg(zs + k), ray, tp)) continue;  // alpha exactly 0
    const int layer = p.reverse ? p.n_layers - 1 - k : k;
    const float res = resample<MODE, T>(p, vol, layer, tp, s_rows);
    const Tent tn = tent(p, res);
    const float a = fminf(alpha_raw(lut_channel(s_lut, tn, 3), p.density,
                                    ray.ascale), 1.0f);
    if (acc_a <= p.threshold) {
      const float t = __fsub_rn(1.0f, acc_a);
      acc_r = __fmaf_rn(__fmul_rn(lut_channel(s_lut, tn, 0), a), t, acc_r);
      acc_g = __fmaf_rn(__fmul_rn(lut_channel(s_lut, tn, 1), a), t, acc_g);
      acc_b = __fmaf_rn(__fmul_rn(lut_channel(s_lut, tn, 2), a), t, acc_b);
      acc_a = __fmaf_rn(a, t, acc_a);
    }
    if (CKPT) tr = t_step(tr, a, thr1);
  }
  if (CKPT) {
    // rows of the chunks the loop never reached: the frozen T
    const int n_chunks = (p.n_planes + ck_stride - 1) / ck_stride;
    for (int c = (k + ck_stride - 1) / ck_stride; c < n_chunks; ++c)
      tck[(size_t)c * hw + pix] = tr;
  }
  const float s = p.brightness;
  reinterpret_cast<float4*>(out)[pix] = make_float4(
      __fmul_rn(acc_r, s), __fmul_rn(acc_g, s), __fmul_rn(acc_b, s),
      __fmul_rn(acc_a, s));
}

template <int MODE, typename T>
cudaError_t launch(const SweepParams& p, const void* vol, const float* zs,
                   const float* lut, const float* rows, float* out,
                   int ck_stride, float* tck, const unsigned char* ess,
                   int ess_chunk, const float* seed, dim3 block,
                   cudaStream_t stream) {
  const dim3 grid((p.width + block.x - 1) / block.x,
                  (p.height + block.y - 1) / block.y);
  const size_t smem =
      sizeof(float) * (4 * (size_t)p.n_lut +
                       (MODE == kNone ? 0 : (size_t)p.n_rows * p.n_bins));
  const T* v = static_cast<const T*>(vol);
  if (ck_stride > 0)
    slice_sweep_kernel<MODE, T, true><<<grid, block, smem, stream>>>(
        p, v, zs, lut, rows, out, ck_stride, tck, ess, ess_chunk, seed);
  else
    slice_sweep_kernel<MODE, T, false><<<grid, block, smem, stream>>>(
        p, v, zs, lut, rows, out, 0, nullptr, ess, ess_chunk, seed);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 none, 1 linear, 2 var, 3 entropy; bf16: volume element type;
// ck_stride > 0 also writes the (ceil(n_planes / ck_stride), H, W)
// transmittance checkpoints to tck (K4), 0 writes none (K1-K3). ess: the
// (ceil(n_planes / ess_chunk), ceil(H / tile_h), ceil(W / tile_w)) uint8
// ESS bitmap, or null for no culling. seed: the (H, W, 4) f32 image the
// sweep resumes from, or null for none; not with ess. tile_w x tile_h is the
// block shape (at most 256 threads). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" __attribute__((visibility("default"))) int vrdd_slice_sweep(
    const SweepParams* p, int mode, int bf16, const void* vol,
    const float* zs, const float* lut, const float* rows, float* out,
    int ck_stride, float* tck, const unsigned char* ess, int ess_chunk,
    const float* seed, int tile_w, int tile_h, void* stream) {
  if (p->height <= 0 || p->width <= 0) return (int)cudaSuccess;
  if (ck_stride < 0 || (ck_stride > 0 && tck == nullptr) ||
      (seed != nullptr && ess != nullptr))
    return (int)cudaErrorInvalidValue;
  if (tile_w <= 0 || tile_h <= 0 || tile_w * tile_h > 256 ||
      (ess != nullptr && ess_chunk <= 0))
    return (int)cudaErrorInvalidValue;
  const dim3 block(tile_w, tile_h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define VRDD_LAUNCH(M, TYPE)                                                 \
  launch<M, TYPE>(*p, vol, zs, lut, rows, out, ck_stride, tck, ess, ess_chunk, \
                  seed, block, s)
  switch (mode * 2 + (bf16 ? 1 : 0)) {
    case 0: return (int)VRDD_LAUNCH(kNone, float);
    case 1: return (int)VRDD_LAUNCH(kNone, bf);
    case 2: return (int)VRDD_LAUNCH(kLinear, float);
    case 3: return (int)VRDD_LAUNCH(kLinear, bf);
    case 4: return (int)VRDD_LAUNCH(kVar, float);
    case 5: return (int)VRDD_LAUNCH(kVar, bf);
    case 6: return (int)VRDD_LAUNCH(kEntropy, float);
    case 7: return (int)VRDD_LAUNCH(kEntropy, bf);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VRDD_LAUNCH
}
