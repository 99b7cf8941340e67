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
// Design. One thread per ray, 2-D blocks over the (H, W) image, front to
// back over the planes with the ray's state in registers. The TPU kernel's
// sequential (chunk, strip) grid, with its accumulator and early-termination
// flags carried across grid steps in VMEM/SMEM, becomes that plane loop.
// Once a ray's alpha passes the cutoff the "over" recursion freezes it, so
// every later contribution is exactly zero. The resample Wy * plane * Wx^T
// has at most two nonzero tent weights per axis: each sample reads four
// taps with f32 weights, never through the texture unit (whose 9-bit filter
// weights the JAX package designed away). bf16 histograms stay bf16 in
// device memory and are widened on the card. For n_planes == nz the plane
// walk reads layer nz-1-p for front-to-back plane p (`reverse`), streaming
// the volume without a flipped copy. The per-sample arithmetic is in
// sweep_common.cuh, shared with K5.
//
// What bounds it on the H100. At 512^3 x 16 bf16 -> 1024^2 neighbouring
// rays are 0.75-1.22 voxels apart, so a 32 x 8-ray block covers 175-440
// voxels of a plane but reads 256 x 4 taps: fetched tap by tap (the direct
// path, kept as slice_sweep_kernel), each voxel's B bins are loaded and
// decoded 2.3-5.9 times, and the sweep is bound by load issue and latency
// (8-13x its bound from the histogram bytes; PERF.md).
//
// The staged path (slice_sweep_staged, the wrapper's default wherever the
// footprint fits shared memory) reads each voxel once per block and plane.
// The plane loop is block-synchronous: warp 0 computes the block's exact
// tap rectangles from its corner rays, 32 planes at a time (stage_tile.cuh),
// and the block visits only the planes some ray of it can sample (in front
// of the camera, inside the box, not ESS-culled): a plane no ray samples
// stages nothing and costs no barrier. At each visited plane the block
// copies the next visited plane's raw footprint (B bins per voxel) into a
// shared-memory ring slot with cp.async, double-buffered along z, so it is in
// flight while this plane is decoded and sampled; the threads decode each
// footprint voxel once into an f32 tile, and every live ray resamples its
// four taps from the tile with the unchanged bilerp. Frozen rays keep taking
// part in the copies and barriers; the block leaves the loop when no ray is
// live (__syncthreads_or). The decode is the one __fmaf_rn chain of
// sweep_common.cuh, so the staged image and checkpoints are bitwise the
// direct path's. No tensor cores: a length-B dot product per voxel would
// round otherwise, and K5's replay must rebuild K4's freeze masks bitwise.
//
// Checkpoints (CKPT). T follows the backward's own recursion
// T <- T - [T >= 1-thr] T a, not 1 - acc_a. A ray is done only when both
// the image (acc_a > thr) and T (T < 1-thr) are frozen, so T never stops
// early; the rows past that point hold the frozen T, and a plane that is
// skipped (behind the camera, outside the box, culled by ESS) still gets its
// chunk-start row, so K5 never reads an unwritten row. The image arithmetic
// is the same code in the same order as with CKPT off: K4's image is
// bitwise K3's.
//
// Empty-space skipping (ESS, K1/K3/K4; the ess mode of _make_kernel,
// slice_kernel.py:835-860). The block is the ESS tile: its shape
// (tile_w, tile_h) comes from the wrapper (kernels/slice_kernel.py
// ESS_TILE), and `ess` holds one byte per (chunk of ess_chunk planes, block
// row, block column), 0 where the host's TF-interval bound shows that
// every sample of the block in the chunk has alpha exactly 0. The byte is
// the same for every thread of the block: a block-uniform branch skips the
// chunk's planes. Skipping is exact: with a == 0 the "over" step
// fmaf(c * 0, t, acc) and t_step(T, 0) leave the state bitwise unchanged,
// so the image (and K4's checkpoints) with ESS is bitwise the one without.
// K5 takes no bitmap: it replays culled samples, whose alpha and slope are
// zero.
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

#include "stage_tile.cuh"

namespace {

using namespace vrdd;

// The state of one ray: premultiplied RGBA and, with CKPT, the backward's T.
struct RayState {
  float r, g, b, a, tr;
};

// One evaluated sample of resampled value `res`: TF lookup, opacity, the
// "over" step and with CKPT the T recursion. The same code for both fetch
// paths.
template <bool CKPT>
__device__ __forceinline__ void composite(const SweepParams& p,
                                          const float* __restrict__ s_lut,
                                          const Ray& ray, float res,
                                          float thr1, RayState& st) {
  const Tent tn = tent(p, res);
  const float a =
      fminf(alpha_raw(lut_channel(s_lut, tn, 3), p.density, ray.ascale), 1.0f);
  if (st.a <= p.threshold) {
    const float t = __fsub_rn(1.0f, st.a);
    st.r = __fmaf_rn(__fmul_rn(lut_channel(s_lut, tn, 0), a), t, st.r);
    st.g = __fmaf_rn(__fmul_rn(lut_channel(s_lut, tn, 1), a), t, st.g);
    st.b = __fmaf_rn(__fmul_rn(lut_channel(s_lut, tn, 2), a), t, st.b);
    st.a = __fmaf_rn(a, t, st.a);
  }
  if (CKPT) st.tr = t_step(st.tr, a, thr1);
}

__device__ __forceinline__ RayState start_state(const float* seed, size_t pix) {
  RayState st{0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  if (seed != nullptr) {
    const float4 s0 = reinterpret_cast<const float4*>(seed)[pix];
    st = RayState{s0.x, s0.y, s0.z, s0.w, __fsub_rn(1.0f, s0.w)};
  }
  return st;
}

// frozen: nothing more can accumulate (and, with CKPT, T is frozen too)
template <bool CKPT>
__device__ __forceinline__ bool done(const SweepParams& p, const RayState& st,
                                     float thr1) {
  return st.a > p.threshold && (!CKPT || !(st.tr >= thr1));
}

// Rows of the checkpoint chunks at and after plane k: the frozen T.
__device__ __forceinline__ void fill_rows(const SweepParams& p, int k,
                                          int ck_stride, float tr, float* tck,
                                          size_t hw, size_t pix) {
  const int n_chunks = (p.n_planes + ck_stride - 1) / ck_stride;
  for (int c = (k + ck_stride - 1) / ck_stride; c < n_chunks; ++c)
    tck[(size_t)c * hw + pix] = tr;
}

__device__ __forceinline__ void write_out(const SweepParams& p,
                                          const RayState& st, float* out,
                                          size_t pix) {
  const float s = p.brightness;
  reinterpret_cast<float4*>(out)[pix] =
      make_float4(__fmul_rn(st.r, s), __fmul_rn(st.g, s), __fmul_rn(st.b, s),
                  __fmul_rn(st.a, s));
}

// The direct path: each thread walks its ray and fetches every tap from
// device memory.
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

  RayState st = start_state(seed, pix);
  int k = 0;
  for (; k < p.n_planes; ++k) {
    if (done<CKPT>(p, st, thr1)) break;
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
              tck[(size_t)(kk / ck_stride) * hw + pix] = st.tr;
        k = k_end - 1;
        continue;
      }
    }
    if (CKPT && k % ck_stride == 0)
      tck[(size_t)(k / ck_stride) * hw + pix] = st.tr;
    Taps tp;
    if (!plane_taps(p, __ldg(zs + k), ray, tp)) continue;  // alpha exactly 0
    const int layer = p.reverse ? p.n_layers - 1 - k : k;
    composite<CKPT>(p, s_lut, ray, resample<MODE, T>(p, vol, layer, tp, s_rows),
                    thr1, st);
  }
  if (CKPT) fill_rows(p, k, ck_stride, st.tr, tck, hw, pix);
  write_out(p, st, out, pix);
}

// Ring slots of the staged forward: two (copies one visited plane ahead)
// for the decode modes, whose decode hides the copies' latency; three (two
// planes ahead) for scalar planes, which are sampled straight from the ring.
template <int MODE>
__host__ __device__ constexpr int fwd_slots() {
  return MODE == kNone ? 3 : 2;
}

// The staged path: block-synchronous over the planes that some ray of the
// block samples; each one's footprint is copied to shared memory one or two
// visited planes ahead, decoded once (scalar planes: read as they are), and
// resampled from the tile. tw_b x th_b: the host's bound of the footprint.
// At least 3 blocks an SM (2 in variance mode): the barriers of a block
// leave the SM to the others.
template <int MODE, typename T, bool CKPT>
__global__ void __launch_bounds__(256, MODE == kVar ? 2 : 3)
slice_sweep_staged(const SweepParams p, const T* __restrict__ vol,
                   const float* __restrict__ zs,
                   const float* __restrict__ lut,
                   const float* __restrict__ rows, float* __restrict__ out,
                   int ck_stride, float* __restrict__ tck,
                   const unsigned char* __restrict__ ess, int ess_chunk,
                   const float* __restrict__ seed, int tw_b, int th_b) {
  constexpr int NS = fwd_slots<MODE>();
  constexpr bool RAW = MODE == kNone;  // sampled straight from the ring
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Foot s_foot[2][kPlanBatch];  // two batches of planned planes
  __shared__ unsigned s_visit[2];         // their planes with a sample
  const int B = MODE == kNone ? 1 : p.n_bins;
  const StageLayout L = stage_layout(tw_b, th_b, B, (int)sizeof(T), p.n_lut,
                                     MODE == kNone ? 0 : p.n_rows * p.n_bins,
                                     NS, 0);
  float* s_lut = reinterpret_cast<float*>(smem_raw + L.off_lut);
  float* s_rows = reinterpret_cast<float*>(smem_raw + L.off_rows);
  float* dec = reinterpret_cast<float*>(smem_raw + L.off_dec);
  int* rowoff = reinterpret_cast<int*>(smem_raw + L.off_rowoff);
  const int row_slot = th_b * B;
  const bool uniform = rows_uniform(p, (int)sizeof(T));
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int t = tid; t < 4 * p.n_lut; t += nthreads) s_lut[t] = lut[t];
  if (MODE != kNone)
    for (int t = tid; t < p.n_rows * p.n_bins; t += nthreads)
      s_rows[t] = rows[t];

  const int j0 = blockIdx.x * blockDim.x, i0 = blockIdx.y * blockDim.y;
  const int j = j0 + threadIdx.x, i = i0 + threadIdx.y;
  const bool valid = i < p.height && j < p.width;
  const Ray ray = make_ray(p, min(i, p.height - 1), min(j, p.width - 1));
  // the block's first and last valid rays: its taps' extremes on any plane
  const Ray ra = make_ray(p, i0, j0);
  const Ray rb = make_ray(p, min(i0 + (int)blockDim.y, p.height) - 1,
                          min(j0 + (int)blockDim.x, p.width) - 1);
  const size_t pix = valid ? (size_t)i * p.width + j : 0;
  const size_t hw = (size_t)p.height * p.width;
  const float thr1 = __fsub_rn(1.0f, p.threshold);
  const unsigned char* ess_blk =
      ess == nullptr ? nullptr
                     : ess + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t ess_stride = (size_t)gridDim.x * gridDim.y;

  RayState st = valid ? start_state(seed, pix)
                      : RayState{0.0f, 0.0f, 0.0f, 1.0f, 0.0f};
  int next_row = 0;  // CKPT: the first checkpoint row not written yet

  // the batch of planes planned into s_foot[slot] starts at plane kb (the
  // same in every thread); next_visit plans further batches as it needs
  int kb = 0, slot = 0;
  plan_batch(p, zs, 0, ra, rb, tw_b, th_b, ess_blk, ess_stride, ess_chunk,
             tid, s_foot[0], &s_visit[0]);
  __syncthreads();
  // the first plane after k (k = -1 or a plane of the latest batch) with a
  // sample, and its footprint; n_planes when there is none (block-uniform)
  auto next_visit = [&](int k, Foot& f) {
    f = Foot{};
    if (k >= p.n_planes) return p.n_planes;
    unsigned m = k < kb ? s_visit[slot]
                        : s_visit[slot] & ~((2u << (k - kb)) - 1u);
    while (m == 0u) {
      kb += kPlanBatch;
      if (kb >= p.n_planes) return p.n_planes;
      slot ^= 1;
      plan_batch(p, zs, kb, ra, rb, tw_b, th_b, ess_blk, ess_stride,
                 ess_chunk, tid, s_foot[slot], &s_visit[slot]);
      __syncthreads();
      m = s_visit[slot];
    }
    const int kn = kb + __ffs(m) - 1;
    f = s_foot[slot][kn - kb];
    return kn;
  };
  // staged planes take the ring slots in turn: si issued, sp consumed
  int si = 0, sp = 0;
  auto issue = [&](const Foot& g) {
    if (g.kind == kStaged) {
      const int sl = si++ % NS;
      stage_issue(p, vol, B, g, L.rc, smem_raw + sl * L.ring,
                  rowoff + sl * row_slot, tid, nthreads);
    }
    cp_async_commit();
  };

  // the visited planes whose copies are in flight: k, and with three slots
  // also k1
  Foot f{}, f1{};
  int k = next_visit(-1, f);
  issue(f);
  int k1 = NS == 3 ? next_visit(k, f1) : p.n_planes;
  if (NS == 3) issue(f1);
  while (k < p.n_planes) {
    // the rows of the planes up to k: T is what it was after the last sample
    if (CKPT && valid)
      for (; next_row * ck_stride <= k; ++next_row)
        tck[(size_t)next_row * hw + pix] = st.tr;
    const bool live = valid && !done<CKPT>(p, st, thr1);
    if (f.kind == kStaged) cp_async_wait<NS - 2>();  // plane k's have landed
    // also: every thread is past the sampling of the plane before k, whose
    // ring slot (and decoded tile) the next copies and decode reuse
    if (!__syncthreads_or(live)) break;
    Foot fn;  // the plane NS - 1 visits on: its copies go out now
    const int kn = next_visit(NS == 3 ? k1 : k, fn);
    const int cur = sp % NS;
    sp += f.kind == kStaged;
    issue(fn);
    if (!RAW && f.kind == kStaged) {
      stage_decode<MODE, T, false>(smem_raw + cur * L.ring,
                                   rowoff + cur * row_slot, L.rc, B, f,
                                   uniform, s_rows, dec, nullptr, nullptr,
                                   tid, nthreads);
      __syncthreads();
    }
    Taps tp;
    if (live && plane_taps(p, __ldg(zs + k), ray, tp)) {
      float res;
      if (f.kind != kStaged)
        res = resample<MODE, T>(p, vol, f.layer, tp, s_rows);
      else if (RAW)
        res = resample_raw(reinterpret_cast<const T*>(smem_raw + cur * L.ring),
                           rowoff + cur * row_slot, f, tp);
      else
        res = resample_tile(dec, f, tp);
      composite<CKPT>(p, s_lut, ray, res, thr1, st);
    }
    if (NS == 3) {
      k = k1;
      f = f1;
      k1 = kn;
      f1 = fn;
    } else {
      k = kn;
      f = fn;
    }
  }
  cp_async_wait<0>();
  if (!valid) return;
  if (CKPT) fill_rows(p, next_row * ck_stride, ck_stride, st.tr, tck, hw, pix);
  write_out(p, st, out, pix);
}

template <int MODE, typename T, bool CKPT>
cudaError_t launch_staged(const SweepParams& p, const T* v, const float* zs,
                          const float* lut, const float* rows, float* out,
                          int ck_stride, float* tck, const unsigned char* ess,
                          int ess_chunk, const float* seed, dim3 grid,
                          dim3 block, int tw_b, int th_b,
                          cudaStream_t stream) {
  const int B = MODE == kNone ? 1 : p.n_bins;
  const size_t smem =
      stage_layout(tw_b, th_b, B, (int)sizeof(T), p.n_lut,
                   MODE == kNone ? 0 : p.n_rows * p.n_bins, fwd_slots<MODE>(),
                   0)
          .total;
  const cudaError_t e = cudaFuncSetAttribute(
      slice_sweep_staged<MODE, T, CKPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  slice_sweep_staged<MODE, T, CKPT><<<grid, block, smem, stream>>>(
      p, v, zs, lut, rows, out, ck_stride, tck, ess, ess_chunk, seed, tw_b,
      th_b);
  return cudaGetLastError();
}

template <int MODE, typename T>
cudaError_t launch(const SweepParams& p, const void* vol, const float* zs,
                   const float* lut, const float* rows, float* out,
                   int ck_stride, float* tck, const unsigned char* ess,
                   int ess_chunk, const float* seed, dim3 block, int tw_b,
                   int th_b, cudaStream_t stream) {
  const dim3 grid((p.width + block.x - 1) / block.x,
                  (p.height + block.y - 1) / block.y);
  const int row_floats = MODE == kNone ? 0 : p.n_rows * p.n_bins;
  const T* v = static_cast<const T*>(vol);
  if (tw_b > 0 && th_b > 0) {
    if (block.x * block.y < kPlanBatch)  // warp 0 plans the planes
      return cudaErrorInvalidValue;
    if (ck_stride > 0)
      return launch_staged<MODE, T, true>(p, v, zs, lut, rows, out,
                                          ck_stride, tck, ess, ess_chunk,
                                          seed, grid, block, tw_b, th_b,
                                          stream);
    return launch_staged<MODE, T, false>(p, v, zs, lut, rows, out, 0,
                                         nullptr, ess, ess_chunk, seed, grid,
                                         block, tw_b, th_b, stream);
  }
  const size_t smem = sizeof(float) * (4 * (size_t)p.n_lut + row_floats);
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
// block shape (at most 256 threads). stage_w x stage_h > 0: the staged path
// with footprints of at most that many voxels (the host's bound); 0: the
// direct path. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" __attribute__((visibility("default"))) int vrdd_slice_sweep(
    const SweepParams* p, int mode, int bf16, const void* vol,
    const float* zs, const float* lut, const float* rows, float* out,
    int ck_stride, float* tck, const unsigned char* ess, int ess_chunk,
    const float* seed, int tile_w, int tile_h, int stage_w, int stage_h,
    void* stream) {
  if (p->height <= 0 || p->width <= 0) return (int)cudaSuccess;
  if (ck_stride < 0 || (ck_stride > 0 && tck == nullptr) ||
      (seed != nullptr && ess != nullptr))
    return (int)cudaErrorInvalidValue;
  if (tile_w <= 0 || tile_h <= 0 || tile_w * tile_h > 256 ||
      (ess != nullptr && ess_chunk <= 0) || stage_w < 0 || stage_h < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 block(tile_w, tile_h);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
#define VRDD_LAUNCH(M, TYPE)                                                 \
  launch<M, TYPE>(*p, vol, zs, lut, rows, out, ck_stride, tck, ess, ess_chunk, \
                  seed, block, stage_w, stage_h, s)
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
