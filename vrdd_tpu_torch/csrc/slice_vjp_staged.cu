// K5's staged path: the reverse sweep of slice_vjp.cu (read its note first)
// with each block's plane footprint staged in shared memory, for Hopper
// (sm_90a). A source of its own so that its template instances build in an
// nvcc process of their own, beside the direct path's.
//
// The block (32 x 4 rays, bwd_common.cuh) walks the chunks of CK planes back
// to front together. A chunk is replayed only if some ray of the block is
// unfrozen at its checkpoint (__syncthreads_or over tck) and some ray samples
// one of its planes (warp 0 plans 32 planes at a time, as in the forward);
// which chunk comes next is known before the replay starts, so its first
// plane's copies go out during the current chunk's last replay plane. The
// replay visits the chunk's sampled planes front to back with the forward's
// tile code (stage_tile.cuh): the raw footprint arrives by cp.async,
// double-buffered along z, each voxel is decoded once, and each live ray
// resamples from the decoded tile; T, res and the TF alpha are cached per
// ray (in shared memory, a column per thread), so T and the freeze masks are
// bitwise K4's. In variance mode with a volume cotangent the decode also
// leaves each voxel's chain moments in shared memory; the rays mark the
// voxels their taps touch, and the block writes the moments of the touched
// voxels once (the voxels the direct path writes, with the same values). The
// reverse loop is block-synchronous per staged plane: each ray adds its
// d_res weights into a shared-memory d tile of that plane's footprint
// (shared atomicAdd; two tiles alternate, so one barrier per staged plane
// suffices), and the block then flushes the tile to d_planes with
// one global atomicAdd per nonzero footprint voxel. Only the edges of
// neighbouring blocks' footprints overlap, so most of those atomics meet no
// contention. A plane whose footprint overflows the host's bound takes the
// direct path's fetch and scatter (stage_tile.cuh).

#include "bwd_common.cuh"

namespace {

using namespace vrdd;

// Bytes of the staged K5's own shared memory after the tile layout: the
// per-ray caches of the chunk (T, res, TF alpha per plane), two d tiles
// (GVOL), the moment tiles and touch flags (variance with GVOL), the
// per-thread LUT columns (GSMALL). kernels/slice_kernel.py stage_smem_bytes
// mirrors it.
__host__ __device__ inline size_t bwd_extra(size_t tile, int n_lut, int ck,
                                            bool gvol, bool momt,
                                            bool gsmall) {
  return sizeof(float) *
         (3 * (size_t)ck * kBwdThreads + (gvol ? 2 * tile : 0) +
          (momt ? 3 * tile : 0) +
          (gsmall ? (4 * (size_t)n_lut + 3) * kBwdThreads : 0));
}

// At least 5 blocks an SM for the mean and scalar planes, 4 in variance
// mode, whose tiles take more shared memory, and 3 for entropy, whose decode
// keeps more registers live (5 made it spill and run 17% slower on the
// H100).
template <int MODE, typename T, int CK, bool GVOL, bool GSMALL>
__global__ void __launch_bounds__(kBwdThreads,
                                  MODE == kVar ? 4 : (MODE == kEntropy ? 3 : 5))
slice_bwd_staged(const SweepParams p, const BwdParams bp,
                 const T* __restrict__ vol, const float* __restrict__ zs,
                 const float* __restrict__ lut,
                 const float* __restrict__ rows,
                 const float* __restrict__ g, const float* __restrict__ tck,
                 float* __restrict__ d_planes, float* __restrict__ partials,
                 float* __restrict__ mom, float* __restrict__ s_out, int tw_b,
                 int th_b) {
  constexpr bool MOMT = GVOL && MODE == kVar;
  constexpr int kPerBatch = kPlanBatch / CK;  // chunks per planned batch
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Foot s_foot[2][kPlanBatch];  // batch b of planes in slot b & 1
  __shared__ unsigned s_visit[2];
  __shared__ Foot s_chunk[2][CK];         // the current chunk's planes
  const int B = MODE == kNone ? 1 : p.n_bins;
  const size_t tile = (size_t)tw_b * th_b;
  const StageLayout L = stage_layout(
      tw_b, th_b, B, (int)sizeof(T), p.n_lut,
      MODE == kNone ? 0 : p.n_rows * p.n_bins, 2,
      bwd_extra(tile, p.n_lut, CK, GVOL, MOMT, GSMALL));
  float* s_lut = reinterpret_cast<float*>(smem_raw + L.off_lut);
  float* s_rows = reinterpret_cast<float*>(smem_raw + L.off_rows);
  float* dec = reinterpret_cast<float*>(smem_raw + L.off_dec);
  int* rowoff = reinterpret_cast<int*>(smem_raw + L.off_rowoff);
  float* cache = reinterpret_cast<float*>(smem_raw + L.off_extra);
  float* dtile = cache + 3 * CK * kBwdThreads;         // 2 x tile (GVOL)
  float* mt = dtile + (GVOL ? 2 * tile : 0);           // tile (MOMT)
  float* et = mt + (MOMT ? tile : 0);                  // tile (MOMT)
  int* touched = reinterpret_cast<int*>(et + (MOMT ? tile : 0));
  float* s_acc = reinterpret_cast<float*>(touched) + (MOMT ? tile : 0);
  const int row_slot = th_b * B;
  const bool uniform = rows_uniform(p, (int)sizeof(T));
  const int n_small = 4 * p.n_lut + 3;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int t = tid; t < 4 * p.n_lut; t += kBwdThreads) s_lut[t] = lut[t];
  if (MODE != kNone)
    for (int t = tid; t < p.n_rows * p.n_bins; t += kBwdThreads)
      s_rows[t] = rows[t];
  if (GVOL)
    for (size_t t = tid; t < 2 * tile; t += kBwdThreads) dtile[t] = 0.0f;
  if (MOMT)
    for (size_t t = tid; t < tile; t += kBwdThreads) touched[t] = 0;
  if (GSMALL)
    for (int e = 0; e < n_small; ++e) s_acc[e * kBwdThreads + tid] = 0.0f;
  // this ray's caches: T before plane ii, res, TF alpha (column tid)
  float* c_t = cache + tid;
  float* c_res = c_t + CK * kBwdThreads;
  float* c_ca = c_res + CK * kBwdThreads;

  const int j0 = blockIdx.x * kBwdX, i0 = blockIdx.y * kBwdY;
  const int j = j0 + threadIdx.x, i = i0 + threadIdx.y;
  const bool valid = i < p.height && j < p.width;
  const Ray ray = make_ray(p, min(i, p.height - 1), min(j, p.width - 1));
  const Ray ra = make_ray(p, i0, j0);
  const Ray rb = make_ray(p, min(i0 + kBwdY, p.height) - 1,
                          min(j0 + kBwdX, p.width) - 1);
  const size_t pix = valid ? (size_t)i * p.width + j : 0;
  const size_t hw = (size_t)p.height * p.width;
  const size_t plane_elems = (size_t)p.ny * (size_t)p.nx;
  const float4 gv = valid ? reinterpret_cast<const float4*>(g)[pix]
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float thr1 = __fsub_rn(1.0f, p.threshold);
  const bool g_lut = GSMALL && bp.g_lut;
  const bool g_par = GSMALL && bp.g_params;
  RevState st{0.0f, 0.0f, 0.0f, 0.0f};
  LutRun run;
  run.reset();
  float* col = s_acc + tid;

  // the batch of planes each s_foot slot holds (the same in every thread)
  int planned[2] = {-1, -1};
  // chunk c's planes with a sample (CK bits), planning its batch if needed
  auto visits = [&](int c) {
    const int b = c / kPerBatch;
    if (planned[b & 1] != b) {
      plan_batch(p, zs, b * kPlanBatch, ra, rb, tw_b, th_b, nullptr, 0, 1,
                 tid, s_foot[b & 1], &s_visit[b & 1]);
      planned[b & 1] = b;
      __syncthreads();
    }
    return (s_visit[b & 1] >> ((c % kPerBatch) * CK)) & ((1u << CK) - 1u);
  };
  auto foot = [&](int k) {
    return s_foot[(k / kPlanBatch) & 1][k % kPlanBatch];
  };
  // the next chunk at or below c that some ray of the block needs and some
  // ray samples, or -1 (every test is a barrier, run by all in step)
  auto next_chunk = [&](int c) {
    for (; c >= 0; --c)
      if (__syncthreads_or(valid && tck[(size_t)c * hw + pix] >= thr1) &&
          visits(c) != 0u)
        return c;
    return -1;
  };

  int kk = next_chunk(bp.n_chunks - 1);
  unsigned vm = kk >= 0 ? visits(kk) : 0u;
  // the first plane of the chunk with a sample: its copies go out first
  Foot fn = kk >= 0 ? foot(kk * CK + __ffs(vm) - 1) : Foot{};
  int sp = 0;  // staged planes so far: plane #sp uses ring slot sp & 1
  int dp = 0;  // staged planes of the reverse loops: d tile dp & 1
  if (fn.kind == kStaged)
    stage_issue(p, vol, B, fn, L.rc, smem_raw, rowoff, tid, kBwdThreads);
  cp_async_commit();
  int cs = 0;
  while (kk >= 0) {
    // this chunk's planes, out of the batch slots (the next chunk's batch
    // may take one of them)
    if (tid < CK) s_chunk[cs][tid] = foot(kk * CK + tid);
    __syncthreads();
    const int kn = next_chunk(kk - 1);
    const unsigned vn = kn >= 0 ? visits(kn) : 0u;
    const Foot fk = kn >= 0 ? foot(kn * CK + __ffs(vn) - 1) : Foot{};
    const Foot* F = s_chunk[cs];
    const float t0 = valid ? tck[(size_t)kk * hw + pix] : 0.0f;
    const bool need = valid && t0 >= thr1;

    // replay front to back: T before each plane, res and TF alpha
    unsigned live = 0u;
    float tr = t0;
#pragma unroll 1
    for (int ii = 0; ii < CK; ++ii) {
      c_t[ii * kBwdThreads] = tr;
      if (!((vm >> ii) & 1u)) continue;  // no ray of the block samples it
      const Foot f = F[ii];
      if (f.kind == kStaged) cp_async_wait<0>();
      __syncthreads();  // the block is past the previous plane's tiles
      // the next plane with a sample: of this chunk, or the next chunk's
      // first; its copies are in flight while this one is decoded
      const unsigned later = vm & ~((2u << ii) - 1u);
      const Foot nf = later ? F[__ffs(later) - 1] : fk;
      const int cur = sp & 1;
      sp += f.kind == kStaged;
      if (nf.kind == kStaged)
        stage_issue(p, vol, B, nf, L.rc, smem_raw + (sp & 1) * L.ring,
                    rowoff + (sp & 1) * row_slot, tid, kBwdThreads);
      cp_async_commit();
      if (f.kind == kStaged) {
        stage_decode<MODE, T, MOMT>(smem_raw + cur * L.ring,
                                    rowoff + cur * row_slot, L.rc, B, f,
                                    uniform, s_rows, dec, mt, et, tid,
                                    kBwdThreads);
        __syncthreads();
      }
      const int k = kk * CK + ii;
      Taps tp;
      if (need && tr >= thr1 && plane_taps(p, __ldg(zs + k), ray, tp)) {
        float res;
        if (f.kind == kStaged) {
          res = resample_tile(dec, f, tp);
          if (MOMT) {
            touched[tile_index(f, tp.y0, tp.x0)] = 1;
            touched[tile_index(f, tp.y0, tp.x1)] = 1;
            touched[tile_index(f, tp.y1, tp.x0)] = 1;
            touched[tile_index(f, tp.y1, tp.x1)] = 1;
          }
        } else {
          res = resample<MODE, T, GVOL>(p, vol, f.layer, tp, s_rows, mom);
        }
        const float ca = lut_channel(s_lut, tent(p, res), 3);
        c_res[ii * kBwdThreads] = res;
        c_ca[ii * kBwdThreads] = ca;
        live |= 1u << ii;
        tr = t_step(tr, fminf(alpha_raw(ca, p.density, ray.ascale), 1.0f),
                    thr1);
      }
      if (MOMT && f.kind == kStaged) {
        // the moments of the voxels the block's samples touched, once each
        __syncthreads();
        float* mp = mom + (size_t)f.layer * 2 * plane_elems;
        const FastDiv by_tw(f.tw);
        for (int v = tid; v < f.tw * f.th; v += kBwdThreads) {
          if (!touched[v]) continue;
          touched[v] = 0;
          const int yy = by_tw(v);
          const size_t off =
              (size_t)(f.y_lo + yy) * p.nx + f.x_lo + (v - yy * f.tw);
          mp[off] = mt[v];
          mp[plane_elems + off] = et[v];
        }
      }
    }

    // reverse loop on the cached values, block-synchronous per staged plane
#pragma unroll 1
    for (int ii = CK - 1; ii >= 0; --ii) {
      if (!((vm >> ii) & 1u)) continue;
      const Foot f = F[ii];
      const int k = kk * CK + ii;
      float* dt = dtile + (dp & 1) * tile;
      bool added = false;
      if ((live >> ii) & 1u) {
        const float d_res = reverse_sample(
            p, s_lut, gv, c_t[ii * kBwdThreads], c_res[ii * kBwdThreads],
            c_ca[ii * kBwdThreads], ray.ascale, g_lut, g_par, GVOL || g_par,
            st, run, col);
        if (GVOL && d_res != 0.0f) {
          Taps tp;
          plane_taps(p, __ldg(zs + k), ray, tp);  // covered: replayed above
          const float d0 = __fmul_rn(d_res, tp.wy0);
          const float d1 = __fmul_rn(d_res, tp.wy1);
          const float d00 = __fmul_rn(d0, tp.wx0), d01 = __fmul_rn(d0, tp.wx1);
          const float d10 = __fmul_rn(d1, tp.wx0), d11 = __fmul_rn(d1, tp.wx1);
          if (f.kind == kStaged) {
            if (d00 != 0.0f) atomicAdd(dt + tile_index(f, tp.y0, tp.x0), d00);
            if (d01 != 0.0f) atomicAdd(dt + tile_index(f, tp.y0, tp.x1), d01);
            if (d10 != 0.0f) atomicAdd(dt + tile_index(f, tp.y1, tp.x0), d10);
            if (d11 != 0.0f) atomicAdd(dt + tile_index(f, tp.y1, tp.x1), d11);
            added = true;
          } else {
            float* dp_ = d_planes + (size_t)f.layer * plane_elems;
            const size_t r0 = (size_t)tp.y0 * p.nx, r1 = (size_t)tp.y1 * p.nx;
            if (d00 != 0.0f) atomicAdd(dp_ + r0 + tp.x0, d00);
            if (d01 != 0.0f) atomicAdd(dp_ + r0 + tp.x1, d01);
            if (d10 != 0.0f) atomicAdd(dp_ + r1 + tp.x0, d10);
            if (d11 != 0.0f) atomicAdd(dp_ + r1 + tp.x1, d11);
          }
        }
      }
      if (GVOL && f.kind == kStaged) {
        // one global atomic per nonzero footprint voxel; the other d tile,
        // which takes the next staged plane's adds, was flushed before this
        // barrier
        ++dp;
        if (__syncthreads_or(added)) {
          float* dplane = d_planes + (size_t)f.layer * plane_elems;
          const FastDiv by_tw(f.tw);
          for (int v = tid; v < f.tw * f.th; v += kBwdThreads) {
            const float val = dt[v];
            if (val == 0.0f) continue;
            dt[v] = 0.0f;
            const int yy = by_tw(v);
            atomicAdd(dplane + (size_t)(f.y_lo + yy) * p.nx + f.x_lo +
                          (v - yy * f.tw),
                      val);
          }
        }
      }
    }
    kk = kn;
    vm = vn;
    cs ^= 1;
  }
  cp_async_wait<0>();
  if (valid && s_out != nullptr) s_out[pix] = st.S;
  if (GSMALL) block_partials(p, run, st, s_acc, tid, partials);
}

template <int MODE, typename T, int CK, bool GVOL, bool GSMALL>
cudaError_t launch_one(const SweepParams& p, const BwdParams& bp,
                       const void* vol, const float* zs, const float* lut,
                       const float* rows, const float* g, const float* tck,
                       float* d_planes, float* partials, float* mom,
                       float* s_out, int tw_b, int th_b, cudaStream_t stream) {
  const dim3 block(kBwdX, kBwdY);
  const dim3 grid((p.width + kBwdX - 1) / kBwdX,
                  (p.height + kBwdY - 1) / kBwdY);
  const int B = MODE == kNone ? 1 : p.n_bins;
  const size_t smem =
      stage_layout(tw_b, th_b, B, (int)sizeof(T), p.n_lut,
                   MODE == kNone ? 0 : p.n_rows * p.n_bins, 2,
                   bwd_extra((size_t)tw_b * th_b, p.n_lut, CK, GVOL,
                             GVOL && MODE == kVar, GSMALL))
          .total;
  const cudaError_t e = cudaFuncSetAttribute(
      slice_bwd_staged<MODE, T, CK, GVOL, GSMALL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  slice_bwd_staged<MODE, T, CK, GVOL, GSMALL><<<grid, block, smem, stream>>>(
      p, bp, static_cast<const T*>(vol), zs, lut, rows, g, tck, d_planes,
      partials, mom, s_out, tw_b, th_b);
  return cudaGetLastError();
}

template <int MODE, typename T, int CK>
cudaError_t dispatch_wrt(const SweepParams& p, const BwdParams& bp,
                         const void* vol, const float* zs, const float* lut,
                         const float* rows, const float* g, const float* tck,
                         float* d_planes, float* partials, float* mom,
                         float* s_out, int tw_b, int th_b, cudaStream_t s) {
  const bool gvol = bp.g_planes != 0;
  const bool gsmall = bp.g_lut != 0 || bp.g_params != 0;
#define VRDD_ONE(GV, GS)                                                    \
  launch_one<MODE, T, CK, GV, GS>(p, bp, vol, zs, lut, rows, g, tck,        \
                                  d_planes, partials, mom, s_out, tw_b, th_b, \
                                  s)
  if (gvol && gsmall) return VRDD_ONE(true, true);
  if (gvol) return VRDD_ONE(true, false);
  if (gsmall) return VRDD_ONE(false, true);
#undef VRDD_ONE
  return cudaErrorInvalidValue;
}

template <int MODE, typename T>
cudaError_t dispatch_ck(const SweepParams& p, const BwdParams& bp,
                        const void* vol, const float* zs, const float* lut,
                        const float* rows, const float* g, const float* tck,
                        float* d_planes, float* partials, float* mom,
                        float* s_out, int tw_b, int th_b, cudaStream_t s) {
  if (bp.ck_stride == 4)
    return dispatch_wrt<MODE, T, 4>(p, bp, vol, zs, lut, rows, g, tck,
                                    d_planes, partials, mom, s_out, tw_b,
                                    th_b, s);
  if (bp.ck_stride == 8)
    return dispatch_wrt<MODE, T, 8>(p, bp, vol, zs, lut, rows, g, tck,
                                    d_planes, partials, mom, s_out, tw_b,
                                    th_b, s);
  return cudaErrorInvalidValue;
}

}  // namespace

namespace vrdd {

cudaError_t launch_bwd_staged(const SweepParams& p, const BwdParams& bp,
                              int mode, int bf16, const void* vol,
                              const float* zs, const float* lut,
                              const float* rows, const float* g,
                              const float* tck, float* d_planes,
                              float* partials, float* mom, float* s_out,
                              int tw_b, int th_b, cudaStream_t stream) {
  using bf = __nv_bfloat16;
#define VRDD_BWD(M, TYPE)                                                   \
  dispatch_ck<M, TYPE>(p, bp, vol, zs, lut, rows, g, tck, d_planes,         \
                       partials, mom, s_out, tw_b, th_b, stream)
  switch (mode * 2 + (bf16 ? 1 : 0)) {
    case 0: return VRDD_BWD(kNone, float);
    case 1: return VRDD_BWD(kNone, bf);
    case 2: return VRDD_BWD(kLinear, float);
    case 3: return VRDD_BWD(kLinear, bf);
    case 4: return VRDD_BWD(kVar, float);
    case 5: return VRDD_BWD(kVar, bf);
    case 6: return VRDD_BWD(kEntropy, float);
    case 7: return VRDD_BWD(kEntropy, bf);
    default: return cudaErrorInvalidValue;
  }
#undef VRDD_BWD
}

}  // namespace vrdd
