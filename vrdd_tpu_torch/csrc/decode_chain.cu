// The histogram cotangent of the decode, for Hopper (sm_90a): for each voxel
// (z, y, x) of the bins-major (nz, B, ny, nx) volume and each bin b,
//     linear:  d_hist[z, b, y, x] = d_dec w0[b]
//     var:     d_dec (w2[b] - 2 m w1[b] + m^2 w3[b] + e w0[b])
//     entropy: d_dec (-w0[0]) (log2 max(h_b, 1e-30) + 1 / ln 2), 0 where
//              h_b is not > 0
// with d_dec = d_dec[z, y, x] the decoded-volume cotangent, w_r the decode
// row rows[r] ((n_rows, B) float32, on the card) and the variance moments
// m = sum_b h_b w0[b], e = 2 (m C0 - C1) (C1 = sum_b h_b w1[b], C0 = sum_b
// h_b w3[b]) read from mom (nz, 2, ny, nx), which the reverse sweep writes,
// or, without it, summed from the voxel's own bins in a first pass.
//
// Replaces no pallas_call: JAX leaves this chain to XLA
// (vrdd_tpu/pallas/slice_vjp.py:877-908), which fuses it into one pass over
// the volume. The plain version is kernels/slice_kernel.py
// decode_chain_reference (torch, a few z-layers at a time); the wrapper is
// decode_chain there, called by the backward of the histogram sweep
// (kernels/slice_vjp.py _grads) and of the materialized decode (_Decode).
//
// Arithmetic: float32, in the plain version's order of operations, each
// step explicitly rounded (__fmul_rn, __fadd_rn, __fsub_rn: nvcc contracts
// none of them into an FMA), then rounded once to the storage type
// (__float2bfloat16_rn for bf16). Linear and the variance from mom are
// bitwise the plain version run on the card; entropy uses the same log2f;
// the variance without mom sums its moments in bin order, which the plain
// version's einsum need not.
//
// What bounds it on the H100: the bytes. d_hist is written once (4.29 GB at
// 512^3 x 16 bf16) and d_dec read once (0.54 GB); entropy also reads the
// histograms (4.29 GB), the variance its moments (1.07 GB) or, without
// them, the histograms. 9.1 GB at 3.35 TB/s is 2.7 ms; entropy's 2.1 G
// log2f are about 1 ms of FP32 issue, hidden under the stream.
//
// Design: a pure stream, one launch for the whole volume. The (y, x) plane
// of a z-layer is contiguous in every array, so a thread owns 8 consecutive
// voxels of one layer's plane: it reads their d_dec once (two 16-byte
// loads) and their moments, then walks the B bins, each bin one 16-byte
// store of 8 bf16 (two for f32; entropy adds one load of h_b), neighbouring
// threads on neighbouring addresses, so a warp writes 512 contiguous bytes
// a bin. The stores stream (__stcs): d_hist passes straight through the
// 50 MB L2 and nothing here reads it again. The decode rows, the same few
// floats a bin for every thread, come through the read-only cache. No
// shared-memory tiles, TMA or tensor cores: at one read and one write an
// element there is nothing to reuse. No atomics and no sums across threads,
// so the output is deterministic. Where the plane is not a multiple of 8
// voxels or a pointer is not 16-byte aligned, the same mapping runs with
// scalar loads and stores, masked at the end of each plane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum ChainMode { kLinear = 0, kVarMom = 1, kVarOwn = 2, kEntropy = 3 };

constexpr int kThreads = 256;
constexpr int kVox = 8;  // voxels a thread

// the plain version's float32 constants: 1 / ln 2 (slice_kernel._INV_LN2)
// and 1e-30 rounded to float32, the minimum torch.clamp applies
constexpr float kInvLn2 = 0x1.715476p+0f;
constexpr float kEntTiny = 0x1.4484cp-100f;

// kVox floats from p: all of them (kVec: p 16-byte aligned) or the first n
template <bool kVec>
__device__ __forceinline__ void load(const float* __restrict__ p, int n,
                                     float (&v)[kVox]) {
  if (kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVox; ++j) v[j] = j < n ? __ldg(p + j) : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ p,
                                     int n, float (&v)[kVox]) {
  if (kVec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVox / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x, v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVox; ++j)
      v[j] = j < n ? __bfloat162float(p[j]) : 0.0f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store(float* __restrict__ p, int n,
                                      const float (&v)[kVox]) {
  if (kVec) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(v[4], v[5], v[6], v[7]));
  } else {
#pragma unroll
    for (int j = 0; j < kVox; ++j)
      if (j < n) __stcs(p + j, v[j]);
  }
}

template <bool kVec>
__device__ __forceinline__ void store(__nv_bfloat16* __restrict__ p, int n,
                                      const float (&v)[kVox]) {
  if (kVec) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVox / 2; ++j)
      h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  } else {
#pragma unroll
    for (int j = 0; j < kVox; ++j)
      if (j < n) p[j] = __float2bfloat16_rn(v[j]);
  }
}

template <int kMode, typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_chain_kernel(const T* __restrict__ hist,
                    const float* __restrict__ rows,
                    const float* __restrict__ d_dec,
                    const float* __restrict__ mom, T* __restrict__ d_hist,
                    long long total, long long groups, long long plane,
                    int n_bins) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long z = t / groups;
  const long long p0 = (t - z * groups) * kVox;
  const int n = (int)min((long long)kVox, plane - p0);
  const long long B = n_bins;

  float dz[kVox], m[kVox], e[kVox];
  load<kVec>(d_dec + z * plane + p0, n, dz);
  if (kMode == kVarMom) {
    load<kVec>(mom + 2 * z * plane + p0, n, m);
    load<kVec>(mom + (2 * z + 1) * plane + p0, n, e);
  }
  const T* h_z = hist + z * B * plane + p0;
  T* d_z = d_hist + z * B * plane + p0;
  if (kMode == kVarOwn) {
    float c1[kVox], c0[kVox];
#pragma unroll
    for (int j = 0; j < kVox; ++j) m[j] = c1[j] = c0[j] = 0.0f;
    for (int b = 0; b < n_bins; ++b) {
      float h[kVox];
      load<kVec>(h_z + b * plane, n, h);
      const float w0 = __ldg(rows + b), w1 = __ldg(rows + B + b);
      const float w3 = __ldg(rows + 3 * B + b);
#pragma unroll
      for (int j = 0; j < kVox; ++j) {
        m[j] = __fmaf_rn(h[j], w0, m[j]);
        c1[j] = __fmaf_rn(h[j], w1, c1[j]);
        c0[j] = __fmaf_rn(h[j], w3, c0[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kVox; ++j)
      e[j] = __fmul_rn(2.0f, __fsub_rn(__fmul_rn(m[j], c0[j]), c1[j]));
  }
  const float neg_w = kMode == kEntropy ? -__ldg(rows) : 0.0f;

#pragma unroll 2
  for (int b = 0; b < n_bins; ++b) {
    float d[kVox];
    if (kMode == kLinear) {
      const float w = __ldg(rows + b);
#pragma unroll
      for (int j = 0; j < kVox; ++j) d[j] = __fmul_rn(dz[j], w);
    } else if (kMode == kEntropy) {
      float h[kVox];
      load<kVec>(h_z + b * plane, n, h);
#pragma unroll
      for (int j = 0; j < kVox; ++j) {
        const float dlog =
            h[j] > 0.0f
                ? __fmul_rn(neg_w, __fadd_rn(log2f(fmaxf(h[j], kEntTiny)),
                                             kInvLn2))
                : 0.0f;
        d[j] = __fmul_rn(dz[j], dlog);
      }
    } else {
      const float w0 = __ldg(rows + b), w1 = __ldg(rows + B + b);
      const float w2 = __ldg(rows + 2 * B + b), w3 = __ldg(rows + 3 * B + b);
#pragma unroll
      for (int j = 0; j < kVox; ++j) {
        float s = __fsub_rn(w2, __fmul_rn(__fmul_rn(2.0f, m[j]), w1));
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(m[j], m[j]), w3));
        s = __fadd_rn(s, __fmul_rn(e[j], w0));
        d[j] = __fmul_rn(dz[j], s);
      }
    }
    store<kVec>(d_z + b * plane, n, d);
  }
}

template <int kMode, typename T>
cudaError_t launch(bool vec, const void* hist, const float* rows,
                   const float* d_dec, const float* mom, void* d_hist,
                   long long total, long long groups, long long plane,
                   int n_bins, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  const T* h = static_cast<const T*>(hist);
  T* d = static_cast<T*>(d_hist);
  if (vec)
    decode_chain_kernel<kMode, T, true><<<blocks, kThreads, 0, stream>>>(
        h, rows, d_dec, mom, d, total, groups, plane, n_bins);
  else
    decode_chain_kernel<kMode, T, false><<<blocks, kThreads, 0, stream>>>(
        h, rows, d_dec, mom, d, total, groups, plane, n_bins);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_mode(int mode, bool vec, const void* hist, const float* rows,
                    const float* d_dec, const float* mom, void* d_hist,
                    long long total, long long groups, long long plane,
                    int n_bins, cudaStream_t stream) {
  switch (mode) {
    case kLinear:
      return launch<kLinear, T>(vec, hist, rows, d_dec, mom, d_hist, total,
                                groups, plane, n_bins, stream);
    case kVarMom:
      return launch<kVarMom, T>(vec, hist, rows, d_dec, mom, d_hist, total,
                                groups, plane, n_bins, stream);
    case kVarOwn:
      return launch<kVarOwn, T>(vec, hist, rows, d_dec, mom, d_hist, total,
                                groups, plane, n_bins, stream);
    default:
      return launch<kEntropy, T>(vec, hist, rows, d_dec, mom, d_hist, total,
                                 groups, plane, n_bins, stream);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// mode: the decode (1 linear, 2 var, 3 entropy: kernels/slice_kernel.py
// _MODES); bf16: the storage type of hist and d_hist (1 bf16, 0 float32).
// hist (nz, n_bins, plane) and d_hist the same shape, rows (n_rows, n_bins)
// float32 (4 rows for var, else at least 1), d_dec (nz, plane) float32,
// mom (nz, 2, plane) float32 or null (var only; null: the moments come
// from hist), all contiguous on the card; plane = ny nx. Every element of
// d_hist is written. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" __attribute__((visibility("default"))) int vrdd_decode_chain(
    int mode, int bf16, const void* hist, const float* rows,
    const float* d_dec, const float* mom, void* d_hist, long long nz,
    int n_bins, long long plane, void* stream) {
  if (mode < 1 || mode > 3 || nz < 0 || n_bins < 0 || plane < 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = (plane + kVox - 1) / kVox;
  const long long total = nz * groups;
  if (total == 0 || n_bins == 0) return (int)cudaSuccess;
  if ((total + kThreads - 1) / kThreads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const int chain = mode == 1   ? kLinear
                    : mode == 3 ? kEntropy
                    : mom       ? kVarMom
                                : kVarOwn;
  const bool reads_hist = chain == kEntropy || chain == kVarOwn;
  const bool vec = plane % kVox == 0 && aligned16(d_dec) &&
                   aligned16(d_hist) && aligned16(reads_hist ? hist : nullptr) &&
                   aligned16(chain == kVarMom ? mom : nullptr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? by_mode<__nv_bfloat16>(chain, vec, hist, rows, d_dec,
                                              mom, d_hist, total, groups,
                                              plane, n_bins, s)
                    : by_mode<float>(chain, vec, hist, rows, d_dec, mom,
                                     d_hist, total, groups, plane, n_bins,
                                     s));
}
