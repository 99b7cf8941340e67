// The flexible-block re-query, for Hopper (sm_90a): every block's (mean,
// variance, entropy) from the integral histogram in one launch. For block
// (bz, by, bx) of the grid whose boundaries along z, y, x are ez, ey, ex
// (block i spans [e[i], e[i + 1]), int64, on the card), and each bin b,
//     n_b = S(z1, y1, x1) - S(z0, y1, x1) - S(z1, y0, x1) + S(z0, y0, x1)
//         - S(z1, y1, x0) + S(z0, y1, x0) + S(z1, y0, x0) - S(z0, y0, x0)
// in int32 (exact) from the table sat (Z+1, Y+1, X+1, B) int32, then
// d_computeBlock (volumeRender_kernel.cu:1041-1115): h_b = n_b / sum n,
// clamped to [0, 1] (n_b itself where the block is empty), the mean
// sum h_b c_b and the variance sum h_b (c_b - mean)^2 over the centres
// c_b = w b + w / 2, and the entropy -sum h_b log2 h_b / log2 B; written
// to out (nbz, nby, nbx, 3) float32.
//
// Replaces no pallas_call: the JAX package queries with 8 gathers and
// reduces with XLA (vrdd_tpu/ops/integral.py, ops/histogram.py). The plain
// version is the torch chain of models/flexible.py IntegralVolume.blocks
// off the card (ops/integral.py query_blocks, then ops/histogram.py
// normalize_histogram and flex_block_stats); the wrapper is
// kernels/flex_blocks.py block_stats.
//
// Arithmetic: the counts exact; each float32 step explicitly rounded
// (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn: nothing contracted into an
// FMA) in the plain version's order within a bin, the sums over a block's
// bins in bin order (torch's reductions take another), and log2f is
// CUDA's: the stats agree with the plain version to float32 rounding, not
// bitwise. An empty bin adds nothing and is skipped.
//
// What bounds it on the H100: the bytes, and the instructions a block
// needs. The distinct corner rows (B int32 each) are needed once: at
// Isabel's 500 x 500 x 100 in blocks of 2, 0.82 GB; the output is 37.5 MB.
// A first design (a warp a block, two bins a lane, warp shuffles for the
// sums) ran 3.6 ms there, issue-bound on its index arithmetic and
// reductions for two bins a lane.
//
// Design: a CTA owns a run of up to `tile` x-neighbouring blocks of one
// (bz, by) row (tile 128 for B <= 64, else 32). It first stages, for each
// of the run's tile + 1 x-boundaries, the (z, y) inclusion-exclusion of
// its four rows, C[c][b] = S(z1, y1) - S(z0, y1) - S(z1, y0) + S(z0, y0)
// at column c, into shared memory (16-byte loads, each row read once by
// the CTA; a row's 16 bytes a thread, neighbouring threads on
// neighbouring bytes), rows padded to B + 1 words so that the threads of
// a warp, each reading its own column, hit distinct banks. Then a thread a
// block: n_b = C[t + 1][b] - C[t][b]; a pass for the total, one for the
// mean, one for the variance and entropy, each over the B bins, skipping
// empty bins (a warp skips a bin where its 32 blocks are all empty, as
// neighbouring blocks of a smooth field mostly are). The bin centres sit
// in shared memory too (a broadcast read). No atomics: deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBins = 256;

template <bool kVec>
__global__ void flex_blocks_kernel(const int* __restrict__ sat,
                                   const long long* __restrict__ ez,
                                   const long long* __restrict__ ey,
                                   const long long* __restrict__ ex,
                                   float* __restrict__ out, int nby, int nbx,
                                   long long sz, long long sy, int n_bins,
                                   float w, float half_w, float log2_bins) {
  extern __shared__ int smem[];
  const int tile = blockDim.x;
  const int stride = n_bins + 1;  // a column's words: B + 1, bank-skewed
  int* cols = smem;
  float* centre = reinterpret_cast<float*>(smem + (tile + 1) * stride);
  const int by = blockIdx.y;
  const long long bz = blockIdx.z;
  const int x0 = blockIdx.x * tile;
  const int n_cols = min(tile, nbx - x0) + 1;
  const long long r11 = __ldg(ez + bz + 1) * sz + __ldg(ey + by + 1) * sy;
  const long long r01 = __ldg(ez + bz) * sz + __ldg(ey + by + 1) * sy;
  const long long r10 = __ldg(ez + bz + 1) * sz + __ldg(ey + by) * sy;
  const long long r00 = __ldg(ez + bz) * sz + __ldg(ey + by) * sy;

  for (int b = threadIdx.x; b < n_bins; b += tile)
    centre[b] = __fadd_rn(__fmul_rn((float)b, w), half_w);
  if (kVec) {
    const int chunks = n_bins / 4;
    for (int i = threadIdx.x; i < n_cols * chunks; i += tile) {
      const int c = i / chunks, q = i - c * chunks;
      const long long x = __ldg(ex + x0 + c) * n_bins + 4 * q;
      const int4 a = __ldg(reinterpret_cast<const int4*>(sat + r11 + x));
      const int4 p = __ldg(reinterpret_cast<const int4*>(sat + r01 + x));
      const int4 s = __ldg(reinterpret_cast<const int4*>(sat + r10 + x));
      const int4 d = __ldg(reinterpret_cast<const int4*>(sat + r00 + x));
      int* o = cols + c * stride + 4 * q;
      o[0] = a.x - p.x - s.x + d.x;
      o[1] = a.y - p.y - s.y + d.y;
      o[2] = a.z - p.z - s.z + d.z;
      o[3] = a.w - p.w - s.w + d.w;
    }
  } else {
    for (int i = threadIdx.x; i < n_cols * n_bins; i += tile) {
      const int c = i / n_bins, b = i - c * n_bins;
      const long long x = __ldg(ex + x0 + c) * n_bins + b;
      cols[c * stride + b] = __ldg(sat + r11 + x) - __ldg(sat + r01 + x) -
                             __ldg(sat + r10 + x) + __ldg(sat + r00 + x);
    }
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= n_cols - 1) return;
  const int* lo = cols + t * stride;
  const int* hi = lo + stride;
  int total = 0;
  for (int b = 0; b < n_bins; ++b) total += max(hi[b] - lo[b], 0);
  const float ft = (float)total;
  float mean = 0.0f;
  for (int b = 0; b < n_bins; ++b) {
    const int n = max(hi[b] - lo[b], 0);
    if (n == 0) continue;
    // 0 < n <= total: h is in (0, 1], where the plain version's clamp and
    // empty-block guard change nothing
    const float h = __fdiv_rn((float)n, ft);
    mean = __fadd_rn(mean, __fmul_rn(h, centre[b]));
  }
  float var = 0.0f, ent = 0.0f;
  for (int b = 0; b < n_bins; ++b) {
    const int n = max(hi[b] - lo[b], 0);
    if (n == 0) continue;
    const float h = __fdiv_rn((float)n, ft);
    const float dv = __fsub_rn(centre[b], mean);
    var = __fadd_rn(var, __fmul_rn(h, __fmul_rn(dv, dv)));
    ent = __fadd_rn(ent, __fmul_rn(h, log2f(h)));
  }
  float* o = out + (((long long)bz * nby + by) * nbx + x0 + t) * 3;
  o[0] = mean;
  o[1] = var;
  o[2] = __fdiv_rn(-ent, log2_bins);
}

}  // namespace

extern "C" __attribute__((visibility("default"))) int vrdd_flex_blocks(
    const int* sat, const long long* ez, const long long* ey,
    const long long* ex, float* out, int nbz, int nby, int nbx,
    long long sz, long long sy, int n_bins, float bin_width, void* stream) {
  if (nbz < 0 || nby < 0 || nbx < 0 || n_bins < 1 || n_bins > kMaxBins)
    return (int)cudaErrorInvalidValue;
  if ((long long)nbz * nby * nbx == 0) return (int)cudaSuccess;
  if (nby > 65535 || nbz > 65535) return (int)cudaErrorInvalidConfiguration;
  const int tile = n_bins <= 64 ? 128 : 32;
  const dim3 grid((nbx + tile - 1) / tile, nby, nbz);
  const size_t smem =
      ((size_t)(tile + 1) * (n_bins + 1) + n_bins) * sizeof(int);
  const bool vec =
      n_bins % 4 == 0 && (reinterpret_cast<uintptr_t>(sat) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float half_w = bin_width / 2.0f, log2_bins = log2f((float)n_bins);
  if (vec)
    flex_blocks_kernel<true><<<grid, tile, smem, s>>>(
        sat, ez, ey, ex, out, nby, nbx, sz, sy, n_bins, bin_width, half_w,
        log2_bins);
  else
    flex_blocks_kernel<false><<<grid, tile, smem, s>>>(
        sat, ez, ey, ex, out, nby, nbx, sz, sy, n_bins, bin_width, half_w,
        log2_bins);
  return (int)cudaGetLastError();
}
