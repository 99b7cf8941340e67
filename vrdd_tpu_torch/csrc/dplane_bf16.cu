// The y-transpose of the reverse sweep's bf16 mode, for Hopper (sm_90a):
//     d_planes[layer(k), y, x] = sum_r bf16(wy[k, r, y]) bf16(dtmp[k, r, x])
// over the image rows r, where dtmp (n_planes, H, nx) is the row buffer K5
// filled (bwd_common.cuh scatter_row) and wy[k, r, :] the y tent weights of
// image row r on plane k.
//
// Replaces the _stage_dplane step of the backward Pallas kernel
// (vrdd_tpu/pallas/slice_vjp.py:509-528, d_plane += bf16(wy)^T @
// bf16(dtmp) per plane): in bf16 mode JAX rounds the whole-row sums dtmp to
// bf16 before this product, so the port's f32 path, which scatters
// wy wx d_res per ray, cannot give its bits. The plain version is
// kernels/slice_vjp.py dplane_bf16_reference; the wrapper is dplane_bf16
// there, launched by sweep_bwd after K5.
//
// Design. wy has two nonzero taps per row, (y0, y1 = min(y0 + 1, ny - 1)),
// computed with the forward's own arithmetic (make_ray, axis_taps), so a
// gather needs for output row y only the rows r with y0(r) in {y - 1, y}.
// y0(r) and the row's position in the box are monotone in r (axis_taps is a
// chain of correctly rounded monotone operations of the slope, the premise
// of stage_tile.cuh's footprint), so the rows a tile of kTy output rows
// needs, and that lie in the box, are one interval, found by two binary
// searches. A block of 128 threads (one column x each) walks that interval
// in order of r, loading each dtmp row once (coalesced), rounding it and
// adding its two weighted taps into the thread's column of a kTy-row
// shared-memory tile; no atomics, so the result is deterministic. Rows outside the box in y carry no cotangent (K5 skips
// their samples) and are not read.
//
// What bounds it on the H100: the bytes, dtmp read once (4 P H nx) and
// d_planes written once (4 P ny nx); 2 FMAs per dtmp element.

#include "sweep_common.cuh"

namespace {

using namespace vrdd;

constexpr int kTy = 16;      // output rows per block
constexpr int kThreads = 128;

// The y taps of image row r on the plane at depth z, and the row's
// position p01 in the box in y there (inside: [0, 1]).
struct RowTap {
  int y0, y1;
  float w0, w1, p01;
};

__device__ __forceinline__ RowTap row_tap(const SweepParams& p, float z,
                                          int r) {
  const Ray ray = make_ray(p, r, 0);
  const float yw = __fadd_rn(p.oy, __fmul_rn(__fsub_rn(z, p.oz), ray.my));
  RowTap t;
  axis_taps(yw, p.ny, p.ylo, p.yhi, p.sy, p.tex_offset,
            p.filter_linear != 0, t.y0, t.y1, t.w0, t.w1);
  t.p01 = axis_p01(yw, p.ylo, p.yhi);
  return t;
}

// The first r in [0, n) where pred(r) holds, for pred monotone false->true
// (n if none).
template <typename Pred>
__device__ __forceinline__ int first_true(int n, Pred pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(mid))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
dplane_bf16_kernel(const SweepParams p, const float* __restrict__ zs,
                   const float* __restrict__ dtmp,
                   float* __restrict__ d_planes) {
  const int k = blockIdx.z;
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int yb = blockIdx.y * kTy;
  const int ye = min(yb + kTy, p.ny) - 1;
  const float z = __ldg(zs + k);
  const int H = p.height;

  // the rows in the box whose taps reach [yb, ye]: y0 in [yb - 1, ye] and
  // p01 in [0, 1]. y0 is non-decreasing in p01, so lo_ok and hi_ok are
  // monotone in r, in opposite senses, and the rows are [ra, rb)
  auto lo_ok = [&](int r) {
    const RowTap t = row_tap(p, z, r);
    return t.p01 >= 0.0f && t.y0 >= yb - 1;
  };
  auto hi_ok = [&](int r) {
    const RowTap t = row_tap(p, z, r);
    return t.p01 <= 1.0f && t.y0 <= ye;
  };
  int ra = 0, rb = 0;
  if (H > 0) {
    const bool inc = row_tap(p, z, H - 1).p01 >= row_tap(p, z, 0).p01;
    if (inc) {
      ra = first_true(H, lo_ok);
      rb = first_true(H, [&](int r) { return !hi_ok(r); });
    } else {
      ra = first_true(H, hi_ok);
      rb = first_true(H, [&](int r) { return !lo_ok(r); });
    }
  }

  // this thread's column of the tile's sums (row u: output row yb + u)
  __shared__ float s_acc[kTy][kThreads];
  float* acc = &s_acc[0][threadIdx.x];
#pragma unroll
  for (int u = 0; u < kTy; ++u) acc[u * kThreads] = 0.0f;
  if (x < p.nx) {
    const float* col = dtmp + (size_t)k * H * p.nx + x;
    for (int r = ra; r < rb; ++r) {
      const RowTap t = row_tap(p, z, r);
      const float d = bf16r(__ldg(col + (size_t)r * p.nx));
      const int u0 = t.y0 - yb, u1 = t.y1 - yb;
      if (u0 >= 0 && u0 < kTy)
        acc[u0 * kThreads] = __fmaf_rn(bf16r(t.w0), d, acc[u0 * kThreads]);
      if (u1 >= 0 && u1 < kTy)
        acc[u1 * kThreads] = __fmaf_rn(bf16r(t.w1), d, acc[u1 * kThreads]);
    }
    const int layer = p.reverse ? p.n_layers - 1 - k : k;
    float* out = d_planes + (size_t)layer * p.ny * p.nx + x;
    for (int u = 0; u <= ye - yb; ++u)
      out[(size_t)(yb + u) * p.nx] = acc[u * kThreads];
  }
}

}  // namespace

// dtmp (n_planes, H, nx) f32, the row buffer of the bf16-mode K5 with the
// same params; d_planes (n_layers, ny, nx) f32, every element of the
// layers of the n_planes planes written. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" __attribute__((visibility("default"))) int vrdd_dplane_bf16(
    const SweepParams* p, const float* zs, const float* dtmp,
    float* d_planes, void* stream) {
  if (p->n_planes <= 0 || p->ny <= 0 || p->nx <= 0) return (int)cudaSuccess;
  const dim3 grid((p->nx + kThreads - 1) / kThreads,
                  (p->ny + kTy - 1) / kTy, p->n_planes);
  dplane_bf16_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*p, zs, dtmp,
                                                            d_planes);
  return (int)cudaGetLastError();
}
