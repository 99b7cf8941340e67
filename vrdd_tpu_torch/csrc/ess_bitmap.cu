// The empty-space-skipping (ESS) bitmap of the sweep kernels K1/K3/K4, in
// one launch.
//
// Replaces the XLA computation _ess_bitmap (vrdd_tpu/pallas/slice_kernel.py
// :397-506), which JAX fuses into the frame's jitted graph. Its plain torch
// version is ess_bitmap_reference in kernels/slice_kernel.py, a few dozen
// small torch ops around host geometry; this kernel computes the same bytes.
//
// Design. One thread per (chunk, tile row, tile column), where a tile is the
// sweep kernel's CUDA block (kernels/slice_kernel.py ESS_TILE, passed in as
// tile_h x tile_w) and a chunk is plane_chunk planes. A thread
//   1. takes its chunk's depth range [z_lo, z_hi] from zs;
//   2. bounds the world (x, y) of its tile's rays over that range by the four
//      corner rays (a ray's position on a plane is affine in depth and
//      slope), maps it to the 1-voxel-dilated texel range and then to the
//      range of the 8 x 8 blocks of the plane statistics;
//   3. takes the min / max of those blocks over the chunk's planes;
//   4. takes the largest |alpha| of the clamped piecewise-linear LUT over the
//      LUT-coordinate interval of [min, max] (widened by q_margin): at the
//      interval's ends or at a knot inside;
// and writes 1 where that alpha is nonzero, 0 where every sample of the
// tile in the chunk provably has alpha exactly 0.
//
// The arithmetic is the plain version's, operation for operation: the
// geometry in float64 (numpy there), the LUT part in float32 (torch there),
// each with explicitly rounded intrinsics so that nvcc contracts nothing
// into an FMA. The two bitmaps are therefore equal byte for byte, which the
// card tests check; the brute-force CPU test of the plain version's
// conservativeness then covers this kernel too.
//
// Bound on the H100: neither bytes nor operations. The inputs are the plane
// statistics (2 x P x 64 floats, 256 KB at P = 512) and the output one byte
// per (tile, chunk), 256 KB at 1024^2 x 64 chunks; each thread reads
// plane_chunk x (a few) blocks from L1/L2. A launch and a few microseconds.

#include <cuda_runtime.h>
#include <math.h>

// Must match EssParams in vrdd_tpu_torch/kernels/_build.py field for field.
struct EssParams {
  double ox, oy, oz;            // camera origin (float32 values)
  double mx0, dmx, my0, dmy;    // ray slope grids mx0 + dmx * j, my0 + dmy * i
  double xlo, xhi, ylo, yhi;    // the box in x and y
  double tex_offset, sx, sy;    // texel-centre offset, per-axis grid scale
  float tf_off, tf_scale, q_margin;
  int n_planes, plane_chunk, height, width, tile_h, tile_w;
  int ny, nx, n_lut, n_by, n_bx;
};

namespace {

// The corner rays' world coordinate on one axis over the tile's rays
// [t * size, min(t * size + size, extent) - 1] and the chunk's depth range.
__device__ __forceinline__ void corner_range(double o, double m0, double dm,
                                             int size, int t, int extent,
                                             double dz_lo, double dz_hi,
                                             double& lo, double& hi) {
  const double first = (double)(t * size);
  const double last = (double)(min(t * size + size, extent) - 1);
  const double ma = __dadd_rn(m0, __dmul_rn(dm, first));
  const double mb = __dadd_rn(m0, __dmul_rn(dm, last));
  const double c0 = __dadd_rn(o, __dmul_rn(dz_lo, ma));
  const double c1 = __dadd_rn(o, __dmul_rn(dz_lo, mb));
  const double c2 = __dadd_rn(o, __dmul_rn(dz_hi, ma));
  const double c3 = __dadd_rn(o, __dmul_rn(dz_hi, mb));
  lo = fmin(fmin(c0, c1), fmin(c2, c3));
  hi = fmax(fmax(c0, c1), fmax(c2, c3));
}

// World range [lo_w, hi_w] on one axis -> 1-voxel-dilated texel range ->
// the range [b_lo, b_hi] of the nb statistic blocks of an N-texel axis.
__device__ __forceinline__ void block_range(double lo_w, double hi_w,
                                            double lo_box, double hi_box,
                                            int N, int nb, double scale,
                                            double tex_offset, int& b_lo,
                                            int& b_hi) {
  const double ext = __dsub_rn(hi_box, lo_box);
  const double ns = __dmul_rn((double)N, scale);
  const double bsz = (double)((N + nb - 1) / nb);
  const double u_lo = __ddiv_rn(__dsub_rn(lo_w, lo_box), ext);
  const double u_hi = __ddiv_rn(__dsub_rn(hi_w, lo_box), ext);
  const double v_lo =
      __dsub_rn(floor(__dsub_rn(__dmul_rn(u_lo, ns), tex_offset)), 1.0);
  const double v_hi =
      __dadd_rn(ceil(__dsub_rn(__dmul_rn(u_hi, ns), tex_offset)), 2.0);
  const double top = (double)(nb - 1);
  b_lo = (int)fmin(fmax(floor(__ddiv_rn(v_lo, bsz)), 0.0), top);
  b_hi = (int)fmin(fmax(floor(__ddiv_rn(v_hi, bsz)), 0.0), top);
}

// |alpha| of the clamped linear LUT at coordinate q in [0, n_lut - 1].
__device__ __forceinline__ float alpha_at(const float* la, int n_lut,
                                          float q) {
  const float fl = floorf(q);
  const int i0 = min(max((int)fl, 0), n_lut - 1);
  const int i1 = min(i0 + 1, n_lut - 1);
  const float f = __fsub_rn(q, fl);
  return __fadd_rn(__fmul_rn(la[i0], __fsub_rn(1.0f, f)),
                   __fmul_rn(la[i1], f));
}

__global__ void __launch_bounds__(256)
ess_bitmap_kernel(const EssParams p, const float* __restrict__ pmin,
                  const float* __restrict__ pmax,
                  const float* __restrict__ zs, const float* __restrict__ lut,
                  unsigned char* __restrict__ out, int n_chunks, int n_ty,
                  int n_tx) {
  extern __shared__ float s_la[];  // |alpha| of each LUT entry
  for (int t = threadIdx.x; t < p.n_lut; t += blockDim.x)
    s_la[t] = fabsf(lut[4 * t + 3]);
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_chunks * n_ty * n_tx) return;
  const int tx = (int)(idx % n_tx);
  const int ty = (int)((idx / n_tx) % n_ty);
  const int c = (int)(idx / ((long long)n_tx * n_ty));
  const int k0 = c * p.plane_chunk;
  const int k1 = min(k0 + p.plane_chunk, p.n_planes);

  double z_lo = (double)zs[k0], z_hi = z_lo;
  for (int k = k0 + 1; k < k1; ++k) {
    z_lo = fmin(z_lo, (double)zs[k]);
    z_hi = fmax(z_hi, (double)zs[k]);
  }
  const double dz_lo = __dsub_rn(z_lo, p.oz), dz_hi = __dsub_rn(z_hi, p.oz);
  double y_lo, y_hi, x_lo, x_hi;
  corner_range(p.oy, p.my0, p.dmy, p.tile_h, ty, p.height, dz_lo, dz_hi,
               y_lo, y_hi);
  corner_range(p.ox, p.mx0, p.dmx, p.tile_w, tx, p.width, dz_lo, dz_hi,
               x_lo, x_hi);
  int by0, by1, bx0, bx1;
  block_range(y_lo, y_hi, p.ylo, p.yhi, p.ny, p.n_by, p.sy, p.tex_offset,
              by0, by1);
  block_range(x_lo, x_hi, p.xlo, p.xhi, p.nx, p.n_bx, p.sx, p.tex_offset,
              bx0, bx1);

  float vmin = INFINITY, vmax = -INFINITY;
  for (int k = k0; k < k1; ++k)
    for (int by = by0; by <= by1; ++by) {
      const size_t row = ((size_t)k * p.n_by + by) * p.n_bx;
      for (int bx = bx0; bx <= bx1; ++bx) {
        vmin = fminf(vmin, pmin[row + bx]);
        vmax = fmaxf(vmax, pmax[row + bx]);
      }
    }

  const float n = (float)p.n_lut;
  const float qa = __fsub_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(vmin, p.tf_off), p.tf_scale), n), 0.5f);
  const float qb = __fsub_rn(
      __fmul_rn(__fmul_rn(__fsub_rn(vmax, p.tf_off), p.tf_scale), n), 0.5f);
  const float top = n - 1.0f;
  const float q_lo =
      fminf(fmaxf(__fsub_rn(fminf(qa, qb), p.q_margin), 0.0f), top);
  const float q_hi =
      fminf(fmaxf(__fadd_rn(fmaxf(qa, qb), p.q_margin), 0.0f), top);
  float amax = fmaxf(alpha_at(s_la, p.n_lut, q_lo),
                     alpha_at(s_la, p.n_lut, q_hi));
  for (int k = 0; k < p.n_lut; ++k)  // knots inside [q_lo, q_hi]
    if (q_lo <= (float)k && q_hi >= (float)k) amax = fmaxf(amax, s_la[k]);
  // (chunk, tile row, tile column) order, as the sweep kernel reads it
  out[idx] = amax > 0.0f ? 1 : 0;
}

}  // namespace

// pmin, pmax: (n_planes, n_by, n_bx) float32 per-plane block statistics;
// zs: (n_planes,) float32 plane depths; lut: (n_lut, 4) float32; out:
// (ceil(n_planes / plane_chunk), ceil(height / tile_h), ceil(width /
// tile_w)) uint8. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" __attribute__((visibility("default"))) int vrdd_ess_bitmap(
    const EssParams* p, const float* pmin, const float* pmax, const float* zs,
    const float* lut, unsigned char* out, void* stream) {
  if (p->n_planes <= 0 || p->height <= 0 || p->width <= 0)
    return (int)cudaSuccess;
  if (p->plane_chunk <= 0 || p->tile_h <= 0 || p->tile_w <= 0 ||
      p->n_lut <= 0 || p->n_by <= 0 || p->n_bx <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (p->n_planes + p->plane_chunk - 1) / p->plane_chunk;
  const int n_ty = (p->height + p->tile_h - 1) / p->tile_h;
  const int n_tx = (p->width + p->tile_w - 1) / p->tile_w;
  const long long total = (long long)n_chunks * n_ty * n_tx;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  ess_bitmap_kernel<<<blocks, threads, sizeof(float) * p->n_lut,
                      static_cast<cudaStream_t>(stream)>>>(
      *p, pmin, pmax, zs, lut, out, n_chunks, n_ty, n_tx);
  return (int)cudaGetLastError();
}
