// The empty-space-skipping (ESS) bitmap of the sweep kernels K1/K3/K4, in
// one launch: the bits each sweep kernel's block computes for itself
// (ess_common.cuh), written out as data for the callers that need the
// bitmap itself (the bench's roofline, the tests). No sweep reads it.
//
// Replaces the XLA computation _ess_bitmap (vrdd_tpu/pallas/slice_kernel.py
// :397-506). Its plain torch version is ess_bitmap_reference in
// kernels/slice_kernel.py; this kernel computes the same bytes.
//
// Design. One thread per (chunk, tile row, tile column) runs the test of
// ess_common.cuh (ess_chunk_live, which the sweep kernels run in groups of
// lanes); the block first builds the sparse table of the LUT's |alpha| in
// shared memory.
//
// Bound on the H100: neither bytes nor operations. The inputs are the plane
// statistics (2 x P x 64 floats, 256 KB at P = 512) and the output one byte
// per (tile, chunk), 256 KB at 1024^2 x 64 chunks; each thread reads
// plane_chunk x (a few) blocks from L1/L2. A launch and a few microseconds.

#include "ess_common.cuh"

namespace {

using namespace vrdd;

__global__ void __launch_bounds__(256)
ess_bitmap_kernel(const EssParams p, const float* __restrict__ pmin,
                  const float* __restrict__ pmax,
                  const float* __restrict__ zs, const float* __restrict__ lut,
                  unsigned char* __restrict__ out, int n_chunks, int n_ty,
                  int n_tx) {
  extern __shared__ float s_table[];  // sparse table of |alpha|
  ess_table_build(lut, p.n_lut, s_table, threadIdx.x, blockDim.x);

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_chunks * n_ty * n_tx) return;
  const int tx = (int)(idx % n_tx);
  const int ty = (int)((idx / n_tx) % n_ty);
  const int c = (int)(idx / ((long long)n_tx * n_ty));
  // (chunk, tile row, tile column) order, as the sweep kernel reads it
  out[idx] = ess_chunk_live(p, pmin, pmax, zs, s_table, c, ty, tx) ? 1 : 0;
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
  const size_t smem = sizeof(float) * vrdd::ess_table_floats(p->n_lut);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ess_bitmap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ess_bitmap_kernel<<<blocks, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      *p, pmin, pmax, zs, lut, out, n_chunks, n_ty, n_tx);
  return (int)cudaGetLastError();
}
