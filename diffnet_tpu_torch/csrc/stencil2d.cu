// Assembled 9-point stencil apply (K4) for Hopper (sm_90a).
//
//   stencil_apply_2d   out[b, j, i] = sum_m C[m, b, j, i] * u[b, j + dj, i + di]
//                      with m = (dj + 1) * 3 + (di + 1) (the offset order of
//                      diffnet_tpu_torch/train/stencil.py::_offsets) and
//                      u = 0 outside the domain (replaces
//                      diffnet_tpu/ops/stencil_apply.py _apply2d_fwd)
//
// C is offset-major [9, Bc, nrows, ncols] float32 with Bc = B (one operator
// per sample) or Bc = 1 (one operator for the batch, read with a batch
// stride of 0, never materialised); u and out are [B, nrows, ncols].
//
// What bounds it: bytes. Each node reads its 9 coefficients and u and
// writes out, 44 B a node (369 MB at 512^2 x 32: at least 0.110 ms at
// 3.35 TB/s), against 9 FMAs. So the design only has to keep every byte
// read once from device memory: one thread per output node in 32 x 8
// blocks, x fastest, so each of the nine C planes and the output are read
// and written coalesced; the 3 x 3 u neighbourhood comes through L1/L2,
// where the neighbours' re-reads hit. The TPU kernel's strip tiling, DMA
// double buffering and tile-height budget are not carried over. Measured:
// 0.131 ms at 512^2 x 32 on an H100 (700 W), 84% of peak bandwidth.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success); the Python
// wrapper raises on any other value. Nothing here allocates or
// synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32, kBY = 8;

__global__ void __launch_bounds__(kBX * kBY)
stencil_apply_kernel(const float* __restrict__ C, int64_t plane_stride,
                     int64_t c_bstride, const float* __restrict__ u,
                     float* __restrict__ out, int nrows, int ncols) {
  const int i = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  if (i >= ncols || j >= nrows) return;
  const int64_t field = (int64_t)nrows * ncols;
  const int64_t node = (int64_t)j * ncols + i;
  const float* __restrict__ ub = u + (int64_t)blockIdx.z * field;
  const float* __restrict__ cb = C + (int64_t)blockIdx.z * c_bstride + node;
  float acc = 0.f;
#pragma unroll
  for (int dj = -1; dj <= 1; ++dj) {
    const int y = j + dj;
    const bool yin = y >= 0 && y < nrows;
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
      const int x = i + di;
      const int m = (dj + 1) * 3 + (di + 1);
      const float c = __ldg(cb + m * plane_stride);
      const float v = (yin && x >= 0 && x < ncols)
                          ? __ldg(ub + (int64_t)y * ncols + x)
                          : 0.f;
      acc = fmaf(c, v, acc);
    }
  }
  out[(int64_t)blockIdx.z * field + node] = acc;
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

int stencil_apply_2d(const float* C, long long c_bstride, const float* u,
                     float* out, int B, int Bc, int nrows, int ncols,
                     void* stream) {
  const int64_t plane_stride = (int64_t)Bc * nrows * ncols;
  const dim3 grid(cdiv(ncols, kBX), cdiv(nrows, kBY), B);
  const dim3 block(kBX, kBY);
  stencil_apply_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      C, plane_stride, (int64_t)c_bstride, u, out, nrows, ncols);
  return (int)cudaGetLastError();
}

}  // extern "C"
