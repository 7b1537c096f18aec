// Assembled 27-point stencil apply (K4-3D) for Hopper (sm_90a).
//
//   stencil_apply_3d   out[b, k, j, i] = sum_m C[m, b, k, j, i]
//                                        * u[b, k + dk, j + dj, i + di]
//                      with m = ((dk + 1) * 3 + (dj + 1)) * 3 + (di + 1) (the
//                      offset order of
//                      diffnet_tpu_torch/train/stencil.py::_offsets) and
//                      u = 0 outside the domain (replaces
//                      diffnet_tpu/ops/stencil_apply.py _apply3d_fwd /
//                      _apply3d_fwd_folded)
//
// C is offset-major [27, Bc, nz, ny, nx] float32 with Bc = B (one operator
// per sample) or Bc = 1 (one operator for the batch, read with a batch
// stride of 0, never materialised); u and out are [B, nz, ny, nx].
//
// What bounds it: bytes. Each node reads its 27 coefficients and u and
// writes out, 116 B a node (243 MB at 1 x 128^3: at least 0.073 ms at
// 3.35 TB/s), against 27 FMAs. So the design only has to keep every byte
// read once from device memory: one thread per output node in 32 x 8
// blocks, one z plane a block row of the grid, x fastest, so each of the 27
// C planes and the output are read and written coalesced; the 3 x 3 x 3 u
// neighbourhood comes through L1/L2, where the neighbours' re-reads hit.
// Plane and batch offsets are 64-bit (27 x B x N passes 2^31 at modest
// sizes). The TPU kernel's z tiles, folded z, DMA double buffering and VMEM
// budget are not carried over.
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
stencil_apply_3d_kernel(const float* __restrict__ C, int64_t plane_stride,
                        int64_t c_bstride, const float* __restrict__ u,
                        float* __restrict__ out, int nz, int ny, int nx) {
  const int i = blockIdx.x * kBX + threadIdx.x;
  const int j = blockIdx.y * kBY + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int b = blockIdx.z / nz, k = blockIdx.z % nz;
  const int64_t field = (int64_t)nz * ny * nx;
  const int64_t node = ((int64_t)k * ny + j) * nx + i;
  const float* __restrict__ ub = u + (int64_t)b * field;
  const float* __restrict__ cb = C + (int64_t)b * c_bstride + node;
  float acc = 0.f;
#pragma unroll
  for (int dk = -1; dk <= 1; ++dk) {
    const int z = k + dk;
    const bool zin = z >= 0 && z < nz;
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj) {
      const int y = j + dj;
      const bool yin = zin && y >= 0 && y < ny;
#pragma unroll
      for (int di = -1; di <= 1; ++di) {
        const int x = i + di;
        const int m = ((dk + 1) * 3 + (dj + 1)) * 3 + (di + 1);
        const float c = __ldg(cb + m * plane_stride);
        const float v = (yin && x >= 0 && x < nx)
                            ? __ldg(ub + ((int64_t)z * ny + y) * nx + x)
                            : 0.f;
        acc = fmaf(c, v, acc);
      }
    }
  }
  out[(int64_t)b * field + node] = acc;
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

int stencil_apply_3d(const float* C, long long c_bstride, const float* u,
                     float* out, int B, int Bc, int nz, int ny, int nx,
                     void* stream) {
  const int64_t plane_stride = (int64_t)Bc * nz * ny * nx;
  const dim3 grid(cdiv(nx, kBX), cdiv(ny, kBY), (unsigned)(B * nz));
  const dim3 block(kBX, kBY);
  stencil_apply_3d_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      C, plane_stride, (int64_t)c_bstride, u, out, nz, ny, nx);
  return (int)cudaGetLastError();
}

}  // extern "C"
