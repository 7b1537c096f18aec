// Deg-1 (trilinear, 2x2x2 Gauss) 3D Poisson stiffness action (K5) for
// Hopper (sm_90a).
//
//   poisson_stiffness_action_3d  Ku = K(nu) u, assembled (replaces
//                                diffnet_tpu/ops/poisson_residual_3d.py
//                                _stiffness3d_fwd_impl / _stiffness3d_fwd_bs
//                                / _stiffness3d_fwd_folded)
//
// Fields are row-major [B, nz, ny, nx] float32 (x fastest).
//
// What bounds it: operations. It moves u and nu in and Ku out, 12 B a node,
// against about 280 fp32 operations an element in the sum-factorised body
// below and 7 a node to assemble (at 4 x 64^3: 12.6 MB, 3.8 us at 3.35
// TB/s, against 0.29 GFLOP, 4.3 us at 67 TFLOP/s). So the design computes
// each element once: a block owns a 16 x 8 x 4 tile of output nodes, one
// thread a node; it stages u and nu on the tile's nodes plus a one-node
// halo in shared memory, computes the 17 x 9 x 5 elements that touch the
// tile (1.5 elements a node, against the 8 a node of a gather form that
// recomputes each element for each of its corners), keeps their eight
// corner contributions in shared memory, and each thread sums the eight
// that reach its node. No atomics, and the same result on every run. The
// TPU kernel's z slabs, folded z, VMEM budgets and DMA halos are not
// carried over.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success); the Python
// wrapper raises on any other value. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cN[g][a]: the 1D shape value of local node a at Gauss point g; w*2 the
// folded scales W / h_axis^2 (W the equal JxW of the 2x2x2 Gauss points).
struct Consts3D {
  float c00, c01, c10, c11, wx2, wy2, wz2;
};

constexpr int kTX = 16, kTY = 8, kTZ = 4;                   // output nodes
constexpr int kEX = kTX + 1, kEY = kTY + 1, kEZ = kTZ + 1;  // elements
constexpr int kNX = kTX + 2, kNY = kTY + 2, kNZ = kTZ + 2;  // staged nodes
constexpr int kThreads = kTX * kTY * kTZ;
constexpr int kElems = kEX * kEY * kEZ;
constexpr int kNodes = kNX * kNY * kNZ;

// One axis' part of the element action: D[a][b] (u differences along the
// axis) and S[a][b] (nu sums along it) on the 2 x 2 corner offsets of the
// two other axes -> p[a][b], the projection onto their test values. Per
// Gauss pair (ga, gb) the interpolated derivative and nu multiply; dN/dxi
// is constant along the axis itself, so its Gauss sum collapses into S.
__device__ __forceinline__ void axis_part(const float D[2][2],
                                          const float S[2][2],
                                          const Consts3D& k, float scale,
                                          float p[2][2]) {
  const float cN[2][2] = {{k.c00, k.c01}, {k.c10, k.c11}};
  float t[2][2];
#pragma unroll
  for (int ga = 0; ga < 2; ++ga) {
    float dA[2], sA[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      dA[b] = fmaf(cN[ga][0], D[0][b], cN[ga][1] * D[1][b]);
      sA[b] = fmaf(cN[ga][0], S[0][b], cN[ga][1] * S[1][b]);
    }
#pragma unroll
    for (int gb = 0; gb < 2; ++gb) {
      const float du = fmaf(cN[gb][0], dA[0], cN[gb][1] * dA[1]);
      const float A = fmaf(cN[gb][0], sA[0], cN[gb][1] * sA[1]);
      t[ga][gb] = du * A;
    }
  }
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) {
    const float r0 = fmaf(cN[0][bb], t[0][0], cN[1][bb] * t[0][1]);
    const float r1 = fmaf(cN[0][bb], t[1][0], cN[1][bb] * t[1][1]);
#pragma unroll
    for (int ab = 0; ab < 2; ++ab)
      p[ab][bb] = scale * fmaf(cN[0][ab], r0, cN[1][ab] * r1);
  }
}

// The eight nodal contributions of one element, a[(kb * 2 + jb) * 2 + ib],
// from its corner values uc[k][j][i] of u and nc[k][j][i] of nu.
__device__ __forceinline__ void element_body(const float uc[2][2][2],
                                             const float nc[2][2][2],
                                             const Consts3D& k, float a[8]) {
  float D[2][2], S[2][2], px[2][2], py[2][2], pz[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      D[p][q] = uc[p][q][1] - uc[p][q][0];
      S[p][q] = nc[p][q][0] + nc[p][q][1];
    }
  axis_part(D, S, k, k.wx2, px);  // px[kb][jb]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      D[p][q] = uc[p][1][q] - uc[p][0][q];
      S[p][q] = nc[p][0][q] + nc[p][1][q];
    }
  axis_part(D, S, k, k.wy2, py);  // py[kb][ib]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      D[p][q] = uc[1][p][q] - uc[0][p][q];
      S[p][q] = nc[0][p][q] + nc[1][p][q];
    }
  axis_part(D, S, k, k.wz2, pz);  // pz[jb][ib]
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int jb = 0; jb < 2; ++jb)
#pragma unroll
      for (int ib = 0; ib < 2; ++ib) {
        const float x = ib ? px[kb][jb] : -px[kb][jb];
        const float y = jb ? py[kb][ib] : -py[kb][ib];
        const float z = kb ? pz[jb][ib] : -pz[jb][ib];
        a[(kb * 2 + jb) * 2 + ib] = x + y + z;
      }
}

__global__ void __launch_bounds__(kThreads)
stiffness3d_kernel(const float* __restrict__ u, const float* __restrict__ nu,
                   float* __restrict__ out, int nz, int ny, int nx,
                   int tiles_z, Consts3D k) {
  __shared__ float su[kNodes];
  __shared__ float snu[kNodes];
  __shared__ float sa[8][kElems];   // corner-major: conflict-free rows

  const int b = blockIdx.z / tiles_z;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const int z0 = (blockIdx.z % tiles_z) * kTZ;
  const int tid = (threadIdx.z * kTY + threadIdx.y) * kTX + threadIdx.x;
  const int64_t field = (int64_t)nz * ny * nx;
  const float* __restrict__ ub = u + (int64_t)b * field;
  const float* __restrict__ nub = nu + (int64_t)b * field;

  // 1. u and nu on nodes [z0 - 1, z0 + kTZ] x ...; outside the domain 0
  //    (only elements that are masked out below read them)
  for (int t = tid; t < kNodes; t += kThreads) {
    const int lx = t % kNX, ly = (t / kNX) % kNY, lz = t / (kNX * kNY);
    const int x = x0 - 1 + lx, y = y0 - 1 + ly, z = z0 - 1 + lz;
    const bool in = x >= 0 && x < nx && y >= 0 && y < ny && z >= 0 && z < nz;
    const int64_t g = ((int64_t)z * ny + y) * nx + x;
    su[t] = in ? __ldg(ub + g) : 0.f;
    snu[t] = in ? __ldg(nub + g) : 0.f;
  }
  __syncthreads();

  // 2. each element touching the tile, once; elements outside the domain
  //    contribute 0
  for (int e = tid; e < kElems; e += kThreads) {
    const int ex = e % kEX, ey = (e / kEX) % kEY, ez = e / (kEX * kEY);
    const int gx = x0 - 1 + ex, gy = y0 - 1 + ey, gz = z0 - 1 + ez;
    float a[8];
    if (gx >= 0 && gx < nx - 1 && gy >= 0 && gy < ny - 1 && gz >= 0 &&
        gz < nz - 1) {
      float uc[2][2][2], nc[2][2][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int s = ((ez + kk) * kNY + ey + j) * kNX + ex + i;
            uc[kk][j][i] = su[s];
            nc[kk][j][i] = snu[s];
          }
      element_body(uc, nc, k, a);
    } else {
#pragma unroll
      for (int m = 0; m < 8; ++m) a[m] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) sa[m][e] = a[m];
  }
  __syncthreads();

  // 3. node (z, y, x) is corner (kb, jb, ib) of element (z-kb, y-jb, x-ib),
  //    local element (lz+1-kb, ly+1-jb, lx+1-ib)
  const int lx = threadIdx.x, ly = threadIdx.y, lz = threadIdx.z;
  const int x = x0 + lx, y = y0 + ly, z = z0 + lz;
  if (x >= nx || y >= ny || z >= nz) return;
  float acc = 0.f;
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int jb = 0; jb < 2; ++jb)
#pragma unroll
      for (int ib = 0; ib < 2; ++ib)
        acc += sa[(kb * 2 + jb) * 2 + ib]
                 [((lz + 1 - kb) * kEY + ly + 1 - jb) * kEX + lx + 1 - ib];
  out[(int64_t)b * field + ((int64_t)z * ny + y) * nx + x] = acc;
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

int poisson_stiffness_action_3d(const float* u, const float* nu, float* out,
                                int B, int nz, int ny, int nx, float c00,
                                float c01, float c10, float c11, float wx2,
                                float wy2, float wz2, void* stream) {
  const int tiles_z = (int)cdiv(nz, kTZ);
  const dim3 grid(cdiv(nx, kTX), cdiv(ny, kTY), (unsigned)(B * tiles_z));
  const dim3 block(kTX, kTY, kTZ);
  stiffness3d_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, nu, out, nz, ny, nx, tiles_z,
      Consts3D{c00, c01, c10, c11, wx2, wy2, wz2});
  return (int)cudaGetLastError();
}

}  // extern "C"
