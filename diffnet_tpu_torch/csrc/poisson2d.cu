// Deg-1 (bilinear, 2x2 Gauss) 2D Poisson kernels for Hopper (sm_90a).
//
// One sum-factorised element body (`element_body`) serves three kernels:
//
//   poisson_stiffness_action  Ku = K(nu) u, assembled, one thread per node
//                             (replaces diffnet_tpu/ops/poisson_residual.py
//                             _stiffness_fwd_impl / _stiffness_fwd_bs)
//   poisson_resmin_loss_grad  L = sum R^2 and dL/du = 2 K(nu) R with
//                             R = where(bc > 0.5, 0, K(nu) u - Nf), one block
//                             per 16x16 tile (replaces
//                             diffnet_tpu/ops/poisson_loss_grad.py
//                             _loss_grad_impl)
//   poisson_energy            per-block partial sums of the Ritz energy
//                             sum_gp JxW (0.5 nu |grad u|^2 - u f), one
//                             thread per element (replaces
//                             diffnet_tpu/ops/poisson_energy.py
//                             _energy_fwd_impl)
//
// Fields are row-major [B, nrows, ncols] float32 (row = y, col = x). The
// three ops are memory-bound in principle (12-20 bytes per node); these
// first designs read each input once from device memory and keep
// intermediates (Gauss-point values, the resmin residual R) on chip, but
// K1 and K2 recompute each element body for every node that needs it, which
// leaves them bound by instruction issue (PERF.md has the measured times).
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream and returns cudaGetLastError() (0 = success); the Python
// wrappers raise on any other value. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Folded quadrature/metric constants of the sum-factorised stiffness body
// (see diffnet_tpu/ops/poisson_residual.py::_strip_lr): k1 = W/(4 h^2),
// k2 = W (p-q)^2 / (4 h^2) per axis, W the (equal) 2x2 Gauss JxW.
struct StiffConsts {
  float k1x, k2x, k1y, k2y;
};

// Folded constants of the sum-factorised energy body
// (diffnet_tpu/ops/poisson_energy.py::_build_tables_energy).
struct EnergyConsts {
  float c1x, c2x, c3x, c1y, c2y, c3y, cm;
};

// The four nodal contributions (corner 00, 01, 10, 11; first index y) of one
// element to the assembled K(nu) u, from its corner values of u (c..) and
// nu (n..). Exact for deg-1 2x2 Gauss: the Gauss sum factorises because
// dN/dxi is constant along its own axis.
__device__ __forceinline__ void element_body(
    float c00, float c01, float c10, float c11,
    float n00, float n01, float n10, float n11, const StiffConsts& k,
    float& a0, float& a1, float& a2, float& a3) {
  const float dxl = c01 - c00, dxh = c11 - c10;
  const float dyl = c10 - c00, dyh = c11 - c01;
  const float sxr0 = n00 + n01, sxr1 = n10 + n11;
  const float syc0 = n00 + n10, syc1 = n01 + n11;
  const float nsum = sxr0 + sxr1;

  const float Ux = dxl + dxh, Vx = dxl - dxh, Xx = sxr0 - sxr1;
  const float Mx = Vx * Xx;
  const float Qx = Ux * Xx + Vx * nsum;
  const float Rx = k.k1x * (Ux * nsum);
  const float px0 = Rx + k.k2x * (Mx + Qx);
  const float px1 = Rx + k.k2x * (Mx - Qx);

  const float Uy = dyl + dyh, Vy = dyl - dyh, Xy = syc0 - syc1;
  const float My = Vy * Xy;
  const float Qy = Uy * Xy + Vy * nsum;
  const float Ry = k.k1y * (Uy * nsum);
  const float py0 = Ry + k.k2y * (My + Qy);
  const float py1 = Ry + k.k2y * (My - Qy);

  a0 = -px0 - py0;
  a1 = px0 - py1;
  a2 = py0 - px1;
  a3 = px1 + py1;
}

// Read-only views of a field by global node (y, x).
struct GlobalField {
  const float* __restrict__ p;
  int ncols;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return __ldg(p + (int64_t)y * ncols + x);
  }
};

struct SharedField {
  const float* p;  // shared-memory tile whose (0, 0) is global node (y0, x0)
  int stride, y0, x0;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return p[(y - y0) * stride + (x - x0)];
  }
};

// Gather form of the assembly: node (j, i) sums the contribution of each of
// its (up to four) adjacent elements; element (ey, ex) exists for
// 0 <= ey < nel_r, 0 <= ex < nel_c. No atomics, and the same result on
// every run.
template <class Field>
__device__ __forceinline__ float node_action(const Field& u, const Field& nu,
                                             int j, int i, int nel_r,
                                             int nel_c, const StiffConsts& k) {
  float acc = 0.f;
#pragma unroll
  for (int dj = 0; dj < 2; ++dj) {
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      const int ey = j - 1 + dj, ex = i - 1 + di;
      if (ey < 0 || ey >= nel_r || ex < 0 || ex >= nel_c) continue;
      float a[4];
      element_body(u(ey, ex), u(ey, ex + 1), u(ey + 1, ex), u(ey + 1, ex + 1),
                   nu(ey, ex), nu(ey, ex + 1), nu(ey + 1, ex),
                   nu(ey + 1, ex + 1), k, a[0], a[1], a[2], a[3]);
      // the node is corner (jb, ib) = (1 - dj, 1 - di) of this element
      acc += a[2 * (1 - dj) + (1 - di)];
    }
  }
  return acc;
}

// Sum of `v` over a block of kThreads threads; the result is valid in
// thread 0. `red` holds kThreads / 32 floats.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) red[tid >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (tid < 32) {
    s = tid < kThreads / 32 ? red[tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

// ---------------------------------------------------------------- K1 ------
constexpr int kK1X = 32, kK1Y = 8;

__global__ void __launch_bounds__(kK1X * kK1Y)
stiffness_kernel(const float* __restrict__ u, const float* __restrict__ nu,
                 float* __restrict__ out, int nrows, int ncols,
                 StiffConsts k) {
  const int i = blockIdx.x * kK1X + threadIdx.x;
  const int j = blockIdx.y * kK1Y + threadIdx.y;
  if (i >= ncols || j >= nrows) return;
  const int64_t off = (int64_t)blockIdx.z * nrows * ncols;
  const GlobalField U{u + off, ncols}, NU{nu + off, ncols};
  out[off + (int64_t)j * ncols + i] =
      node_action(U, NU, j, i, nrows - 1, ncols - 1, k);
}

// ---------------------------------------------------------------- K2 ------
constexpr int kT = 16;  // output tile edge; 256 threads, one per tile node

__global__ void __launch_bounds__(kT * kT)
loss_grad_kernel(const float* __restrict__ u, const float* __restrict__ nu,
                 const float* __restrict__ nf, int64_t nf_bstride,
                 const float* __restrict__ bc, int64_t bc_bstride,
                 float* __restrict__ grad,
                 float* __restrict__ partials, int nrows, int ncols,
                 StiffConsts k) {
  __shared__ float su[kT + 4][kT + 4];   // u, nu with a 2-node halo
  __shared__ float snu[kT + 4][kT + 4];
  __shared__ float sr[kT + 2][kT + 2];   // R with a 1-node halo
  __shared__ float red[kT * kT / 32];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kT, x0 = blockIdx.x * kT;
  const int tid = threadIdx.y * kT + threadIdx.x;
  const int64_t off = (int64_t)b * nrows * ncols;
  const int64_t nfoff = (int64_t)b * nf_bstride;
  const int64_t boff = (int64_t)b * bc_bstride;
  const int nel_r = nrows - 1, nel_c = ncols - 1;

  // nodes outside the domain load as 0; only masked elements read them
  for (int t = tid; t < (kT + 4) * (kT + 4); t += kT * kT) {
    const int ly = t / (kT + 4), lx = t % (kT + 4);
    const int y = y0 - 2 + ly, x = x0 - 2 + lx;
    const bool in = y >= 0 && y < nrows && x >= 0 && x < ncols;
    const int64_t g = off + (int64_t)y * ncols + x;
    su[ly][lx] = in ? __ldg(u + g) : 0.f;
    snu[ly][lx] = in ? __ldg(nu + g) : 0.f;
  }
  __syncthreads();

  // 1. R on the tile plus its 1-node halo (zero outside the domain)
  const SharedField U{&su[0][0], kT + 4, y0 - 2, x0 - 2};
  const SharedField NU{&snu[0][0], kT + 4, y0 - 2, x0 - 2};
  for (int t = tid; t < (kT + 2) * (kT + 2); t += kT * kT) {
    const int ly = t / (kT + 2), lx = t % (kT + 2);
    const int y = y0 - 1 + ly, x = x0 - 1 + lx;
    float r = 0.f;
    if (y >= 0 && y < nrows && x >= 0 && x < ncols) {
      const int64_t g = (int64_t)y * ncols + x;
      const float ku = node_action(U, NU, y, x, nel_r, nel_c, k);
      r = __ldg(bc + boff + g) > 0.5f ? 0.f : ku - __ldg(nf + nfoff + g);
    }
    sr[ly][lx] = r;
  }
  __syncthreads();

  // 2. grad = 2 K(nu) R on the owned nodes; 3. their share of sum R^2
  const int j = y0 + threadIdx.y, i = x0 + threadIdx.x;
  float sq = 0.f;
  if (j < nrows && i < ncols) {
    const SharedField R{&sr[0][0], kT + 2, y0 - 1, x0 - 1};
    grad[off + (int64_t)j * ncols + i] =
        2.f * node_action(R, NU, j, i, nel_r, nel_c, k);
    const float r = sr[threadIdx.y + 1][threadIdx.x + 1];
    sq = r * r;
  }
  const float s = block_sum<kT * kT>(sq, red);
  if (tid == 0)
    partials[((int64_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
}

// ---------------------------------------------------------------- K3 ------
constexpr int kK3X = 32, kK3Y = 8;

__global__ void __launch_bounds__(kK3X * kK3Y)
energy_kernel(const float* __restrict__ u, const float* __restrict__ nu,
              const float* __restrict__ f, float* __restrict__ partials,
              int nrows, int ncols, EnergyConsts c) {
  __shared__ float red[kK3X * kK3Y / 32];
  const int ex = blockIdx.x * kK3X + threadIdx.x;
  const int ey = blockIdx.y * kK3Y + threadIdx.y;
  const int64_t off = (int64_t)blockIdx.z * nrows * ncols;
  float acc = 0.f;
  if (ex < ncols - 1 && ey < nrows - 1) {
    const GlobalField U{u + off, ncols}, NU{nu + off, ncols}, FF{f + off, ncols};
    const float c00 = U(ey, ex), c01 = U(ey, ex + 1);
    const float c10 = U(ey + 1, ex), c11 = U(ey + 1, ex + 1);
    const float n00 = NU(ey, ex), n01 = NU(ey, ex + 1);
    const float n10 = NU(ey + 1, ex), n11 = NU(ey + 1, ex + 1);
    const float f00 = FF(ey, ex), f01 = FF(ey, ex + 1);
    const float f10 = FF(ey + 1, ex), f11 = FF(ey + 1, ex + 1);

    const float dxl = c01 - c00, dxh = c11 - c10;
    const float dyl = c10 - c00, dyh = c11 - c01;
    const float sxr0 = n00 + n01, sxr1 = n10 + n11;
    const float syc0 = n00 + n10, syc1 = n01 + n11;
    const float nsum = sxr0 + sxr1;
    const float Xx = sxr0 - sxr1, Xy = syc0 - syc1;
    const float Ux = dxl + dxh, Vx = dxl - dxh;
    const float Uy = dyl + dyh, Vy = dyl - dyh;
    const float e_x = nsum * (c.c1x * (Ux * Ux) + c.c2x * (Vx * Vx)) + c.c3x * (Ux * Vx) * Xx;
    const float e_y = nsum * (c.c1y * (Uy * Uy) + c.c2y * (Vy * Vy)) + c.c3y * (Uy * Vy) * Xy;
    const float ga = 2.f * f00 + f10, gb = 2.f * f01 + f11;
    const float gc = f00 + 2.f * f10, gd = f01 + 2.f * f11;
    const float load = c.cm * (c00 * (2.f * ga + gb) + c01 * (ga + 2.f * gb) +
                               c10 * (2.f * gc + gd) + c11 * (gc + 2.f * gd));
    acc = e_x + e_y - load;
  }
  const float s = block_sum<kK3X * kK3Y>(acc, red);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

const char* poisson2d_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// Number of partial sums the K2 / K3 launches write; the wrappers allocate
// exactly this many.
long long poisson_resmin_loss_grad_partials(int B, int nrows, int ncols) {
  return (long long)B * cdiv(nrows, kT) * cdiv(ncols, kT);
}

long long poisson_energy_partials(int B, int nrows, int ncols) {
  return (long long)B * cdiv(ncols - 1, kK3X) * cdiv(nrows - 1, kK3Y);
}

int poisson_stiffness_action(const float* u, const float* nu, float* out,
                             int B, int nrows, int ncols, float k1x,
                             float k2x, float k1y, float k2y, void* stream) {
  const dim3 grid(cdiv(ncols, kK1X), cdiv(nrows, kK1Y), B);
  const dim3 block(kK1X, kK1Y);
  stiffness_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, nu, out, nrows, ncols, StiffConsts{k1x, k2x, k1y, k2y});
  return (int)cudaGetLastError();
}

int poisson_resmin_loss_grad(const float* u, const float* nu, const float* nf,
                             long long nf_bstride, const float* bc,
                             long long bc_bstride, float* grad,
                             float* partials, int B, int nrows, int ncols,
                             float k1x, float k2x, float k1y, float k2y,
                             void* stream) {
  const dim3 grid(cdiv(ncols, kT), cdiv(nrows, kT), B);
  const dim3 block(kT, kT);
  loss_grad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, nu, nf, (int64_t)nf_bstride, bc, (int64_t)bc_bstride, grad,
      partials, nrows, ncols, StiffConsts{k1x, k2x, k1y, k2y});
  return (int)cudaGetLastError();
}

int poisson_energy(const float* u, const float* nu, const float* f,
                   float* partials, int B, int nrows, int ncols, float c1x,
                   float c2x, float c3x, float c1y, float c2y, float c3y,
                   float cm, void* stream) {
  const dim3 grid(cdiv(ncols - 1, kK3X), cdiv(nrows - 1, kK3Y), B);
  const dim3 block(kK3X, kK3Y);
  energy_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, nu, f, partials, nrows, ncols,
      EnergyConsts{c1x, c2x, c3x, c1y, c2y, c3y, cm});
  return (int)cudaGetLastError();
}

}  // extern "C"
