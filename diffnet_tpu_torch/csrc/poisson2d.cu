// Deg-1 (bilinear, 2x2 Gauss) 2D Poisson kernels for Hopper (sm_90a).
//
// One sum-factorised element body (`element_body`) serves three kernels:
//
//   poisson_stiffness_action  Ku = K(nu) u, assembled (replaces
//                             diffnet_tpu/ops/poisson_residual.py
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
// Fields are row-major [B, nrows, ncols] (row = y, col = x): float32, or
// bfloat16 for K1 and K3 (loaded narrow, computed in float32 registers,
// K1's output rounded once on the store, K3's sums kept in float32). K2
// takes float32 only.
//
// K1 is bound by bytes: ~49 operations an element against 12 B a node in
// float32 (6 B in bfloat16) is ~4 operations a byte, far below the ~20 fp32
// operations a byte at which an H100 turns compute-bound. Its first design,
// a thread a node summing its four elements in gather form straight from
// device memory, computed every element body four times and issued 16 loads
// a node; it ran at 0.112 ms at 512^2 x 32, 27% of its byte bound, bound by
// instruction issue (NVIDIA H100 80GB HBM3, 700 W; PERF.md). The kernel
// here spends no instruction on recomputation (0.045 ms there on the same
// card, 67% of the bound; bf16 0.037 ms against 0.015):
//   * A block is one warp and owns a tile of 64 node columns x ty node rows
//     (ty = 5, 2 or 1, picked by the wrapper from the grid). It stages u
//     and nu on the tile plus a one-node halo, rows y0 - 1 .. y0 + ty and
//     columns x0 - 1 .. x0 + 64, in shared memory with cp.async, a lane a
//     16-B chunk. Not TMA: a tensor map needs row strides that are
//     multiples of 16 B, and 513-wide rows (the multigrid's fine level) are
//     not. Each staged row is the run of 16-B chunks, aligned in the flat
//     array, that covers its columns: a row shift that changes from row to
//     row costs an add and an AND, any row width and both types take the
//     same 16-B copies, and the array's last chunk is zero-filled past its
//     end.
//   * Lane l owns nodes x0 + 2l and x0 + 2l + 1 and computes the elements
//     of columns x0 + 2l - 1 and x0 + 2l, once each, walking down the tile:
//     it carries the bottom-corner sums of the element row above in
//     registers and takes the left corners of element x0 + 2l + 1 from lane
//     l + 1 by __shfl_down_sync; lane 31 takes those of the warp's one
//     extra element column (x0 + 63), which the lanes compute first, one
//     row each. Each lane writes its node pair with one 8-B store (4 B in
//     bf16) where rows are an even number of nodes wide, so a warp's row
//     is one coalesced 256-B store. The sums run in the first design's
//     order, so float32 results are bit-for-bit its results. No atomics,
//     and the same result on every run.
//   * Tensor cores have no part here: the body is a handful of products of
//     differences, no matrix product to hand them.
// K2 and K3 keep their first designs (PERF.md has their times).
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream and returns cudaGetLastError() (0 = success); the Python
// wrappers raise on any other value. Nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 B from global to shared memory, asynchronously; the bytes past
// `src_bytes` are filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

// Read-only views of a field by global node (y, x), in float32.
template <class T>
struct GlobalField {
  const T* __restrict__ p;
  int ncols;
  __device__ __forceinline__ float operator()(int y, int x) const {
    return to_f32(__ldg(p + (int64_t)y * ncols + x));
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
constexpr int kK1W = 64;   // node columns of a tile, two a lane
constexpr unsigned kFull = 0xffffffffu;

// 16-B chunks of a field's staged row: its kK1W + 2 columns at any
// alignment
template <class T>
__host__ __device__ constexpr int k1_chunks() {
  return (15 + (kK1W + 2) * (int)sizeof(T) + 15) / 16;
}
// bytes of a field's staged row: a 16-B lead (column x0 - 1 of the first
// tile lies before the first chunk) and the chunks; a staged row holds u's
// and then nu's
template <class T>
__host__ __device__ constexpr int k1_half_row() {
  return 16 + 16 * k1_chunks<T>();
}

// a pair of adjacent nodes, one store where the pair is aligned
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <class T>
__global__ void __launch_bounds__(32)
stiffness_kernel(const T* __restrict__ u, const T* __restrict__ nu,
                 T* __restrict__ out, int nrows, int ncols, int ty,
                 StiffConsts k) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kChunks = k1_chunks<T>(), kHalf = k1_half_row<T>();
  constexpr int kRow = 2 * kHalf, kE = (int)sizeof(T);
  const int rows = ty + 2;
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * kK1W, y0 = blockIdx.y * ty;
  const int64_t bbase = (int64_t)blockIdx.z * nrows * ncols;
  const int64_t total = (int64_t)gridDim.z * nrows * ncols * kE;
  const int c0 = max(x0 - 1, 0), c1 = min(x0 + kK1W + 1, ncols);

  // 1. stage node rows y0 - 1 .. y0 + ty, columns [c0, c1), of u and nu:
  //    the 16-B chunks from the one holding (r, c0) to the one holding
  //    (r, c1 - 1), flat-aligned (the wrapper passes 16-B aligned bases);
  //    a lane a chunk, 32 / kChunks rows at a time. Offsets are bytes from
  //    this sample's first node, in 32 bits (the wrapper checks that a
  //    sample's bytes fit). Rows outside the grid are not loaded; only
  //    elements outside the grid read them, and those contribute 0.
  {
    constexpr int kPer = 32 / kChunks;
    const int sub = lane / kChunks, ch = lane - sub * kChunks;
    const unsigned char* ub = (const unsigned char*)(u + bbase);
    const unsigned char* nub = (const unsigned char*)(nu + bbase);
    const int mis = (int)((bbase * kE) & 15);   // the sample's misalignment
    const int tail = (int)min(total - bbase * kE, (int64_t)INT32_MAX);
    const int width = (c1 - c0) * kE, pitch = ncols * kE;
    const int rl_end = min(rows, nrows - y0 + 1);   // rows past the grid
    int rl = max(0, 1 - y0) + sub;                  // and before it
    int g = ((y0 - 1 + rl) * ncols + c0) * kE;      // (r, c0)
    if (sub < kPer) {
      for (; rl < rl_end; rl += kPer, g += kPer * pitch) {
        const int src = g - ((mis + g) & 15) + 16 * ch;
        if (src >= g + width) continue;
        const int bytes = min(16, tail - src);
        unsigned char* dst = smem + rl * kRow + 16 + 16 * ch;
        cp_async16(dst, ub + src, bytes);
        cp_async16(dst + kHalf, nub + src, bytes);
      }
    }
  }
  cp_async_wait_all();
  __syncwarp();

  // byte offset of staged node (y0 - 1 + rl, x0 - 1) in its row: the lead,
  // less the column c0 - (x0 - 1) before c0, plus the row's shift
  const int lead = 16 - (c0 - (x0 - 1)) * kE;
  auto shift = [&](int rl) {
    return (int)((bbase * kE + ((int64_t)(y0 - 1 + rl) * ncols + c0) * kE)
                 & 15);
  };
  auto ld = [&](int off) {
    return to_f32(*reinterpret_cast<const T*>(smem + off));
  };

  // 2. the warp's extra element column x0 + 63 (lane 31's right
  //    neighbour), one element row y0 - 1 + l a lane: its left corners
  float e0 = 0.f, e2 = 0.f;
  if (lane <= ty) {
    const int t = lane * kRow + lead + shift(lane) + 64 * kE;
    const int b = (lane + 1) * kRow + lead + shift(lane + 1) + 64 * kE;
    float a0, a1, a2, a3;
    element_body(ld(t), ld(t + kE), ld(b), ld(b + kE), ld(t + kHalf),
                 ld(t + kHalf + kE), ld(b + kHalf), ld(b + kHalf + kE), k,
                 a0, a1, a2, a3);
    const int ey = y0 - 1 + lane;
    const bool ok = ey >= 0 && ey < nrows - 1 && x0 + 63 < ncols - 1;
    e0 = ok ? a0 : 0.f;
    e2 = ok ? a2 : 0.f;
  }

  // 3. walk down element columns A = x - 1 and B = x of node pair
  //    (x, x + 1), x = x0 + 2 lane: node (ey, x) is corner 11 of element
  //    (ey - 1, x - 1), 10 of (ey - 1, x), 01 of (ey, x - 1) and 00 of
  //    (ey, x), summed in that order; node x + 1 takes element x + 1 from
  //    lane + 1
  const int x = x0 + 2 * lane;
  const bool ok_a = x - 1 >= 0 && x - 1 < ncols - 1;
  const bool ok_b = x < ncols - 1;
  const bool pairs = (ncols & 1) == 0;   // every pair 2-node aligned
  const int step = (ncols * kE) & 15;    // the shift's change a row
  const int col = lead + 2 * lane * kE;
  int sh = shift(0);
  float ut0, ut1, ut2, nt0, nt1, nt2;
  {
    const int o = col + sh;
    ut0 = ld(o), ut1 = ld(o + kE), ut2 = ld(o + 2 * kE);
    nt0 = ld(o + kHalf), nt1 = ld(o + kHalf + kE);
    nt2 = ld(o + kHalf + 2 * kE);
  }
  float carry0 = 0.f, carry1 = 0.f;
  T* __restrict__ o = out + bbase;
#pragma unroll 2
  for (int s = 0; s <= ty; ++s) {
    const int ey = y0 - 1 + s;
    sh = (sh + step) & 15;
    const int bo = (s + 1) * kRow + col + sh;
    const float ub0 = ld(bo), ub1 = ld(bo + kE), ub2 = ld(bo + 2 * kE);
    const float nb0 = ld(bo + kHalf), nb1 = ld(bo + kHalf + kE);
    const float nb2 = ld(bo + kHalf + 2 * kE);
    float a0, a1, a2, a3, b0, b1, b2, b3;
    element_body(ut0, ut1, ub0, ub1, nt0, nt1, nb0, nb1, k, a0, a1, a2, a3);
    element_body(ut1, ut2, ub1, ub2, nt1, nt2, nb1, nb2, k, b0, b1, b2, b3);
    const bool row_ok = ey >= 0 && ey < nrows - 1;
    const bool va = row_ok && ok_a, vb = row_ok && ok_b;
    a0 = va ? a0 : 0.f;
    a1 = va ? a1 : 0.f;
    a2 = va ? a2 : 0.f;
    a3 = va ? a3 : 0.f;
    b0 = vb ? b0 : 0.f;
    b1 = vb ? b1 : 0.f;
    b2 = vb ? b2 : 0.f;
    b3 = vb ? b3 : 0.f;
    float r0 = __shfl_down_sync(kFull, a0, 1);
    float r2 = __shfl_down_sync(kFull, a2, 1);
    const float x0v = __shfl_sync(kFull, e0, s);
    const float x2v = __shfl_sync(kFull, e2, s);
    if (lane == 31) {
      r0 = x0v;
      r2 = x2v;
    }
    if (s > 0 && ey < nrows) {
      const float v0 = (carry0 + a1) + b0, v1 = (carry1 + b1) + r0;
      T* p = o + (int64_t)ey * ncols + x;
      if (pairs && x + 1 < ncols) {
        store_pair(p, v0, v1);
      } else {
        if (x < ncols) p[0] = from_f32<T>(v0);
        if (x + 1 < ncols) p[1] = from_f32<T>(v1);
      }
    }
    carry0 = a3 + b2;
    carry1 = b3 + r2;
    ut0 = ub0;
    ut1 = ub1;
    ut2 = ub2;
    nt0 = nb0;
    nt1 = nb1;
    nt2 = nb2;
  }
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

template <class T>
__global__ void __launch_bounds__(kK3X * kK3Y)
energy_kernel(const T* __restrict__ u, const T* __restrict__ nu,
              const T* __restrict__ f, float* __restrict__ partials,
              int nrows, int ncols, EnergyConsts c) {
  __shared__ float red[kK3X * kK3Y / 32];
  const int ex = blockIdx.x * kK3X + threadIdx.x;
  const int ey = blockIdx.y * kK3Y + threadIdx.y;
  const int64_t off = (int64_t)blockIdx.z * nrows * ncols;
  float acc = 0.f;
  if (ex < ncols - 1 && ey < nrows - 1) {
    const GlobalField<T> U{u + off, ncols}, NU{nu + off, ncols},
        FF{f + off, ncols};
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

// ty: node rows of a tile, 1 to 31 (the wrapper picks it from the grid);
// bf16: 1 for bfloat16 fields, 0 for float32. u and nu must start on 16-B
// boundaries, and a sample's bytes must fit in 31 bits. Anything else is
// refused with cudaErrorInvalidValue.
int poisson_stiffness_action(const void* u, const void* nu, void* out, int B,
                             int nrows, int ncols, int ty, int bf16,
                             float k1x, float k2x, float k1y, float k2y,
                             void* stream) {
  if (ty < 1 || ty > 31 || ((uintptr_t)u | (uintptr_t)nu) % 16 != 0 ||
      (int64_t)nrows * ncols * (bf16 ? 2 : 4) > INT32_MAX - 64)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(ncols, kK1W), cdiv(nrows, ty), B);
  const StiffConsts k{k1x, k2x, k1y, k2y};
  cudaStream_t s = (cudaStream_t)stream;
  const int staged = 2 * (ty + 2);   // field rows of u and nu
  if (bf16) {
    using T = __nv_bfloat16;
    stiffness_kernel<T><<<grid, 32, staged * k1_half_row<T>(), s>>>(
        (const T*)u, (const T*)nu, (T*)out, nrows, ncols, ty, k);
  } else {
    stiffness_kernel<float><<<grid, 32, staged * k1_half_row<float>(), s>>>(
        (const float*)u, (const float*)nu, (float*)out, nrows, ncols, ty,
        k);
  }
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

// bf16: 1 for bfloat16 fields, 0 for float32; the partials are float32.
int poisson_energy(const void* u, const void* nu, const void* f,
                   float* partials, int B, int nrows, int ncols, int bf16,
                   float c1x, float c2x, float c3x, float c1y, float c2y,
                   float c3y, float cm, void* stream) {
  const dim3 grid(cdiv(ncols - 1, kK3X), cdiv(nrows - 1, kK3Y), B);
  const dim3 block(kK3X, kK3Y);
  const EnergyConsts c{c1x, c2x, c3x, c1y, c2y, c3y, cm};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    energy_kernel<T><<<grid, block, 0, s>>>((const T*)u, (const T*)nu,
                                            (const T*)f, partials, nrows,
                                            ncols, c);
  } else {
    energy_kernel<float><<<grid, block, 0, s>>>(
        (const float*)u, (const float*)nu, (const float*)f, partials, nrows,
        ncols, c);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
