// Deg-1 (bilinear, 2x2 Gauss) 2D Poisson kernels for Hopper (sm_90a).
//
// One sum-factorised element body (`element_body`) serves three kernels:
//
//   poisson_stiffness_action  Ku = K(nu) u, assembled (replaces
//                             diffnet_tpu/ops/poisson_residual.py
//                             _stiffness_fwd_impl / _stiffness_fwd_bs)
//   poisson_resmin_loss_grad  per-warp partials of L = sum R^2 and
//                             dL/du = 2 K(nu) R with R = where(bc > 0.5, 0,
//                             K(nu) u - Nf) (replaces
//                             diffnet_tpu/ops/poisson_loss_grad.py
//                             _loss_grad_impl)
//   poisson_energy            per-warp partial sums of the Ritz energy
//                             sum_gp JxW (0.5 nu |grad u|^2 - u f) (replaces
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
// K2 and K3 take the same walk, with no staging. Their first designs
// computed an element body about nine times a node (K2: R on a 16x16 tile
// plus halo in gather form, then K(R)) or loaded each node four times (K3:
// a thread an element); on the same card they ran at 0.224 and 0.069 ms at
// 512^2 x 32. Now (PERF.md): K2 0.093 ms, ~2.2 element bodies a node, held
// by instruction issue (its byte bound is 0.040); K3 0.045 ms in float32,
// 67% of its byte bound, and 0.044 in bf16.
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
// A warp owns kK2W output node columns x0 .. x0 + 60 and ty output node rows
// y0 .. y0 + ty - 1; a block is kWarps such warps, stacked in y, that share
// nothing. Lane l holds node columns a, a + 1, a + 2 (a = x0 - 2 + 2l) of u
// and nu, loaded straight from device memory a row at a time (a warp's row
// is 64 consecutive nodes, the third column an L1 hit), and walks down the
// rows:
//   stage 1: elements a and a + 1 of element row e, once each; with the
//     bottom corners of row e - 1 carried in registers and the corner of
//     element a + 2 from lane l + 1 by shuffle they complete K(nu) u at
//     nodes P = a + 1 and Q = a + 2 of node row e, and so R there (the mask
//     and Nf applied on the fly; R never leaves registers);
//   stage 2, one row behind: the same walk over R, elements a + 1 and a + 2
//     of element row e - 1 (R at a + 3 from lane l + 1), gives 2 K(nu) R at
//     nodes a + 2 and a + 3 of node row e - 1.
// 64 element slots a stage give 63 R nodes and then 61 gradient nodes, so
// no lane computes an extra column: ~2 (ty + 3)/ty + 2 (ty + 1)/ty element
// bodies a lane for 61/32 nodes, against nine a node in gather form.
constexpr int kK2W = 61;   // output node columns of a warp's tile
constexpr int kWarps = 4;  // independent warps of a K2 or K3 block

// a field's value at (row, col) of this sample, 0 outside the grid: `row_ok`
// and `col_ok` are the two halves of the test, `p` the row's first node
__device__ __forceinline__ float ld_or0(const float* __restrict__ p, int col,
                                        bool row_ok, bool col_ok) {
  return row_ok && col_ok ? __ldg(p + col) : 0.f;
}

__global__ void __launch_bounds__(32 * kWarps)
loss_grad_kernel(const float* __restrict__ u, const float* __restrict__ nu,
                 const float* __restrict__ nf, int64_t nf_bstride,
                 const float* __restrict__ bc, int64_t bc_bstride,
                 float* __restrict__ grad, float* __restrict__ partials,
                 int nrows, int ncols, int ty, StiffConsts k) {
  const int lane = threadIdx.x;
  const int tile = blockIdx.y * kWarps + threadIdx.y;   // row tile
  const int x0 = blockIdx.x * kK2W, y0 = tile * ty;
  const int b = blockIdx.z;
  const int nel_r = nrows - 1, nel_c = ncols - 1;
  const float* __restrict__ U = u + (int64_t)b * nrows * ncols;
  const float* __restrict__ NU = nu + (int64_t)b * nrows * ncols;
  const float* __restrict__ NF = nf + (int64_t)b * nf_bstride;
  const float* __restrict__ BC = bc + (int64_t)b * bc_bstride;
  float* __restrict__ G = grad + (int64_t)b * nrows * ncols;

  const int a = x0 - 2 + 2 * lane;
  const bool c0 = a >= 0 && a < ncols, c1 = a + 1 >= 0 && a + 1 < ncols;
  const bool c2 = a + 2 >= 0 && a + 2 < ncols;
  // elements that exist: stage 1's a, a + 1; stage 2's a + 1, a + 2
  const bool e1a = a >= 0 && a < nel_c, e1b = a + 1 >= 0 && a + 1 < nel_c;
  const bool e2b = a + 2 >= 0 && a + 2 < nel_c;
  // owned nodes: R^2 at P (lanes 1-30) and Q (lanes 0-30); the gradient at
  // a + 2 (lanes 0-30) and a + 3 (lanes 0-29), inside the grid
  const bool own_p = lane >= 1 && lane <= 30, own_q = lane <= 30;
  const bool out0 = lane <= 30 && a + 2 < ncols;
  const bool out1 = lane <= 29 && a + 3 < ncols;
  const int steps = min(ty, nrows - y0) + 3;   // element rows y0 - 2 ...

  // node row r of u and nu at a, a + 1, a + 2
  auto load_un = [&](int r, float* uu, float* nn) {
    const bool ok = r >= 0 && r < nrows;
    const int o = r * ncols;
    uu[0] = ld_or0(U + o, a, ok, c0);
    uu[1] = ld_or0(U + o, a + 1, ok, c1);
    uu[2] = ld_or0(U + o, a + 2, ok, c2);
    nn[0] = ld_or0(NU + o, a, ok, c0);
    nn[1] = ld_or0(NU + o, a + 1, ok, c1);
    nn[2] = ld_or0(NU + o, a + 2, ok, c2);
  };
  // node row r of Nf and bc at P and Q
  auto load_fb = [&](int r, float* ff, float* bb) {
    const bool ok = r >= 0 && r < nrows;
    const int o = r * ncols;
    ff[0] = ld_or0(NF + o, a + 1, ok, c1);
    ff[1] = ld_or0(NF + o, a + 2, ok, c2);
    bb[0] = ld_or0(BC + o, a + 1, ok, c1);
    bb[1] = ld_or0(BC + o, a + 2, ok, c2);
  };

  float ut[3], nt[3], ub[3], nb[3], fq[2], bq[2];
  float un[3], nn[3], fn[2], bn[2];   // the next step's loads
  load_un(y0 - 2, ut, nt);
  load_un(y0 - 1, un, nn);
  load_fb(y0 - 2, fn, bn);
  // nu at a + 3 (lane l + 1's a + 1) on the stage-2 rows
  float nt3 = __shfl_down_sync(kFull, nt[1], 1);
  float np[3] = {0.f, 0.f, 0.f}, np3 = 0.f;   // nu, node row e - 1
  float carry0 = 0.f, carry1 = 0.f;           // stage 1, row e - 1's
  float rp = 0.f, rq = 0.f, rn = 0.f;         // R, row e - 1: P, Q, a + 3
  float gc0 = 0.f, gc1 = 0.f;                 // stage 2's carries
  float sq = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int e = y0 - 2 + s;   // stage 1's element row, R's node row
#pragma unroll
    for (int i = 0; i < 3; ++i) ub[i] = un[i], nb[i] = nn[i];
    fq[0] = fn[0], fq[1] = fn[1], bq[0] = bn[0], bq[1] = bn[1];
    if (s + 1 < steps) {
      load_un(e + 2, un, nn);
      load_fb(e + 1, fn, bn);
    }
    const float nb3 = __shfl_down_sync(kFull, nb[1], 1);

    // stage 1: K(nu) u at P and Q of node row e, then R
    float a0, a1, a2, a3, b0, b1, b2, b3;
    element_body(ut[0], ut[1], ub[0], ub[1], nt[0], nt[1], nb[0], nb[1], k,
                 a0, a1, a2, a3);
    element_body(ut[1], ut[2], ub[1], ub[2], nt[1], nt[2], nb[1], nb[2], k,
                 b0, b1, b2, b3);
    const bool row_ok = e >= 0 && e < nel_r;
    const bool va = row_ok && e1a, vb = row_ok && e1b;
    a0 = va ? a0 : 0.f;
    a1 = va ? a1 : 0.f;
    a2 = va ? a2 : 0.f;
    a3 = va ? a3 : 0.f;
    b0 = vb ? b0 : 0.f;
    b1 = vb ? b1 : 0.f;
    b2 = vb ? b2 : 0.f;
    b3 = vb ? b3 : 0.f;
    const float r0 = __shfl_down_sync(kFull, a0, 1);
    const float r2 = __shfl_down_sync(kFull, a2, 1);
    const float kp = (carry0 + a1) + b0, kq = (carry1 + b1) + r0;
    carry0 = a3 + b2;
    carry1 = b3 + r2;
    const float Rp = bq[0] > 0.5f ? 0.f : kp - fq[0];
    const float Rq = bq[1] > 0.5f ? 0.f : kq - fq[1];
    const float Rn = __shfl_down_sync(kFull, Rp, 1);
    if (s >= 2 && s <= ty + 1) {   // R's rows y0 .. y0 + ty - 1
      sq += own_p ? Rp * Rp : 0.f;
      sq += own_q ? Rq * Rq : 0.f;
    }

    // stage 2: element row e - 1 of K(nu) R, node row e - 1 of the
    // gradient
    if (s >= 2) {
      const int e2 = e - 1;
      float ca0, ca1, ca2, ca3, cb0, cb1, cb2, cb3;
      element_body(rp, rq, Rp, Rq, np[1], np[2], nt[1], nt[2], k, ca0, ca1,
                   ca2, ca3);
      element_body(rq, rn, Rq, Rn, np[2], np3, nt[2], nt3, k, cb0, cb1, cb2,
                   cb3);
      const bool row2 = e2 >= 0 && e2 < nel_r;
      const bool vc = row2 && e1b, vd = row2 && e2b;   // a + 1, a + 2
      ca0 = vc ? ca0 : 0.f;
      ca1 = vc ? ca1 : 0.f;
      ca2 = vc ? ca2 : 0.f;
      ca3 = vc ? ca3 : 0.f;
      cb0 = vd ? cb0 : 0.f;
      cb1 = vd ? cb1 : 0.f;
      cb2 = vd ? cb2 : 0.f;
      cb3 = vd ? cb3 : 0.f;
      const float q0 = __shfl_down_sync(kFull, ca0, 1);
      const float q2 = __shfl_down_sync(kFull, ca2, 1);
      if (s >= 3) {   // node row e2 >= y0
        float* __restrict__ g = G + (int64_t)e2 * ncols;
        if (out0) g[a + 2] = 2.f * ((gc0 + ca1) + cb0);
        if (out1) g[a + 3] = 2.f * ((gc1 + cb1) + q0);
      }
      gc0 = ca3 + cb2;
      gc1 = cb3 + q2;
    }

#pragma unroll
    for (int i = 0; i < 3; ++i) np[i] = nt[i], nt[i] = nb[i], ut[i] = ub[i];
    np3 = nt3;
    nt3 = nb3;
    rp = Rp, rq = Rq, rn = Rn;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_down_sync(kFull, sq, off);
  if (lane == 0)
    partials[((int64_t)b * gridDim.y * kWarps + tile) * gridDim.x +
             blockIdx.x] = sq;
}

// ---------------------------------------------------------------- K3 ------
// A warp owns kK3W element columns x0 .. x0 + 63 and ty element rows; a
// block is kWarps such warps stacked in y. Lane l computes elements x0 + 2l
// and x0 + 2l + 1 of each row, once each, from its nodes x0 + 2l .. + 2 of
// u, nu and f, loaded straight from device memory a row at a time (the
// third column an L1 hit), the next row's loads issued before this row's
// bodies, the row above kept in registers: each node is read (ty + 1)/ty
// times and no element is computed twice. The sum stays in a register; one
// shuffle tree a warp gives its partial.
constexpr int kK3W = 64;

// the Ritz energy of one element from its corner values of u (c..), nu
// (n..) and f (f..): the sum-factorised body of the JAX kernel
__device__ __forceinline__ float energy_body(
    float c00, float c01, float c10, float c11, float n00, float n01,
    float n10, float n11, float f00, float f01, float f10, float f11,
    const EnergyConsts& c) {
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
  return e_x + e_y - load;
}

template <class T>
__global__ void __launch_bounds__(32 * kWarps)
energy_kernel(const T* __restrict__ u, const T* __restrict__ nu,
              const T* __restrict__ f, float* __restrict__ partials,
              int nrows, int ncols, int ty, EnergyConsts c) {
  const int lane = threadIdx.x;
  const int tile = blockIdx.y * kWarps + threadIdx.y;
  const int x = blockIdx.x * kK3W + 2 * lane, y0 = tile * ty;
  const int64_t off = (int64_t)blockIdx.z * nrows * ncols;
  const T* __restrict__ U = u + off;
  const T* __restrict__ NU = nu + off;
  const T* __restrict__ F = f + off;
  const bool ok0 = x < ncols - 1, ok1 = x + 1 < ncols - 1;
  // columns clamped into the grid: a load past it feeds only an element
  // that does not exist
  const int x1 = min(x + 1, ncols - 1), x2 = min(x + 2, ncols - 1);
  const int xc = min(x, ncols - 1);
  const int rows = min(ty, nrows - 1 - y0);   // element rows of the tile

  float acc = 0.f;
  if (rows > 0) {
    auto load = [&](int r, float* uu, float* nn, float* ff) {
      const int o = r * ncols;
      uu[0] = to_f32(__ldg(U + o + xc));
      uu[1] = to_f32(__ldg(U + o + x1));
      uu[2] = to_f32(__ldg(U + o + x2));
      nn[0] = to_f32(__ldg(NU + o + xc));
      nn[1] = to_f32(__ldg(NU + o + x1));
      nn[2] = to_f32(__ldg(NU + o + x2));
      ff[0] = to_f32(__ldg(F + o + xc));
      ff[1] = to_f32(__ldg(F + o + x1));
      ff[2] = to_f32(__ldg(F + o + x2));
    };
    float ut[3], nt[3], ft[3], ub[3], nb[3], fb[3], un[3], nn[3], fn[3];
    load(y0, ut, nt, ft);
    load(y0 + 1, un, nn, fn);
    for (int s = 0; s < rows; ++s) {
#pragma unroll
      for (int i = 0; i < 3; ++i) ub[i] = un[i], nb[i] = nn[i], fb[i] = fn[i];
      if (s + 1 < rows) load(y0 + s + 2, un, nn, fn);
      const float ea = energy_body(ut[0], ut[1], ub[0], ub[1], nt[0], nt[1],
                                   nb[0], nb[1], ft[0], ft[1], fb[0], fb[1],
                                   c);
      const float eb = energy_body(ut[1], ut[2], ub[1], ub[2], nt[1], nt[2],
                                   nb[1], nb[2], ft[1], ft[2], fb[1], fb[2],
                                   c);
      acc += (ok0 ? ea : 0.f) + (ok1 ? eb : 0.f);
#pragma unroll
      for (int i = 0; i < 3; ++i) ut[i] = ub[i], nt[i] = nb[i], ft[i] = fb[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(kFull, acc, o);
  if (lane == 0)
    partials[((int64_t)blockIdx.z * gridDim.y * kWarps + tile) * gridDim.x +
             blockIdx.x] = acc;
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

const char* poisson2d_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// Number of partial sums the K2 / K3 launches write at tile height ty (one
// a warp); the wrappers allocate exactly this many.
long long poisson_resmin_loss_grad_partials(int B, int nrows, int ncols,
                                            int ty) {
  return (long long)B * cdiv(ncols, kK2W) * cdiv(cdiv(nrows, ty), kWarps) *
         kWarps;
}

long long poisson_energy_partials(int B, int nrows, int ncols, int ty) {
  return (long long)B * cdiv(ncols - 1, kK3W) *
         cdiv(cdiv(nrows - 1, ty), kWarps) * kWarps;
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

// ty: node rows (K2) or element rows (K3) of a warp's tile, 1 to 64 (the
// wrappers pick it from the grid). A sample's nodes must fit in 31 bits.
// Anything else is refused with cudaErrorInvalidValue.
int poisson_resmin_loss_grad(const float* u, const float* nu, const float* nf,
                             long long nf_bstride, const float* bc,
                             long long bc_bstride, float* grad,
                             float* partials, int B, int nrows, int ncols,
                             int ty, float k1x, float k2x, float k1y,
                             float k2y, void* stream) {
  if (ty < 1 || ty > 64 || (int64_t)nrows * ncols > INT32_MAX - 64)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(ncols, kK2W), cdiv(cdiv(nrows, ty), kWarps), B);
  loss_grad_kernel<<<grid, dim3(32, kWarps), 0, (cudaStream_t)stream>>>(
      u, nu, nf, (int64_t)nf_bstride, bc, (int64_t)bc_bstride, grad,
      partials, nrows, ncols, ty, StiffConsts{k1x, k2x, k1y, k2y});
  return (int)cudaGetLastError();
}

// bf16: 1 for bfloat16 fields, 0 for float32; the partials are float32.
int poisson_energy(const void* u, const void* nu, const void* f,
                   float* partials, int B, int nrows, int ncols, int ty,
                   int bf16, float c1x, float c2x, float c3x, float c1y,
                   float c2y, float c3y, float cm, void* stream) {
  if (ty < 1 || ty > 64 || (int64_t)nrows * ncols > INT32_MAX - 64)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(ncols - 1, kK3W), cdiv(cdiv(nrows - 1, ty), kWarps),
                  B);
  const dim3 block(32, kWarps);
  const EnergyConsts c{c1x, c2x, c3x, c1y, c2y, c3y, cm};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    energy_kernel<T><<<grid, block, 0, s>>>((const T*)u, (const T*)nu,
                                            (const T*)f, partials, nrows,
                                            ncols, ty, c);
  } else {
    energy_kernel<float><<<grid, block, 0, s>>>(
        (const float*)u, (const float*)nu, (const float*)f, partials, nrows,
        ncols, ty, c);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
