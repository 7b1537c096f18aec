// Deg-1 (bilinear, 2x2 Gauss) fused VMS Navier-Stokes residual (K6) for
// Hopper (sm_90a).
//
//   ns_vms_residual  (R1, R2, R3) = the assembled VMS residuals of nodal
//                    u, v, p with optional nodal forcing fx, fy (replaces
//                    diffnet_tpu/ops/ns_residual.py _ns_fwd_impl /
//                    _ns_fwd_bs, body _strip_accs)
//
// Fields are row-major [B, n, n] float32 (x fastest); the outputs are not
// masked (Dirichlet rows are the caller's concern).
//
// What bounds it: at 8 x 512^2 the bytes and the operations nearly tie. It
// moves u, v, p in and R1-R3 out, 24 B a node (50.3 MB, 15.0 us at 3.35
// TB/s), against the element body below, 532 fp32 operations an element
// counting an FMA as two (3 x 44 for the Gauss-point values, 4 x 70 for
// the Gauss points, 3 x 40 for the projection tails) and 9 adds a node to
// assemble (1.11 GFLOP, 16.6 us at 67 TFLOP/s). So the design reads each
// field once and computes each element once: a block owns 32 x 8
// elements, one a thread, and the 31 x 7
// output nodes whose four elements all lie among them; it stages u, v, p
// (and f) on the elements' 33 x 9 nodes in shared memory, computes each
// element's 4 corner values of the 3 residuals into shared memory
// (residual- and corner-major: conflict-free rows), and each of the
// block's output nodes sums its four corners of each residual (1.18
// elements an output node, against the 4 of a gather form). No atomics,
// and the same result on every run. The TPU kernel's strips, VMEM scratch
// and DMA semaphores are not carried over.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success); the Python
// wrapper raises on any other value. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cN[g][a]: the 1D shape value of local node a at Gauss point g. ihx, ihy:
// 1/h. W: the equal JxW of the four Gauss points; wx, wy: W/hx, W/hy. gxx,
// gyy: the element metric 4/h^2; diff: 36 visco^2 (gxx^2 + gyy^2); isum_g:
// 1 / (gxx + gyy).
struct NSConsts {
  float c00, c01, c10, c11, ihx, ihy, w, wx, wy, visco, gxx, gyy, diff,
      isum_g;
};

constexpr int kEX = 32, kEY = 8;             // elements of a block
constexpr int kTX = kEX - 1, kTY = kEY - 1;  // output nodes (31 x 7)
constexpr int kNX = kEX + 1, kNY = kEY + 1;  // staged nodes (33 x 9)
constexpr int kThreads = kEX * kEY;
constexpr int kNodes = kNX * kNY;

// Gauss-point values of one field from its corners c[jb * 2 + ib] (y, x):
// N[gx][gy]; d/dx takes one value per y Gauss index (dx[gy]) and d/dy one
// per x index (dy[gx]); N reuses the 1D x-interpolations. 44 operations
// (FMA as two): 24 for N, 20 for the derivatives.
__device__ __forceinline__ void gauss_values(const float c[4],
                                             const float cN[2][2],
                                             const NSConsts& k,
                                             float N[2][2], float dx[2],
                                             float dy[2]) {
#pragma unroll
  for (int gx = 0; gx < 2; ++gx) {
    const float t0 = fmaf(cN[gx][0], c[0], cN[gx][1] * c[1]);
    const float t1 = fmaf(cN[gx][0], c[2], cN[gx][1] * c[3]);
#pragma unroll
    for (int gy = 0; gy < 2; ++gy)
      N[gx][gy] = fmaf(cN[gy][0], t0, cN[gy][1] * t1);
  }
  if (dx == nullptr) return;
  const float dxl = (c[1] - c[0]) * k.ihx, dxh = (c[3] - c[2]) * k.ihx;
  const float dyl = (c[2] - c[0]) * k.ihy, dyh = (c[3] - c[1]) * k.ihy;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    dx[g] = fmaf(cN[g][0], dxl, cN[g][1] * dxh);
    dy[g] = fmaf(cN[g][0], dyl, cN[g][1] * dyh);
  }
}

// The element's 4 corner values (jb * 2 + ib) of each residual, a[r][c].
template <bool kHasF>
__device__ __forceinline__ void element_body(const float uc[4],
                                             const float vc[4],
                                             const float pc[4],
                                             const float f1c[4],
                                             const float f2c[4],
                                             const NSConsts& k,
                                             float a[3][4]) {
  const float cN[2][2] = {{k.c00, k.c01}, {k.c10, k.c11}};
  float uN[2][2], ux[2], uy[2], vN[2][2], vx[2], vy[2], pN[2][2], px[2],
      py[2], f1N[2][2], f2N[2][2];
  gauss_values(uc, cN, k, uN, ux, uy);
  gauss_values(vc, cN, k, vN, vx, vy);
  gauss_values(pc, cN, k, pN, px, py);
  if (kHasF) {
    gauss_values(f1c, cN, k, f1N, nullptr, nullptr);
    gauss_values(f2c, cN, k, f2N, nullptr, nullptr);
  }

  // projection partials of each residual r: A[r][gy][ib] (N part summed
  // over gx), X[r][gy] (dx part summed over gx), Y[r][gx] (dy part summed
  // over gy)
  float A[3][2][2] = {}, X[3][2] = {}, Y[3][2] = {};
#pragma unroll
  for (int gx = 0; gx < 2; ++gx)
#pragma unroll
    for (int gy = 0; gy < 2; ++gy) {
      const float u = uN[gx][gy], v = vN[gx][gy], p = pN[gx][gy];
      const float dudx = ux[gy], dvdx = vx[gy], dpdx = px[gy];
      const float dudy = uy[gx], dvdy = vy[gx], dpdy = py[gx];
      const float div = dudx + dvdy;
      float adv1 = fmaf(u, dudx, v * dudy);
      float adv2 = fmaf(u, dvdx, v * dvdy);
      if (kHasF) {   // adv - f: what the N parts and the residuals take
        adv1 -= f1N[gx][gy];
        adv2 -= f2N[gx][gy];
      }
      const float res1 = adv1 + dpdx;
      const float res2 = adv2 + dpdy;
      // tau_m = 1/sqrt(s2), tau_c = sqrt(s2)/(gxx + gyy); the advective
      // field is detached by construction (no derivative is taken here)
      const float s2 = fmaf(k.gxx * u, u, fmaf(k.gyy * v, v, k.diff));
      const float taum = rsqrtf(s2);
      const float tauc = s2 * taum * k.isum_g;
      const float tm1 = taum * res1, tm2 = taum * res2;
      const float t12 = tm1 * tm2;
      const float tcd = tauc * div;
      const float i1 = fmaf(-tm2, dudy, fmaf(-tm1, dudx, adv1));
      const float i2 = fmaf(-tm2, dvdy, fmaf(-tm1, dvdx, adv2));
#pragma unroll
      for (int ib = 0; ib < 2; ++ib) {
        const float c = cN[gx][ib];
        A[0][gy][ib] = fmaf(c, i1, A[0][gy][ib]);
        A[1][gy][ib] = fmaf(c, i2, A[1][gy][ib]);
        A[2][gy][ib] = fmaf(c, div, A[2][gy][ib]);
      }
      X[0][gy] += fmaf(k.visco, dudx, -p) + fmaf(u, tm1, -tm1 * tm1) + tcd;
      X[1][gy] += fmaf(k.visco, dvdx, fmaf(u, tm2, -t12));
      X[2][gy] += tm1;
      Y[0][gx] += fmaf(k.visco, dudy, fmaf(v, tm1, -t12));
      Y[1][gx] += fmaf(k.visco, dvdy, -p) + fmaf(v, tm2, -tm2 * tm2) + tcd;
      Y[2][gx] += tm2;
    }

  // projection tail: the N part through the second 1D Gauss pass, the
  // dx / dy parts with the -+1/h sign of the test corner
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float Cj[2], Di[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Cj[j] = k.wx * fmaf(cN[0][j], X[r][0], cN[1][j] * X[r][1]);
      Di[j] = k.wy * fmaf(cN[0][j], Y[r][0], cN[1][j] * Y[r][1]);
    }
#pragma unroll
    for (int jb = 0; jb < 2; ++jb)
#pragma unroll
      for (int ib = 0; ib < 2; ++ib) {
        const float n =
            k.w * fmaf(cN[0][jb], A[r][0][ib], cN[1][jb] * A[r][1][ib]);
        const float x = ib ? Cj[jb] : -Cj[jb];
        const float y = jb ? Di[ib] : -Di[ib];
        a[r][jb * 2 + ib] = n + x + y;
      }
  }
}

template <bool kHasF>
__global__ void __launch_bounds__(kThreads)
ns_vms_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ p, const float* __restrict__ fx,
              const float* __restrict__ fy, float* __restrict__ r1,
              float* __restrict__ r2, float* __restrict__ r3, int ny, int nx,
              int tiles_y, NSConsts k) {
  __shared__ float sf[kHasF ? 5 : 3][kNodes];
  __shared__ float sa[12][kThreads];   // residual- and corner-major

  const int b = blockIdx.y / tiles_y;
  const int x0 = blockIdx.x * kTX, y0 = (blockIdx.y % tiles_y) * kTY;
  const int tid = threadIdx.y * kEX + threadIdx.x;
  const int64_t off = (int64_t)b * ny * nx;

  // 1. the fields on nodes [y0 - 1, y0 + kTY] x [x0 - 1, x0 + kTX];
  //    outside the domain 0 (only elements that are masked out read them)
  for (int t = tid; t < kNodes; t += kThreads) {
    const int x = x0 - 1 + t % kNX, y = y0 - 1 + t / kNX;
    const bool in = x >= 0 && x < nx && y >= 0 && y < ny;
    const int64_t g = off + (int64_t)y * nx + x;
    sf[0][t] = in ? __ldg(u + g) : 0.f;
    sf[1][t] = in ? __ldg(v + g) : 0.f;
    sf[2][t] = in ? __ldg(p + g) : 0.f;
    if (kHasF) {
      sf[kHasF ? 3 : 0][t] = in ? __ldg(fx + g) : 0.f;
      sf[kHasF ? 4 : 0][t] = in ? __ldg(fy + g) : 0.f;
    }
  }
  __syncthreads();

  // 2. this thread's element (y0 - 1 + ty, x0 - 1 + tx); one outside the
  //    domain contributes 0
  {
    const int ex = threadIdx.x, ey = threadIdx.y;
    const int gx = x0 - 1 + ex, gy = y0 - 1 + ey;
    float a[3][4];
    if (gx >= 0 && gx < nx - 1 && gy >= 0 && gy < ny - 1) {
      float c[5][4];
#pragma unroll
      for (int f = 0; f < (kHasF ? 5 : 3); ++f)
#pragma unroll
        for (int jb = 0; jb < 2; ++jb)
#pragma unroll
          for (int ib = 0; ib < 2; ++ib)
            c[f][jb * 2 + ib] = sf[f][(ey + jb) * kNX + ex + ib];
      element_body<kHasF>(c[0], c[1], c[2], c[3], c[4], k, a);
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) a[r][m] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) sa[r * 4 + m][tid] = a[r][m];
  }
  __syncthreads();

  // 3. node (y, x) is corner (jb, ib) of element (y - jb, x - ib), local
  //    element (ly + 1 - jb, lx + 1 - ib)
  const int lx = threadIdx.x, ly = threadIdx.y;
  if (lx >= kTX || ly >= kTY) return;
  const int x = x0 + lx, y = y0 + ly;
  if (x >= nx || y >= ny) return;
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int jb = 0; jb < 2; ++jb)
#pragma unroll
    for (int ib = 0; ib < 2; ++ib) {
      const int e = (ly + 1 - jb) * kEX + lx + 1 - ib;
#pragma unroll
      for (int r = 0; r < 3; ++r) acc[r] += sa[r * 4 + jb * 2 + ib][e];
    }
  const int64_t g = off + (int64_t)y * nx + x;
  r1[g] = acc[0];
  r2[g] = acc[1];
  r3[g] = acc[2];
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

int ns_vms_residual(const float* u, const float* v, const float* p,
                    const float* fx, const float* fy, float* r1, float* r2,
                    float* r3, int B, int ny, int nx, int has_f, float c00,
                    float c01, float c10, float c11, float ihx, float ihy,
                    float w, float wx, float wy, float visco, float gxx,
                    float gyy, float diff, float isum_g, void* stream) {
  const int tiles_y = (int)cdiv(ny, kTY);
  const dim3 grid(cdiv(nx, kTX), (unsigned)(B * tiles_y));
  const dim3 block(kEX, kEY);
  const NSConsts k{c00, c01, c10, c11, ihx,  ihy,  w,
                   wx,  wy,  visco, gxx, gyy, diff, isum_g};
  cudaStream_t s = (cudaStream_t)stream;
  if (has_f)
    ns_vms_kernel<true><<<grid, block, 0, s>>>(u, v, p, fx, fy, r1, r2, r3,
                                                ny, nx, tiles_y, k);
  else
    ns_vms_kernel<false><<<grid, block, 0, s>>>(u, v, p, fx, fy, r1, r2, r3,
                                                 ny, nx, tiles_y, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
