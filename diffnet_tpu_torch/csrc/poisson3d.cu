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
// against about 280 fp32 operations an element in the JAX package's
// sum-factorised body and 7 a node to assemble (at 4 x 64^3: 12.6 MB, 3.8
// us at 3.35 TB/s, against 0.29 GFLOP, 4.3 us at 67 TFLOP/s).
//
// The first design (a block per 16 x 8 x 4 node tile, u and nu staged in
// shared memory, 17 x 9 x 5 elements computed by 512 threads, their eight
// corner contributions kept in shared memory and summed by node) ran at 13%
// of that bound on an H100 (PERF.md): 1.5 element bodies a node in two
// passes, ~50 shared-memory instructions a node, and three serial phases
// around two barriers. This design walks instead (K6's, csrc/ns2d.cu, in
// 3D):
//   * A block is kWarps warps stacked in y over 32 element columns. Lane l
//     owns element column ex = x0 + l and node column ex; warp w owns
//     element row ey = y0 - 1 + w and, for w >= 1, node row ey. The block
//     walks a strip of tz node planes in z, one element plane a step, from
//     the plane below the strip.
//   * Per step a lane loads the next node plane's u and nu at its element's
//     four (y, x) corners straight into registers (the loads for the step
//     after are issued before the body), computes its element once, and
//     assembles node (ez, ey, ex): the z-neighbour's part is carried from
//     the step before in registers, the x-neighbour's comes from lane l - 1
//     by __shfl_up_sync, the y-neighbour's from warp w - 1 through one
//     shared array and the step's one barrier (double-buffered). So inside
//     a block no element is computed twice; warp 0's element row (1 in
//     kWarps), the strip's first element plane (1 in tz + 1) and the
//     element column left of the tile (computed before the walk, one step
//     a lane, and read by lane 0 from shared memory) are computed by their
//     neighbours too. The node column right of the tile's last element,
//     where that is the grid's last (nx - 1 = x0 + 32), is lane 31's second
//     node. No atomics: the same result on every run.
//   * The element body is the sum-factorised algebra in the sum/difference
//     basis of the Gauss pair (p + q = 1, G = (p - q)^2): the corner values
//     of u and nu go through an unnormalised 2x2x2 Hadamard transform (its
//     x and y stages once a node plane, carried to the next step), each
//     axis' derivative-times-nu product at the four Gauss points of the
//     other two axes becomes a 16-term product of the transformed
//     coefficients, and the eight corner contributions come back through
//     the inverse transform, its z stage summed across the two steps that
//     share a node plane before its x and y stages. ~140 fp32 instructions
//     a body in the SASS, against 208 in the first. The float64 transcription
//     of this body is held to the plain version in
//     tests/test_torch_poisson3d.py.
//   * The strip length tz is the wrapper's choice, from the grid
//     (ops/poisson_residual_3d.py::strip_planes), at most 31 (the left
//     column's steps are one a lane).
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success); the Python
// wrapper raises on any other value. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps of a block, stacked in y
constexpr int kMaxStrip = 31;
constexpr unsigned kFull = 0xffffffffu;

// G = (p - q)^2 with (p, q) the 1D shape values at the first Gauss point;
// w<axis>[m] = W / (16 h_axis^2) G^m (W the equal JxW of the 2x2x2 Gauss
// points).
struct K5Consts {
  float g, wx[3], wy[3], wz[3];
};

// The x and y stages of the transform of one node plane's corner values
// v[j][i] (y, x): t[sy][sx], 0 the sum and 1 the difference (v1 - v0).
__device__ __forceinline__ void xy_stage(const float v[2][2], float t[2][2]) {
  const float s0 = v[0][0] + v[0][1], d0 = v[0][1] - v[0][0];
  const float s1 = v[1][0] + v[1][1], d1 = v[1][1] - v[1][0];
  t[0][0] = s0 + s1;
  t[1][0] = s1 - s0;
  t[0][1] = d0 + d1;
  t[1][1] = d1 - d0;
}

// One axis' product: T[a][b] over the two other axes' sum/difference
// indices, from the derivative's coefficients U and nu's N (ng: N[0][1],
// N[1][0], N[1][1] times G; ngg: N[1][1] times G^2).
__device__ __forceinline__ void axis_product(const float U[2][2],
                                             const float N[2][2],
                                             float ng01, float ng10,
                                             float ng11, float ngg11,
                                             float T[2][2]) {
  T[0][0] = fmaf(U[1][1], ngg11, fmaf(U[1][0], ng10,
                 fmaf(U[0][1], ng01, U[0][0] * N[0][0])));
  T[0][1] = fmaf(U[1][1], ng10, fmaf(U[1][0], ng11,
                 fmaf(U[0][1], N[0][0], U[0][0] * N[0][1])));
  T[1][0] = fmaf(U[1][1], ng01, fmaf(U[0][1], ng11,
                 fmaf(U[1][0], N[0][0], U[0][0] * N[1][0])));
  T[1][1] = fmaf(U[1][0], N[0][1], fmaf(U[0][1], N[1][0],
                 fmaf(U[1][1], N[0][0], U[0][0] * N[1][1])));
}

// One element from the x/y-transformed node planes below (lo) and above
// (hi) it: P0, P1, its corner contributions on its lower and upper node
// plane, still in the x/y sum/difference basis.
__device__ __forceinline__ void element_body(const float ulo[2][2],
                                             const float uhi[2][2],
                                             const float nlo[2][2],
                                             const float nhi[2][2],
                                             const K5Consts& k,
                                             float P0[2][2], float P1[2][2]) {
  float u[2][2][2], n[2][2][2];   // [sz][sy][sx]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      u[0][j][i] = ulo[j][i] + uhi[j][i];
      u[1][j][i] = uhi[j][i] - ulo[j][i];
      n[0][j][i] = nlo[j][i] + nhi[j][i];
      n[1][j][i] = nhi[j][i] - nlo[j][i];
    }
  const float g = k.g;
  const float g010 = g * n[0][1][0], g100 = g * n[1][0][0],
              g001 = g * n[0][0][1];
  const float g110 = g * n[1][1][0], g101 = g * n[1][0][1],
              g011 = g * n[0][1][1];
  const float gg110 = g * g110, gg101 = g * g101, gg011 = g * g011;
  float Tx[2][2], Ty[2][2], Tz[2][2];
  {  // x: U[a][b] = u[a][b][1], N[a][b] = n[a][b][0] (a = z, b = y)
    const float U[2][2] = {{u[0][0][1], u[0][1][1]}, {u[1][0][1], u[1][1][1]}};
    const float N[2][2] = {{n[0][0][0], n[0][1][0]}, {n[1][0][0], n[1][1][0]}};
    axis_product(U, N, g010, g100, g110, gg110, Tx);
  }
  {  // y: U[a][b] = u[a][1][b], N[a][b] = n[a][0][b] (a = z, b = x)
    const float U[2][2] = {{u[0][1][0], u[0][1][1]}, {u[1][1][0], u[1][1][1]}};
    const float N[2][2] = {{n[0][0][0], n[0][0][1]}, {n[1][0][0], n[1][0][1]}};
    axis_product(U, N, g001, g100, g101, gg101, Ty);
  }
  {  // z: U[a][b] = u[1][a][b], N[a][b] = n[0][a][b] (a = y, b = x)
    const float U[2][2] = {{u[1][0][0], u[1][0][1]}, {u[1][1][0], u[1][1][1]}};
    const float N[2][2] = {{n[0][0][0], n[0][0][1]}, {n[0][1][0], n[0][1][1]}};
    axis_product(U, N, g001, g010, g011, gg011, Tz);
  }
  // the corner contributions' transform c[sz][sy][sx] (c[0][0][0] = 0)
  const float c001 = k.wx[0] * Tx[0][0];
  const float c010 = k.wy[0] * Ty[0][0];
  const float c100 = k.wz[0] * Tz[0][0];
  const float c011 = fmaf(k.wy[1], Ty[0][1], k.wx[1] * Tx[0][1]);
  const float c101 = fmaf(k.wz[1], Tz[0][1], k.wx[1] * Tx[1][0]);
  const float c110 = fmaf(k.wz[1], Tz[1][0], k.wy[1] * Ty[1][0]);
  const float c111 =
      fmaf(k.wz[2], Tz[1][1], fmaf(k.wy[2], Ty[1][1], k.wx[2] * Tx[1][1]));
  // inverse z stage: lower plane c_s - c_d, upper c_s + c_d
  P0[0][0] = -c100;
  P1[0][0] = c100;
  P0[0][1] = c001 - c101;
  P1[0][1] = c001 + c101;
  P0[1][0] = c010 - c110;
  P1[1][0] = c010 + c110;
  P0[1][1] = c011 - c111;
  P1[1][1] = c011 + c111;
}

// Inverse x and y stages: a node plane's corner values a[j][i] from Q.
__device__ __forceinline__ void xy_inverse(const float Q[2][2],
                                           float a[2][2]) {
  const float r00 = Q[0][0] - Q[0][1], r01 = Q[0][0] + Q[0][1];
  const float r10 = Q[1][0] - Q[1][1], r11 = Q[1][0] + Q[1][1];
  a[0][0] = r00 - r10;
  a[1][0] = r00 + r10;
  a[0][1] = r01 - r11;
  a[1][1] = r01 + r11;
}

// u and nu on node plane z at rows (y, y + 1) and columns (x, x + 1),
// transformed in x and y; zeros where `ok` is false.
__device__ __forceinline__ void load_plane(const float* __restrict__ u,
                                           const float* __restrict__ nu,
                                           int64_t at, int nx, bool ok,
                                           float tu[2][2], float tn[2][2]) {
  float vu[2][2] = {}, vn[2][2] = {};
  if (ok) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        vu[j][i] = __ldg(u + at + j * nx + i);
        vn[j][i] = __ldg(nu + at + j * nx + i);
      }
  }
  xy_stage(vu, tu);
  xy_stage(vn, tn);
}

__global__ void __launch_bounds__(32 * kWarps)
stiffness3d_kernel(const float* __restrict__ u, const float* __restrict__ nu,
                   float* __restrict__ out, int nz, int ny, int nx, int tz,
                   int strips, K5Consts k) {
  // hand[buf][w][l]: node row ey + 1's part from warp w (slot 32: the last
  // node column's); left[w][t]: the left column's part at step t (rows ey,
  // ey + 1)
  __shared__ float hand[2][kWarps][33];
  __shared__ float2 left[kWarps][32];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.z / strips;
  const int z0 = (blockIdx.z - b * strips) * tz;
  const int T = min(tz, nz - z0);   // node planes z0 .. z0 + T - 1
  const int x0 = blockIdx.x * 32, ex = x0 + lane;
  const int ey = (int)blockIdx.y * (kWarps - 1) - 1 + w;
  const int64_t plane = (int64_t)ny * nx;
  const float* __restrict__ ub = u + (int64_t)b * nz * plane;
  const float* __restrict__ nub = nu + (int64_t)b * nz * plane;
  const bool row_ok = ey >= 0 && ey < ny - 1;
  const bool edge = x0 + 32 == nx - 1;   // lane 31 also writes node nx - 1

  // 1. the left column's element (ez, ey, x0 - 1), ez = z0 - 1 + t, for
  //    step t = lane: its part of node (ez, ey + j, x0)
  if (x0 > 0) {
    const int ez = z0 - 1 + lane;
    const bool ok = row_ok && ez >= 0 && ez < nz - 1 && lane <= T;
    const int64_t at = (int64_t)(ok ? ez : 0) * plane +
                       (int64_t)(ok ? ey : 0) * nx + x0 - 1;
    float ulo[2][2], nlo[2][2], uhi[2][2], nhi[2][2], P0[2][2], P1[2][2],
        Q[2][2], a[2][2];
    load_plane(ub, nub, at, nx, ok, ulo, nlo);
    load_plane(ub, nub, at + plane, nx, ok, uhi, nhi);
    element_body(ulo, uhi, nlo, nhi, k, P0, P1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        Q[j][i] = P0[j][i] + __shfl_up_sync(kFull, P1[j][i], 1);
    xy_inverse(Q, a);
    left[w][lane] = make_float2(a[0][1], a[1][1]);
  } else {
    left[w][lane] = make_float2(0.f, 0.f);
  }
  __syncwarp();

  // 2. the walk: step t computes element plane ez = z0 - 1 + t and, for
  //    t >= 1, writes node plane ez
  const bool col_ok = row_ok && ex < nx - 1;
  const int64_t col = (int64_t)(row_ok ? ey : 0) * nx + (col_ok ? ex : 0);
  float ulo[2][2], nlo[2][2], uhi[2][2], nhi[2][2], unx[2][2], nnx[2][2];
  float C[2][2] = {};   // upper-plane part carried from the step before
  load_plane(ub, nub, (int64_t)(z0 - 1) * plane + col, nx,
             col_ok && z0 >= 1, ulo, nlo);
  load_plane(ub, nub, (int64_t)z0 * plane + col, nx, col_ok, unx, nnx);
  const int64_t out_row = (int64_t)b * nz * plane + (int64_t)ey * nx;
  const bool out_ok = w >= 1 && ey < ny;
  for (int t = 0; t <= T; ++t) {
    const int ez = z0 - 1 + t;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uhi[j][i] = unx[j][i];
        nhi[j][i] = nnx[j][i];
      }
    if (t < T)   // the next step's plane, loaded ahead of this body
      load_plane(ub, nub, (int64_t)(ez + 2) * plane + col, nx,
                 col_ok && ez + 2 < nz, unx, nnx);
    float P0[2][2] = {}, P1[2][2] = {};
    if (ez >= 0 && ez < nz - 1) element_body(ulo, uhi, nlo, nhi, k, P0, P1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ulo[j][i] = uhi[j][i];
        nlo[j][i] = nhi[j][i];
      }
    if (t >= 1) {
      float Q[2][2], a[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) Q[j][i] = C[j][i] + P0[j][i];
      xy_inverse(Q, a);
      // node (ez, ey + j, ex): own corner i = 0 and the left element's i = 1
      const float2 lf = left[w][t];
      float l0 = __shfl_up_sync(kFull, a[0][1], 1);
      float l1 = __shfl_up_sync(kFull, a[1][1], 1);
      if (lane == 0) {
        l0 = lf.x;
        l1 = lf.y;
      }
      const int buf = t & 1;
      hand[buf][w][lane] = a[1][0] + l1;
      if (edge && lane == 31) hand[buf][w][32] = a[1][1];
      __syncthreads();
      if (out_ok) {
        float* o = out + out_row + (int64_t)ez * plane;
        if (ex < nx) o[ex] = a[0][0] + l0 + hand[buf][w - 1][lane];
        if (edge && lane == 31) o[nx - 1] = a[0][1] + hand[buf][w - 1][32];
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) C[j][i] = P1[j][i];
  }
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

int poisson_stiffness_action_3d(const float* u, const float* nu, float* out,
                                int B, int nz, int ny, int nx, int tz,
                                float c00, float c01, float c10, float c11,
                                float wx2, float wy2, float wz2,
                                void* stream) {
  (void)c10;
  (void)c11;   // the Gauss pair is symmetric: c10 = c01, c11 = c00
  if (tz < 1 || tz > kMaxStrip) return (int)cudaErrorInvalidValue;
  const float g = (c00 - c01) * (c00 - c01);
  K5Consts k;
  k.g = g;
  const float ws[3] = {wx2 / 16.f, wy2 / 16.f, wz2 / 16.f};
  float* dst[3] = {k.wx, k.wy, k.wz};
  for (int a = 0; a < 3; ++a) {
    dst[a][0] = ws[a];
    dst[a][1] = ws[a] * g;
    dst[a][2] = ws[a] * g * g;
  }
  const int strips = (int)cdiv(nz, tz);
  const dim3 grid(cdiv(nx - 1, 32), cdiv(ny, kWarps - 1),
                  (unsigned)(B * strips));
  stiffness3d_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      u, nu, out, nz, ny, nx, tz, strips, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
