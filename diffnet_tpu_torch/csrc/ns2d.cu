// Deg-1 (bilinear, 2x2 Gauss) fused VMS Navier-Stokes residual (K6) for
// Hopper (sm_90a).
//
//   ns_vms_residual  (R1, R2, R3) = the assembled VMS residuals of nodal
//                    u, v, p with optional nodal forcing fx, fy (replaces
//                    diffnet_tpu/ops/ns_residual.py _ns_fwd_impl /
//                    _ns_fwd_bs, body _strip_accs)
//
// Fields are row-major [B, ny, nx] float32 (x fastest); the outputs are not
// masked (Dirichlet rows are the caller's concern). The global op takes
// square fields (as JAX's does); the split route hands the kernel a halo'd
// row block of a square grid, [B, ny_loc + 1 or 2, nx], with the global
// grid's spacing: nothing in the body depends on ny == nx.
//
// What bounds it: instruction issue. At 8 x 512^2 it moves u, v, p in and
// R1-R3 out, 24 B a node (50.3 MB, 15.0 us at 3.35 TB/s), against the
// algorithm's 532 fp32 operations an element counting an FMA as two and 9
// adds a node (1.11 GFLOP, 16.6 us at 67 TFLOP/s): the two floors nearly
// tie, and the fp32 floor needs all-FMA code, which this body is not (its
// adds and multiplies take an issue slot each). The first design (a block
// of 32 x 8 elements staged in shared memory, 31 x 7 output nodes, the 12
// corner values of each element through shared memory, two barriers) ran
// at 0.0662 ms, 25% of that floor, on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md): 1.18 element bodies an output node, 39 of 256 threads idle in
// the assembly, and the shared round trip and barriers on the issue path.
//
// This design spends the issue slots on the element body and little else
// (0.036 ms at 8 x 512^2, 0.0113 at 8 x 256^2, 0.0029 at 1 x 129^2 on
// the same card; PERF.md):
//   * A block is four warps stacked in y. Lane l owns node column x0 + l
//     and computes the column of elements ex = x0 - 1 + l, walking down a
//     strip of ty element rows; the block's strips run from element row
//     y0 - 1, one after the other. The bottom-corner sums of the element
//     row above are carried down the column in registers; the
//     x-neighbour's left corners come from lane l + 1 by __shfl_down_sync.
//     Lane 31 only feeds lane 30, so a warp writes 31 node columns. The
//     bottom sums of a strip's last row reach the next warp's first node
//     row through one 384-B shared array and the block's one barrier. So
//     inside a block no element is computed twice; the element column
//     shared with the next block in x (1/32 of the work) and the element
//     row shared with the block above (1/(4 ty)) are computed in both. No
//     atomics: the same result on every run.
//   * Node rows are read with coalesced loads straight into registers (each
//     lane its element's two columns, the second an L1 hit), the next row's
//     loads issued before the current row's body.
//   * The strip length ty is the wrapper's choice, from the grid
//     (ops/ns_residual.py::strip_rows): 7 rows where the grid fills the
//     card, down to one element row a warp on a 129^2 grid, where a longer
//     strip would lengthen each warp's dependent chain on a card that has
//     too few elements to fill it.
//   * The body is the JAX package's sum-factorised algebra with each
//     symmetric Gauss pair (p + q = 1) folded into sum/difference form: the
//     Gauss-point values of a field, and the projection of the integrands
//     back to the corners, are one 2D butterfly each (4 + 2 adds) plus a
//     few FMAs, where the direct form took 32 and ~30 instructions. tau's
//     rsqrt is MUFU.RSQ without rsqrtf's rescaling of denormal arguments,
//     which s2 >= 36 visco^2 (gxx^2 + gyy^2) > 0 never is. The walk,
//     unrolled by two, compiles to ~370 instructions an element, ~285 of
//     them fp32. The float64 transcription of this body is held to the
//     plain version in tests/test_torch_flow.py.
//   * Tensor cores have no part here: the linear parts (Gauss-point values
//     and the projection) are products of depth 4 an element, below the
//     depth of 8 that a tf32 wgmma takes, tf32 would break the 2e-5
//     tolerance, and the rest (tau, the cross and Reynolds-stress terms) is
//     nonlinear.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream and returns cudaGetLastError() (0 = success); the Python
// wrapper raises on any other value. Nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// h = (p - q) / 2 with (p, q) the 1D shape values at the first Gauss point
// (p + q = 1), h2 = h^2; nkx = -1/(2 hx), kxh = h/hx (and y); visco; gxx,
// gyy: the element metric 4/h^2; diff: 36 visco^2 (gxx^2 + gyy^2); isum_g:
// 1 / (gxx + gyy); with W the equal JxW of the Gauss points: wq = W/4,
// wh = W h, wh2 = W h^2, ax = W/(2 hx), ay = W/(2 hy), bx = W h/hx,
// by = W h/hy.
struct NSConsts {
  float h, h2, nkx, kxh, nky, kyh, visco, gxx, gyy, diff, isum_g, wq, wh,
      wh2, ax, ay, bx, by;
};

constexpr int kCols = 31;   // node columns a warp writes
constexpr int kWarps = 4;   // warps of a block, stacked in y
constexpr unsigned kFull = 0xffffffffu;

// rsqrtf of a normal number: the same MUFU.RSQ, without the guard that
// rescales denormal arguments (tau's s2 >= 36 visco^2 (gxx^2 + gyy^2) > 0).
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Gauss-point values N[gx][gy] of a field from its corners c[jb * 2 + ib]
// (y, x): with cN[g][a] = 1/2 + h s_g s_a (s = +1, -1), the bilinear
// interpolation is one butterfly of the corners. 13 instructions.
__device__ __forceinline__ void gauss_n(const float c[4], const NSConsts& k,
                                        float N[2][2], float& g1, float& g2,
                                        float& hab) {
  const float e = c[0] + c[3], f = c[1] + c[2];
  g1 = c[0] - c[3];
  g2 = c[1] - c[2];
  hab = e - f;
  const float q = 0.25f * (e + f);
  const float mp = fmaf(k.h2, hab, q), mm = fmaf(-k.h2, hab, q);
  N[0][0] = fmaf(k.h, g1, mp);
  N[1][1] = fmaf(-k.h, g1, mp);
  N[0][1] = fmaf(-k.h, g2, mm);
  N[1][0] = fmaf(k.h, g2, mm);
}

// ... and the derivatives: d/dx takes one value per y Gauss index (dx[gy]),
// d/dy one per x index (dy[gx]). 8 more instructions.
__device__ __forceinline__ void gauss_values(const float c[4],
                                             const NSConsts& k,
                                             float N[2][2], float dx[2],
                                             float dy[2]) {
  float g1, g2, hab;
  gauss_n(c, k, N, g1, g2, hab);
  const float tx = k.nkx * (g1 - g2), ty = k.nky * (g1 + g2);
  dx[0] = fmaf(-k.kxh, hab, tx);
  dx[1] = fmaf(k.kxh, hab, tx);
  dy[0] = fmaf(-k.kyh, hab, ty);
  dy[1] = fmaf(k.kyh, hab, ty);
}

// The element's 4 corner values (jb * 2 + ib) of each residual, a[r][c],
// from the corners of u, v, p (and fx, fy): c[field][corner].
template <bool kHasF>
__device__ __forceinline__ void element_body(const float c[5][4],
                                             const NSConsts& k,
                                             float a[3][4]) {
  float uN[2][2], ux[2], uy[2], vN[2][2], vx[2], vy[2], pN[2][2], px[2],
      py[2], f1N[2][2] = {}, f2N[2][2] = {};
  gauss_values(c[0], k, uN, ux, uy);
  gauss_values(c[1], k, vN, vx, vy);
  gauss_values(c[2], k, pN, px, py);
  if (kHasF) {
    float g1, g2, hab;
    gauss_n(c[3], k, f1N, g1, g2, hab);
    gauss_n(c[4], k, f2N, g1, g2, hab);
  }

  // the integrands of each residual r at each Gauss point [gy][gx]:
  // against N (IN), dN/dx (IX) and dN/dy (IY)
  float IN[3][2][2], IX[3][2][2], IY[3][2][2];
#pragma unroll
  for (int gx = 0; gx < 2; ++gx)
#pragma unroll
    for (int gy = 0; gy < 2; ++gy) {
      const float u = uN[gx][gy], v = vN[gx][gy], p = pN[gx][gy];
      const float dudx = ux[gy], dvdx = vx[gy], dpdx = px[gy];
      const float dudy = uy[gx], dvdy = vy[gx], dpdy = py[gx];
      const float div = dudx + dvdy;
      // adv - f: what the N parts and the residuals take
      const float adv1 = fmaf(u, dudx, fmaf(v, dudy, -f1N[gx][gy]));
      const float adv2 = fmaf(u, dvdx, fmaf(v, dvdy, -f2N[gx][gy]));
      const float res1 = adv1 + dpdx;
      const float res2 = adv2 + dpdy;
      // tau_m = 1/sqrt(s2), tau_c = sqrt(s2)/(gxx + gyy); the advective
      // field is detached by construction (no derivative is taken here)
      const float s2 = fmaf(k.gxx * u, u, fmaf(k.gyy * v, v, k.diff));
      const float taum = rsqrt_normal(s2);
      const float tcd = (s2 * taum) * (k.isum_g * div);
      const float tm1 = taum * res1, tm2 = taum * res2;
      const float um = u - tm1, vm = v - tm2;
      IN[0][gy][gx] = fmaf(-tm2, dudy, fmaf(-tm1, dudx, adv1));
      IN[1][gy][gx] = fmaf(-tm2, dvdy, fmaf(-tm1, dvdx, adv2));
      IN[2][gy][gx] = div;
      IX[0][gy][gx] = fmaf(um, tm1, fmaf(k.visco, dudx, -p)) + tcd;
      IX[1][gy][gx] = fmaf(k.visco, dvdx, um * tm2);
      IX[2][gy][gx] = tm1;
      IY[0][gy][gx] = fmaf(k.visco, dudy, vm * tm1);
      IY[1][gy][gx] = fmaf(vm, tm2, fmaf(k.visco, dvdy, -p)) + tcd;
      IY[2][gy][gx] = tm2;
    }

  // projection to the corners: the N part is the interpolation's butterfly
  // again, and with the dx / dy parts folded in, corner (ib, jb) is
  // W/4 H0 + s_ib s_jb Q + s_ib Sa + s_jb Sb
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    // IN[r][gy][gx] in the corners' order (gy as jb, gx as ib)
    const float i0 = IN[r][0][0], i1 = IN[r][0][1];
    const float i2 = IN[r][1][0], i3 = IN[r][1][1];
    const float e = i0 + i3, f = i1 + i2;
    const float g1 = i0 - i3, g2 = i1 - i2;
    // the dx part summed over gx (X[gy]), the dy part over gy (Y[gx])
    const float X0 = IX[r][0][0] + IX[r][0][1], X1 = IX[r][1][0] + IX[r][1][1];
    const float Y0 = IY[r][0][0] + IY[r][1][0], Y1 = IY[r][0][1] + IY[r][1][1];
    const float sx = X0 + X1, dx = X0 - X1;
    const float sy = Y0 + Y1, dy = Y0 - Y1;
    const float q = fmaf(k.wh2, e - f, fmaf(-k.bx, dx, -k.by * dy));
    const float w0 = k.wq * (e + f);
    const float mp = w0 + q, mm = w0 - q;
    const float sp = fmaf(k.wh, g1, fmaf(-k.ax, sx, -k.ay * sy));
    const float sm = fmaf(-k.wh, g2, fmaf(-k.ax, sx, k.ay * sy));
    a[r][0] = mp + sp;
    a[r][1] = mm - sm;
    a[r][2] = mm + sm;
    a[r][3] = mp - sp;
  }
}

template <bool kHasF>
__global__ void __launch_bounds__(32 * kWarps)
ns_vms_kernel(const float* __restrict__ u, const float* __restrict__ v,
              const float* __restrict__ p, const float* __restrict__ fx,
              const float* __restrict__ fy, float* __restrict__ r1,
              float* __restrict__ r2, float* __restrict__ r3, int ny, int nx,
              int ty, NSConsts k) {
  constexpr int kF = kHasF ? 5 : 3;
  __shared__ float edge[kWarps][3][32];   // a strip's last bottom sums
  const int lane = threadIdx.x, w = threadIdx.y;
  const int x0 = blockIdx.x * kCols;
  // the block's element rows start at y0 - 1; warp w walks ty of them
  const int y0 = blockIdx.y * (kWarps * ty - 1);
  const int e0 = y0 - 1 + w * ty;
  const int64_t off = (int64_t)blockIdx.z * ny * nx;

  // this lane's element column ex; its node columns cl and cl + 1 clamped
  // into the grid (an element outside the grid contributes 0 whatever it
  // reads)
  const int ex = x0 - 1 + lane;
  const bool col_ok = ex >= 0 && ex < nx - 1;
  const int cl = min(max(ex, 0), nx - 2);
  const float* __restrict__ col[5] = {u + off + cl, v + off + cl,
                                      p + off + cl,
                                      kHasF ? fx + off + cl : nullptr,
                                      kHasF ? fy + off + cl : nullptr};
  float* __restrict__ res[3] = {r1 + off, r2 + off, r3 + off};
  const int x = x0 + lane;
  const bool writes = lane < kCols && x < nx;

  auto load_row = [&](int row, float (&l)[kF], float (&r)[kF]) {
    const int64_t ro = (int64_t)min(max(row, 0), ny - 1) * nx;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      l[f] = __ldg(col[f] + ro);
      r[f] = __ldg(col[f] + ro + 1);
    }
  };

  float tl[kF], tr[kF], bl[kF], br[kF];   // top / bottom corners, l / r
  load_row(e0, tl, tr);
  load_row(e0 + 1, bl, br);
  float carry[3] = {0.f, 0.f, 0.f};   // bottom-corner sums of the row above
  float first[3] = {0.f, 0.f, 0.f};   // the top sums of the first row
#pragma unroll 2
  for (int s = 0; s < ty; ++s) {
    const int ey = e0 + s;
    float nl[kF], nr[kF];
    load_row(ey + 2, nl, nr);   // the next element row's bottom corners
    float c[5][4] = {};
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      c[f][0] = tl[f];
      c[f][1] = tr[f];
      c[f][2] = bl[f];
      c[f][3] = br[f];
    }
    float a[3][4];
    element_body<kHasF>(c, k, a);
    const bool ok = col_ok && ey >= 0 && ey < ny - 1;
    // node (ey, x): the bottom corners of the row above, then the right
    // corners of this lane's element (ey, x - 1) and the left corners of
    // element (ey, x) from lane + 1
    float top[3], bot[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float right0 = __shfl_down_sync(kFull, ok ? a[r][0] : 0.f, 1);
      const float right2 = __shfl_down_sync(kFull, ok ? a[r][2] : 0.f, 1);
      top[r] = (ok ? a[r][1] : 0.f) + right0;
      bot[r] = (ok ? a[r][3] : 0.f) + right2;
    }
    const bool store = s > 0 && ey < ny && writes;
    const int64_t o = (int64_t)ey * nx + x;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (s == 0) first[r] = top[r];
      if (store) res[r][o] = carry[r] + top[r];
      carry[r] = bot[r];
    }
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      tl[f] = bl[f];
      tr[f] = br[f];
      bl[f] = nl[f];
      br[f] = nr[f];
    }
  }
  // node row e0 of warp w > 0 takes its bottom sums from the warp above
#pragma unroll
  for (int r = 0; r < 3; ++r) edge[w][r][lane] = carry[r];
  __syncthreads();
  if (w > 0 && e0 < ny && writes) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
      res[r][(int64_t)e0 * nx + x] = edge[w - 1][r][lane] + first[r];
  }
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

extern "C" {

// ty: node rows a warp walks, >= 1 (the wrapper picks it from the grid);
// ny, nx >= 2; anything else is refused with cudaErrorInvalidValue.
int ns_vms_residual(const float* u, const float* v, const float* p,
                    const float* fx, const float* fy, float* r1, float* r2,
                    float* r3, int B, int ny, int nx, int ty, int has_f,
                    float h,
                    float h2, float nkx, float kxh, float nky, float kyh,
                    float visco, float gxx, float gyy, float diff,
                    float isum_g, float wq, float wh, float wh2, float ax,
                    float ay, float bx, float by, void* stream) {
  if (ty < 1 || ny < 2 || nx < 2) return (int)cudaErrorInvalidValue;
  // a block writes node rows y0 .. y0 + kWarps * ty - 2; a last block
  // whose rows pass ny (or a grid shorter than one block) loads clamped
  // rows and stores none past ny
  const dim3 grid(cdiv(nx, kCols), cdiv(ny, kWarps * ty - 1), (unsigned)B);
  const dim3 block(32, kWarps);
  const NSConsts k{h,    h2,   nkx,    kxh, nky, kyh, visco, gxx, gyy,
                   diff, isum_g, wq, wh, wh2, ax,  ay,  bx,    by};
  cudaStream_t s = (cudaStream_t)stream;
  if (has_f)
    ns_vms_kernel<true><<<grid, block, 0, s>>>(u, v, p, fx, fy, r1, r2, r3,
                                            ny, nx, ty, k);
  else
    ns_vms_kernel<false><<<grid, block, 0, s>>>(u, v, p, fx, fy, r1, r2, r3,
                                             ny, nx, ty, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
