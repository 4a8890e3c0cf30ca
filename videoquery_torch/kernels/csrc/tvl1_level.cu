// K2: one TV-L1 pyramid level for a batch of frame pairs, NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel videoquery/kernels/tvl1_pallas.py::_level_kernel
// (entry tvl1_level_pallas). For each of n_warps warps: clamp (u, v) to +-d,
// warp I1 by the flow, linearise (rho_c = I1w - I1wx u - I1wy v - I0 and
// rgrad = 1 / max(|grad I1w|^2, eps)), then n_iters primal-dual steps of the
// flow (u, v) and the dual field p = (p11, p12, p21, p22), which carries from
// warp to warp and starts at zero.
//
// The domain is the TPU kernel's, so that the result is the same:
//   - every plane is padded to [hp, wp] = [ceil8(h), ceil128(w)] with edge
//     values, and the iteration runs on that whole padded domain: the
//     forward differences, the divergence and the warped-gradient borders
//     sit at hp-1 and wp-1, not at h-1 and w-1;
//   - I1 (and in "image" mode I1x, I1y) is read as the TPU kernel's window
//     image, padded by d+1 at the top and left to [hh, ww] =
//     [ceil8(h + 2d + 2), ceil128(w + 2d + 2)], and INDEXED MODULO (hh, ww),
//     because pltpu.roll is circular: at the coarse levels (w = 64, 32, 16,
//     so wp = ww = 128) the right columns of the padded domain read
//     wrapped-around image columns, and through the TV coupling that can
//     reach the valid region. The window images are never materialised: a
//     padded index is a clamp of the unpadded one.
// Warp modes: 0 warped + separable (production: only I1 moves through the
// window, its gradients are centred differences of the warped image),
// 1 image + separable (I1, I1x, I1y through the window), 2 image + full
// (4-tap bilinear). A separable window pass is a 2-tap lerp (see
// window_warp.cu); weights use the TPU kernel's own expression.
//
// Design: the state of one pair at 128 x 128 is ~12 f32 planes (~768 KB),
// more than one SM's 227 KB of shared memory, and 400 key pairs per batch
// hold ~300 MB. So this first kernel keeps the state in device memory: one
// C call per level loops over the warps; each warp launches the clamp, the
// warp passes and the linearisation, then n_iters primal-dual kernels. A
// primal-dual kernel owns a 32 x 8 tile: it computes the divergence of p and
// the new (u, v) on the tile plus one row and column of halo into shared
// memory, then the forward differences and the new p from there, so nothing
// of that step makes a round trip through device memory. State ping-pongs
// between two buffers (neighbouring tiles read the old values).
//
// Bound: device-memory bytes. Each iteration reads u, v, p (6 planes) and
// rho_c, I1wx, I1wy, rgrad (4), ~15% of it again for the halo, and writes
// 6: ~17 plane passes, ~0.45 GB per iteration for 400 pairs at 128 x 128.
// A later PR keeps the coarse levels (<= 64 x 64, padded to 64 x 128) whole
// in one block's shared memory for all their iterations, and uses thread
// block clusters with distributed shared memory at 128 x 128, so that the
// iterations of a warp touch device memory once.
//
// Arithmetic follows the TPU kernel term by term; build with --fmad=false
// and without fast math so products, sums, '/' and sqrtf round as written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 32;   // primal-dual tile width (one warp per row)
constexpr int kTY = 8;    // primal-dual tile height

struct Geo {
  int n, h, w, d, pad, hp, wp, hh, ww;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

Geo make_geo(int n, int h, int w, int d) {
  Geo g;
  g.n = n; g.h = h; g.w = w; g.d = d; g.pad = d + 1;
  g.hp = round_up(h, 8); g.wp = round_up(w, 128);
  g.hh = round_up(h + 2 * g.pad, 8); g.ww = round_up(w + 2 * g.pad, 128);
  return g;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float tri(float f, float k) {
  return fmaxf(0.0f, 1.0f - fabsf(f - k));
}

// Window image of plane `pl` at padded (Y, X), both already reduced mod
// (hh, ww): the edge-padded image with a margin of pad at the top and left.
__device__ __forceinline__ float win(const float* __restrict__ src, const Geo& g,
                                     long long pl, int Y, int X) {
  const int r = clampi(Y - g.pad, 0, g.h - 1);
  const int c = clampi(X - g.pad, 0, g.w - 1);
  return src[pl * g.h * g.w + (long long)r * g.w + c];
}

__global__ void __launch_bounds__(kThreads)
clamp_kernel(float* __restrict__ u, float* __restrict__ v, long long count, float d) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= count) return;
  u[i] = fminf(fmaxf(u[i], -d), d);
  v[i] = fminf(fmaxf(v[i], -d), d);
}

// Vertical separable pass: t[n, y, X] for y < hp, X < ww, weights from
// v_ext[y, X] = v[y, clamp(X - pad, 0, wp - 1)].
__global__ void __launch_bounds__(kThreads)
vpass_kernel(const float* __restrict__ i1, const float* __restrict__ i1x,
             const float* __restrict__ i1y, const float* __restrict__ v,
             float* __restrict__ t0, float* __restrict__ t1, float* __restrict__ t2,
             Geo g, int three) {
  const long long total = (long long)g.n * g.hp * g.ww;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int X = (int)(i % g.ww);
  const int y = (int)((i / g.ww) % g.hp);
  const long long pl = i / ((long long)g.ww * g.hp);
  const float fd = (float)g.d;
  const float vv = v[(pl * g.hp + y) * g.wp + clampi(X - g.pad, 0, g.wp - 1)];
  const float k0 = fminf(fmaxf(floorf(vv), -fd), fd);
  const float w0 = tri(vv, k0), w1 = tri(vv, k0 + 1.0f);
  const int r0 = (y + g.pad + (int)k0) % g.hh;
  const int r1 = (r0 + 1) % g.hh;
  t0[i] = w0 * win(i1, g, pl, r0, X) + w1 * win(i1, g, pl, r1, X);
  if (three) {
    t1[i] = w0 * win(i1x, g, pl, r0, X) + w1 * win(i1x, g, pl, r1, X);
    t2[i] = w0 * win(i1y, g, pl, r0, X) + w1 * win(i1y, g, pl, r1, X);
  }
}

// Horizontal separable pass: o[n, y, x] for y < hp, x < wp, columns read
// modulo ww.
__global__ void __launch_bounds__(kThreads)
hpass_kernel(const float* __restrict__ t0, const float* __restrict__ t1,
             const float* __restrict__ t2, const float* __restrict__ u,
             float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
             Geo g, int three) {
  const long long total = (long long)g.n * g.hp * g.wp;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % g.wp);
  const long long row = i / g.wp;           // pl * hp + y
  const float fd = (float)g.d;
  const float uu = u[i];
  const float k0 = fminf(fmaxf(floorf(uu), -fd), fd);
  const float w0 = tri(uu, k0), w1 = tri(uu, k0 + 1.0f);
  const int c0 = (x + g.pad + (int)k0) % g.ww;
  const int c1 = (c0 + 1) % g.ww;
  const long long r = row * g.ww;
  o0[i] = w0 * t0[r + c0] + w1 * t0[r + c1];
  if (three) {
    o1[i] = w0 * t1[r + c0] + w1 * t1[r + c1];
    o2[i] = w0 * t2[r + c0] + w1 * t2[r + c1];
  }
}

// Full 4-tap bilinear warp of I1, I1x, I1y (mode 2), in the TPU loop's order.
__global__ void __launch_bounds__(kThreads)
full_kernel(const float* __restrict__ i1, const float* __restrict__ i1x,
            const float* __restrict__ i1y, const float* __restrict__ u,
            const float* __restrict__ v, float* __restrict__ o0,
            float* __restrict__ o1, float* __restrict__ o2, Geo g) {
  const long long total = (long long)g.n * g.hp * g.wp;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % g.wp);
  const int y = (int)((i / g.wp) % g.hp);
  const long long pl = i / ((long long)g.wp * g.hp);
  const float fd = (float)g.d;
  const float uu = u[i], vv = v[i];
  const float ky = fminf(fmaxf(floorf(vv), -fd), fd);
  const float kx = fminf(fmaxf(floorf(uu), -fd), fd);
  const float wy0 = tri(vv, ky), wy1 = tri(vv, ky + 1.0f);
  const float wx0 = tri(uu, kx), wx1 = tri(uu, kx + 1.0f);
  const int r0 = (y + g.pad + (int)ky) % g.hh, r1 = (r0 + 1) % g.hh;
  const int c0 = (x + g.pad + (int)kx) % g.ww, c1 = (c0 + 1) % g.ww;
  const float* srcs[3] = {i1, i1x, i1y};
  float* outs[3] = {o0, o1, o2};
  for (int s = 0; s < 3; ++s) {
    float acc = (wy0 * wx0) * win(srcs[s], g, pl, r0, c0);
    acc = acc + (wy0 * wx1) * win(srcs[s], g, pl, r0, c1);
    acc = acc + (wy1 * wx0) * win(srcs[s], g, pl, r1, c0);
    acc = acc + (wy1 * wx1) * win(srcs[s], g, pl, r1, c1);
    outs[s][i] = acc;
  }
}

// Centred differences of the warped image, one-sided at the padded
// domain's borders (mode 0).
__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ a, float* __restrict__ gx,
            float* __restrict__ gy, Geo g) {
  const long long total = (long long)g.n * g.hp * g.wp;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % g.wp);
  const int y = (int)((i / g.wp) % g.hp);
  const int W = g.wp, H = g.hp;
  gx[i] = x == 0 ? a[i + 1] - a[i]
        : (x == W - 1 ? a[i] - a[i - 1] : (a[i + 1] - a[i - 1]) * 0.5f);
  gy[i] = y == 0 ? a[i + W] - a[i]
        : (y == H - 1 ? a[i] - a[i - W] : (a[i + W] - a[i - W]) * 0.5f);
}

// Linearisation: rho_c and rgrad (I0 read edge-padded to [hp, wp]).
__global__ void __launch_bounds__(kThreads)
lin_kernel(const float* __restrict__ i1w, const float* __restrict__ gx,
           const float* __restrict__ gy, const float* __restrict__ u,
           const float* __restrict__ v, const float* __restrict__ i0,
           float* __restrict__ rho_c, float* __restrict__ rgrad, Geo g, float eps) {
  const long long total = (long long)g.n * g.hp * g.wp;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % g.wp);
  const int y = (int)((i / g.wp) % g.hp);
  const long long pl = i / ((long long)g.wp * g.hp);
  const float i0p = i0[(pl * g.h + min(y, g.h - 1)) * g.w + min(x, g.w - 1)];
  const float ix = gx[i], iy = gy[i];
  const float grad = ix * ix + iy * iy;
  rho_c[i] = ((i1w[i] - ix * u[i]) - iy * v[i]) - i0p;
  rgrad[i] = 1.0f / fmaxf(grad, eps);
}

struct State {
  float* u; float* v; float* q[4];
};

// One primal-dual step on a kTX x kTY tile (one block per tile and pair).
__global__ void __launch_bounds__(kTX * kTY)
pd_kernel(State in, State out, const float* __restrict__ rho_c,
          const float* __restrict__ gx, const float* __restrict__ gy,
          const float* __restrict__ rgrad, int H, int W,
          float l_t, float taut, float theta) {
  __shared__ float sun[kTY + 1][kTX + 2];
  __shared__ float svn[kTY + 1][kTX + 2];
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const long long base = (long long)blockIdx.z * H * W;
  const float* __restrict__ q11 = in.q[0];
  const float* __restrict__ q12 = in.q[1];
  const float* __restrict__ q21 = in.q[2];
  const float* __restrict__ q22 = in.q[3];
  const int tid = threadIdx.y * kTX + threadIdx.x;
  // primal update on the tile plus one halo row and column (bottom, right)
  for (int k = tid; k < (kTY + 1) * (kTX + 1); k += kTX * kTY) {
    const int ly = k / (kTX + 1), lx = k % (kTX + 1);
    const int y = y0 + ly, x = x0 + lx;
    if (y >= H || x >= W) continue;
    const long long o = base + (long long)y * W + x;
    const float u_ = in.u[o], v_ = in.v[o];
    const float ix = gx[o], iy = gy[o];
    const float rho = (rho_c[o] + ix * u_) + iy * v_;
    const float step = fminf(fmaxf(-rho * rgrad[o], -l_t), l_t);
    const float u1 = u_ + step * ix;
    const float v1 = v_ + step * iy;
    // divergence: backward differences, first element kept, last negated
    const float d1u = x == 0 ? q11[o] : (x == W - 1 ? -q11[o - 1] : q11[o] - q11[o - 1]);
    const float d2u = y == 0 ? q12[o] : (y == H - 1 ? -q12[o - W] : q12[o] - q12[o - W]);
    const float d1v = x == 0 ? q21[o] : (x == W - 1 ? -q21[o - 1] : q21[o] - q21[o - 1]);
    const float d2v = y == 0 ? q22[o] : (y == H - 1 ? -q22[o - W] : q22[o] - q22[o - W]);
    sun[ly][lx] = u1 + theta * (d1u + d2u);
    svn[ly][lx] = v1 + theta * (d1v + d2v);
  }
  __syncthreads();
  const int lx = threadIdx.x, ly = threadIdx.y;
  const int x = x0 + lx, y = y0 + ly;
  if (x >= W || y >= H) return;
  const long long o = base + (long long)y * W + x;
  const float un = sun[ly][lx], vn = svn[ly][lx];
  // forward differences, zero at the far edge
  const float ux = x < W - 1 ? sun[ly][lx + 1] - un : 0.0f;
  const float uy = y < H - 1 ? sun[ly + 1][lx] - un : 0.0f;
  const float vx = x < W - 1 ? svn[ly][lx + 1] - vn : 0.0f;
  const float vy = y < H - 1 ? svn[ly + 1][lx] - vn : 0.0f;
  const float gu = sqrtf(ux * ux + uy * uy);
  const float gv = sqrtf(vx * vx + vy * vy);
  const float ru = 1.0f / (1.0f + taut * gu);
  const float rv = 1.0f / (1.0f + taut * gv);
  out.q[0][o] = (q11[o] + taut * ux) * ru;
  out.q[1][o] = (q12[o] + taut * uy) * ru;
  out.q[2][o] = (q21[o] + taut * vx) * rv;
  out.q[3][o] = (q22[o] + taut * vy) * rv;
  out.u[o] = un;
  out.v[o] = vn;
}

unsigned blocks_for(long long count) {
  return (unsigned)((count + kThreads - 1) / kThreads);
}

long long plane(const Geo& g) { return (long long)g.n * g.hp * g.wp; }
long long tplane(const Geo& g) { return (long long)g.n * g.hp * g.ww; }
int t_planes(int mode) { return mode == 0 ? 1 : (mode == 1 ? 3 : 0); }

}  // namespace

// Floats of scratch vq_tvl1_level needs: 15 [n, hp, wp] planes (the second
// state buffer, two dual fields, I1w, its gradients, rho_c, rgrad) and the
// vertical pass's [n, hp, ww] planes.
extern "C" long long vq_tvl1_level_scratch(int n, int h, int w, int d, int mode) {
  const Geo g = make_geo(n, h, w, d);
  return 15 * plane(g) + t_planes(mode) * tplane(g);
}

// One pyramid level. i0, i1 (and i1x, i1y in modes 1 and 2) are unpadded
// [n, h, w]; u, v are the flow on the padded domain [n, hp, wp], updated in
// place. Returns a CUDA error code (0 on success).
extern "C" int vq_tvl1_level(const float* i0, const float* i1, const float* i1x,
                             const float* i1y, float* u, float* v, float* scratch,
                             int n, int h, int w, int d, int mode, int n_warps,
                             int n_iters, float l_t, float taut, float theta,
                             float eps, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Geo g = make_geo(n, h, w, d);
  const long long P = plane(g);
  if (P == 0) return 0;
  float* s = scratch;
  State a, b;
  a.u = u; a.v = v;
  b.u = s; s += P;
  b.v = s; s += P;
  for (int k = 0; k < 4; ++k) { a.q[k] = s; s += P; }
  for (int k = 0; k < 4; ++k) { b.q[k] = s; s += P; }
  float* i1w = s; s += P;
  float* gx = s; s += P;
  float* gy = s; s += P;
  float* rho_c = s; s += P;
  float* rgrad = s; s += P;
  float* t[3] = {s, s + tplane(g), s + 2 * tplane(g)};
  cudaError_t err = cudaMemsetAsync(a.q[0], 0, 4 * P * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 pd_grid((g.wp + kTX - 1) / kTX, (g.hp + kTY - 1) / kTY, g.n);
  const dim3 pd_block(kTX, kTY);
  State* cur = &a;
  State* nxt = &b;
  for (int wi = 0; wi < n_warps; ++wi) {
    clamp_kernel<<<blocks_for(P), kThreads, 0, stream>>>(cur->u, cur->v, P, (float)d);
    if (mode == 2) {
      full_kernel<<<blocks_for(P), kThreads, 0, stream>>>(
          i1, i1x, i1y, cur->u, cur->v, i1w, gx, gy, g);
    } else {
      const int three = mode == 1;
      vpass_kernel<<<blocks_for(tplane(g)), kThreads, 0, stream>>>(
          i1, i1x, i1y, cur->v, t[0], t[1], t[2], g, three);
      hpass_kernel<<<blocks_for(P), kThreads, 0, stream>>>(
          t[0], t[1], t[2], cur->u, i1w, gx, gy, g, three);
      if (mode == 0) {
        grad_kernel<<<blocks_for(P), kThreads, 0, stream>>>(i1w, gx, gy, g);
      }
    }
    lin_kernel<<<blocks_for(P), kThreads, 0, stream>>>(
        i1w, gx, gy, cur->u, cur->v, i0, rho_c, rgrad, g, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int it = 0; it < n_iters; ++it) {
      pd_kernel<<<pd_grid, pd_block, 0, stream>>>(*cur, *nxt, rho_c, gx, gy, rgrad,
                                                   g.hp, g.wp, l_t, taut, theta);
      State* tmp = cur; cur = nxt; nxt = tmp;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (cur->u != u) {
    err = cudaMemcpyAsync(u, cur->u, P * sizeof(float), cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyAsync(v, cur->v, P * sizeof(float), cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
