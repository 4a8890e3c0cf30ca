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
// Bound: operations. A level reads I0, I1, u, v once and writes u, v once
// (24 bytes a pixel), but does ~50 f32 operations a pixel per warp and ~52
// per primal-dual iteration: at 400 pairs of 128 x 128, 2 warps x 10
// iterations, that is 0.112 ms at 67 TFLOP/s against 0.047 ms of bytes.
// Kept in device memory, the state costs ~17 plane passes an iteration
// (~9 GB a level), so the state must stay on chip, as the TPU kernel keeps
// it in VMEM.
//
// Design, the "band" route (tvl1_band_kernel): one launch per level; one
// thread-block cluster per pair, one block of 512 threads per band of R
// rows of the padded domain (C = ceil(hp / R) blocks, C <= 8). Each block
// holds its band's ten f32 planes (u, v, q11, q12, q21, q22, I1wx, I1wy,
// rho_c, rgrad) in shared memory for all n_warps x n_iters: 80 KB at
// R = 16, wp = 128, so two bands share an SM and one computes while the
// other waits at a barrier. The pixels of a neighbouring band that a step
// reads come through distributed shared memory: the divergence reads q12,
// q22 of the row above the band, the forward differences read the new u, v
// of the row below, and mode 0's centred gradient reads I1w one row each
// way. One cluster barrier after each half-step (two an iteration) orders
// those reads against the writes; a one-block cluster takes the block's
// barrier instead. The warp step runs in the same launch: the separable pass
// as K3 computes it, the two vertical taps at the two sampled columns
// (x + pad + k) mod ww with v taken at the clamped column, then the
// horizontal lerp, so each element sees the operations of vpass_kernel then
// hpass_kernel in their order with no [hp, ww] intermediate; I0 and I1 are
// read from device memory (L2) by each warp step. I0, I1 and the input flow
// are read unpadded (a padded index is a clamp) and only the [h, w] crop of
// u and v is written. The band is compiled for R = 16 rows of a padded width
// of 128, the width of every production level and of the rescue window, so
// no plane offset is computed at run time; kernels/tvl1_level.py's
// level_plan sends every such shape with hp <= 128 here, with C =
// ceil(hp / 16). Timed on the card and not kept (PERF.md): 32-row bands,
// one a block of 512 or 1024 threads; 2-8 rows of a thread loaded before
// any is computed.
//
// The "tiles" route, for every other shape (a padded width other than 128,
// or hp beyond 8 bands: at 256 x 384, wp = 384 and hp needs 16 bands): a
// launch per step and per primal-dual iteration, the state in device
// scratch (pad, memset,
// then per warp clamp, warp passes and linearisation, n_iters primal-dual
// launches, then the crop). A primal-dual launch owns a 32 x 8 tile: the
// divergence and the new (u, v) on the tile plus one row and column of halo
// in shared memory, then the forward differences and the new p from there;
// the state ping-pongs between two buffers.
//
// Arithmetic follows the TPU kernel term by term; build with --fmad=false
// and without fast math so products, sums, '/' and sqrtf round as written.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace cg = cooperative_groups;

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

// Window image of one pair's plane at padded (Y, X), both already reduced
// mod (hh, ww): the edge-padded image with a margin of pad at the top and
// left, read as a clamp of the unpadded index.
__device__ __forceinline__ float win_at(const float* __restrict__ img, const Geo& g,
                                        int Y, int X) {
  return __ldg(img + clampi(Y - g.pad, 0, g.h - 1) * g.w + clampi(X - g.pad, 0, g.w - 1));
}

// The same for plane `pl` of a batch.
__device__ __forceinline__ float win(const float* __restrict__ src, const Geo& g,
                                     long long pl, int Y, int X) {
  return win_at(src + pl * g.h * g.w, g, Y, X);
}

// -- the band route -----------------------------------------------------------

constexpr int kBandThreads = 512;
constexpr int kBandWidth = 128;                       // the padded width, a thread a column
constexpr int kBandRows = 16;                         // two 16-row bands an SM
constexpr int kBandRowSlots = kBandThreads / kBandWidth;
constexpr int kBandMinBlocks = 2;
constexpr int kBandPlanes = 10;
constexpr int kBandSmem = kBandPlanes * kBandRows * kBandWidth * 4;   // 80 KB
constexpr int kMaxCluster = 8;                        // the portable cluster size
enum { U_, V_, Q11_, Q12_, Q21_, Q22_, IX_, IY_, RC_, RG_ };

struct BandArgs {
  const float* i0; const float* i1; const float* i1x; const float* i1y;
  const float* u_in; const float* v_in; float* u_out; float* v_out;
  Geo g;
  int n_warps, n_iters;
  float l_t, taut, theta, eps;
};

// f(ly, x, o) for each pixel this thread owns in its block's band: column
// x = lane, rows ly = slot, slot + 4, ... < nr; o = ly * 128 + x, the
// pixel's offset in each shared plane. Every phase uses this one mapping,
// so a pixel's own values need no barrier.
template <class F>
__device__ __forceinline__ void for_own(int nr, F&& f) {
  const int x = threadIdx.x % kBandWidth, slot = threadIdx.x / kBandWidth;
#pragma unroll
  for (int k = 0; k < kBandRows / kBandRowSlots; ++k) {
    const int ly = slot + k * kBandRowSlots;
    if (ly < nr) f(ly, x, ly * kBandWidth + x);
  }
}

// The separable window pass of K images at padded pixel (y, x): per sampled
// column c0, c1 the vertical lerp with weights from v at the clamped column
// (vpass_kernel's t), then the horizontal lerp with weights from u
// (hpass_kernel). vrow is row y of the band's v plane.
template <int K>
__device__ __forceinline__ void sep_pass(const float* const (&img)[K], const float* vrow,
                                         const Geo& g, int y, int x, float uu,
                                         float (&out)[K]) {
  const float fd = (float)g.d;
  const float kx = fminf(fmaxf(floorf(uu), -fd), fd);
  const float wx0 = tri(uu, kx), wx1 = tri(uu, kx + 1.0f);
  const int c0 = (x + g.pad + (int)kx) % g.ww;
  const int cs[2] = {c0, (c0 + 1) % g.ww};
  float t[2][K];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int X = cs[j];
    const float vv = vrow[clampi(X - g.pad, 0, g.wp - 1)];
    const float ky = fminf(fmaxf(floorf(vv), -fd), fd);
    const float w0 = tri(vv, ky), w1 = tri(vv, ky + 1.0f);
    const int r0 = (y + g.pad + (int)ky) % g.hh;
    const int r1 = (r0 + 1) % g.hh;
#pragma unroll
    for (int s = 0; s < K; ++s)
      t[j][s] = w0 * win_at(img[s], g, r0, X) + w1 * win_at(img[s], g, r1, X);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) out[s] = wx0 * t[0][s] + wx1 * t[1][s];
}

// The full 4-tap warp of I1, I1x, I1y at padded pixel (y, x) (full_kernel).
__device__ __forceinline__ void full_pass(const float* const (&img)[3], const Geo& g,
                                          int y, int x, float uu, float vv,
                                          float (&out)[3]) {
  const float fd = (float)g.d;
  const float ky = fminf(fmaxf(floorf(vv), -fd), fd);
  const float kx = fminf(fmaxf(floorf(uu), -fd), fd);
  const float wy0 = tri(vv, ky), wy1 = tri(vv, ky + 1.0f);
  const float wx0 = tri(uu, kx), wx1 = tri(uu, kx + 1.0f);
  const int r0 = (y + g.pad + (int)ky) % g.hh, r1 = (r0 + 1) % g.hh;
  const int c0 = (x + g.pad + (int)kx) % g.ww, c1 = (c0 + 1) % g.ww;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float acc = (wy0 * wx0) * win_at(img[s], g, r0, c0);
    acc = acc + (wy0 * wx1) * win_at(img[s], g, r0, c1);
    acc = acc + (wy1 * wx0) * win_at(img[s], g, r1, c0);
    acc = acc + (wy1 * wx1) * win_at(img[s], g, r1, c1);
    out[s] = acc;
  }
}

// One pyramid level of one pair per cluster; block `rank` of the cluster
// owns padded rows [rank * rows, min((rank + 1) * rows, hp)).
template <int MODE>
__global__ void __launch_bounds__(kBandThreads, kBandMinBlocks)
tvl1_band_kernel(const BandArgs a) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Geo& g = a.g;
  const int nblk = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long pair = blockIdx.x / nblk;
  constexpr int R = kBandRows, wp = kBandWidth;
  constexpr int P = R * wp;                            // floats in a plane
  const int hp = g.hp;
  const int y0 = rank * R;
  const int nr = min(R, hp - y0);
  float* const U = sm + U_ * P;
  float* const V = sm + V_ * P;
  float* const Q11 = sm + Q11_ * P;
  float* const Q12 = sm + Q12_ * P;
  float* const Q21 = sm + Q21_ * P;
  float* const Q22 = sm + Q22_ * P;
  float* const IX = sm + IX_ * P;
  float* const IY = sm + IY_ * P;
  float* const RC = sm + RC_ * P;
  float* const RG = sm + RG_ * P;
  // the neighbours' bands: row rows-1 of the block above, row 0 of the one
  // below (a plane k of theirs is k * P further on)
  const float* const up =
      rank > 0 ? cluster.map_shared_rank(sm, rank - 1) + (R - 1) * wp : nullptr;
  const float* const dn = rank < nblk - 1 ? cluster.map_shared_rank(sm, rank + 1) : nullptr;
  // the barrier after a phase that neighbours read: the cluster's, or the
  // block's when the cluster is this block alone
  auto band_sync = [&]() {
    if (nblk > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  const long long base = pair * g.h * g.w;
  const float* const i0 = a.i0 + base;
  const float* const imgs[3] = {a.i1 + base, MODE ? a.i1x + base : nullptr,
                                MODE ? a.i1y + base : nullptr};
  const float fd = (float)g.d;

  for_own(nr, [&](int ly, int x, int o) {
    const long long at = base + (long long)min(y0 + ly, g.h - 1) * g.w + min(x, g.w - 1);
    U[o] = a.u_in[at];
    V[o] = a.v_in[at];
    Q11[o] = Q12[o] = Q21[o] = Q22[o] = 0.0f;
  });
  cluster.sync();  // every block of the cluster runs, its duals are zero

  for (int wi = 0; wi < a.n_warps; ++wi) {
    for_own(nr, [&](int, int, int o) {
      U[o] = fminf(fmaxf(U[o], -fd), fd);
      V[o] = fminf(fmaxf(V[o], -fd), fd);
    });
    __syncthreads();  // the window pass reads v along the row
    if constexpr (MODE == 0) {
      // I1w into the rgrad plane, then its centred differences (one row of
      // each neighbour), rho_c, and last rgrad over the I1w it replaces
      for_own(nr, [&](int ly, int x, int o) {
        const float* const one[1] = {imgs[0]};
        float w1[1];
        sep_pass<1>(one, V + ly * wp, g, y0 + ly, x, U[o], w1);
        RG[o] = w1[0];
      });
      band_sync();
      for_own(nr, [&](int ly, int x, int o) {
        const int y = y0 + ly;
        const float c = RG[o];
        const float gx = x == 0 ? RG[o + 1] - c
                       : (x == wp - 1 ? c - RG[o - 1] : (RG[o + 1] - RG[o - 1]) * 0.5f);
        const float above = y == 0 ? 0.0f : (ly > 0 ? RG[o - wp] : up[RG_ * P + x]);
        const float below = y == hp - 1 ? 0.0f
                          : (ly < nr - 1 ? RG[o + wp] : dn[RG_ * P + x]);
        const float gy = y == 0 ? below - c
                       : (y == hp - 1 ? c - above : (below - above) * 0.5f);
        const float i0p = __ldg(i0 + min(y, g.h - 1) * g.w + min(x, g.w - 1));
        IX[o] = gx;
        IY[o] = gy;
        RC[o] = ((c - gx * U[o]) - gy * V[o]) - i0p;
      });
      band_sync();  // the neighbours have read this band's I1w
      for_own(nr, [&](int, int, int o) {
        const float ix = IX[o], iy = IY[o];
        RG[o] = 1.0f / fmaxf(ix * ix + iy * iy, a.eps);
      });
    } else {
      for_own(nr, [&](int ly, int x, int o) {
        const int y = y0 + ly;
        float wv[3];
        if constexpr (MODE == 1) {
          sep_pass<3>(imgs, V + ly * wp, g, y, x, U[o], wv);
        } else {
          full_pass(imgs, g, y, x, U[o], V[o], wv);
        }
        const float ix = wv[1], iy = wv[2];
        const float i0p = __ldg(i0 + min(y, g.h - 1) * g.w + min(x, g.w - 1));
        const float grad = ix * ix + iy * iy;
        IX[o] = ix;
        IY[o] = iy;
        RC[o] = ((wv[0] - ix * U[o]) - iy * V[o]) - i0p;
        RG[o] = 1.0f / fmaxf(grad, a.eps);
      });
      if constexpr (MODE == 1) {
        // the separable pass read v up to d columns away, across warps; the
        // primal half-step (or, with no iterations, the next warp's clamp)
        // overwrites v. Mode 2 reads only its own pixel's v.
        __syncthreads();
      }
    }
    for (int it = 0; it < a.n_iters; ++it) {
      // primal half-step: the divergence reads q of the pixel to the left
      // and of the row above
      for_own(nr, [&](int ly, int x, int o) {
        const int y = y0 + ly;
        const float u_ = U[o], v_ = V[o], ix = IX[o], iy = IY[o];
        const float rc = RC[o], rg = RG[o];
        const float q11 = Q11[o], q12 = Q12[o], q21 = Q21[o], q22 = Q22[o];
        const float l11 = x > 0 ? Q11[o - 1] : 0.0f;
        const float l21 = x > 0 ? Q21[o - 1] : 0.0f;
        const float a12 = y == 0 ? 0.0f : (ly > 0 ? Q12[o - wp] : up[Q12_ * P + x]);
        const float a22 = y == 0 ? 0.0f : (ly > 0 ? Q22[o - wp] : up[Q22_ * P + x]);
        const float rho = (rc + ix * u_) + iy * v_;
        const float step = fminf(fmaxf(-rho * rg, -a.l_t), a.l_t);
        const float u1 = u_ + step * ix;
        const float v1 = v_ + step * iy;
        // divergence: backward differences, first element kept, last negated
        float d1u = q11, d1v = q21;
        if (x == wp - 1) {
          d1u = -l11; d1v = -l21;
        } else if (x > 0) {
          d1u = q11 - l11; d1v = q21 - l21;
        }
        float d2u = q12, d2v = q22;
        if (y == hp - 1) {
          d2u = -a12; d2v = -a22;
        } else if (y > 0) {
          d2u = q12 - a12; d2v = q22 - a22;
        }
        U[o] = u1 + a.theta * (d1u + d2u);
        V[o] = v1 + a.theta * (d1v + d2v);
      });
      band_sync();
      // dual half-step: forward differences read the new u, v of the pixel
      // to the right and of the row below
      for_own(nr, [&](int ly, int x, int o) {
        const int y = y0 + ly;
        const float un = U[o], vn = V[o];
        const float q11 = Q11[o], q12 = Q12[o], q21 = Q21[o], q22 = Q22[o];
        const float ur = x < wp - 1 ? U[o + 1] : 0.0f;
        const float vr = x < wp - 1 ? V[o + 1] : 0.0f;
        const bool last = y == hp - 1;
        const float ub = last ? 0.0f : (ly < nr - 1 ? U[o + wp] : dn[U_ * P + x]);
        const float vb = last ? 0.0f : (ly < nr - 1 ? V[o + wp] : dn[V_ * P + x]);
        float ux = 0.0f, uy = 0.0f, vx = 0.0f, vy = 0.0f;
        if (x < wp - 1) {
          ux = ur - un;
          vx = vr - vn;
        }
        if (!last) {
          uy = ub - un;
          vy = vb - vn;
        }
        const float gu = sqrtf(ux * ux + uy * uy);
        const float gv = sqrtf(vx * vx + vy * vy);
        // __frcp_rn: the correctly rounded reciprocal, the bits of 1.0f / x
        const float ru = __frcp_rn(1.0f + a.taut * gu);
        const float rv = __frcp_rn(1.0f + a.taut * gv);
        Q11[o] = (q11 + a.taut * ux) * ru;
        Q12[o] = (q12 + a.taut * uy) * ru;
        Q21[o] = (q21 + a.taut * vx) * rv;
        Q22[o] = (q22 + a.taut * vy) * rv;
      });
      band_sync();
    }
  }
  // no block reads another's band after the last cluster barrier
  for_own(nr, [&](int ly, int x, int o) {
    const int y = y0 + ly;
    if (y < g.h && x < g.w) {
      const long long at = base + (long long)y * g.w + x;
      a.u_out[at] = U[o];
      a.v_out[at] = V[o];
    }
  });
}

// -- the tiles route -----------------------------------------------------------

// Edge-pad the input flow to [n, hp, wp] (the tiles route's state).
__global__ void __launch_bounds__(kThreads)
pad_kernel(const float* __restrict__ u, const float* __restrict__ v,
           float* __restrict__ up, float* __restrict__ vp, Geo g) {
  const long long total = (long long)g.n * g.hp * g.wp;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % g.wp);
  const int y = (int)((i / g.wp) % g.hp);
  const long long pl = i / ((long long)g.wp * g.hp);
  const long long at = (pl * g.h + min(y, g.h - 1)) * g.w + min(x, g.w - 1);
  up[i] = u[at];
  vp[i] = v[at];
}

// The [h, w] crop of the padded state into the outputs.
__global__ void __launch_bounds__(kThreads)
crop_kernel(const float* __restrict__ up, const float* __restrict__ vp,
            float* __restrict__ u, float* __restrict__ v, Geo g) {
  const long long total = (long long)g.n * g.h * g.w;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % g.w);
  const int y = (int)((i / g.w) % g.h);
  const long long pl = i / ((long long)g.w * g.h);
  const long long at = (pl * g.hp + y) * g.wp + x;
  u[i] = up[at];
  v[i] = vp[at];
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

// The tiles route. Scratch: 17 [n, hp, wp] planes (two state buffers of u,
// v and the dual field, I1w, its gradients, rho_c, rgrad) and the vertical
// pass's [n, hp, ww] planes.
cudaError_t run_tiles(const float* i0, const float* i1, const float* i1x,
                      const float* i1y, const float* u_in, const float* v_in,
                      float* u_out, float* v_out, float* scratch, const Geo& g,
                      int mode, int n_warps, int n_iters, float l_t, float taut,
                      float theta, float eps, cudaStream_t stream) {
  const long long P = plane(g);
  float* s = scratch;
  State a, b;
  a.u = s; s += P;
  a.v = s; s += P;
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
  if (err != cudaSuccess) return err;
  pad_kernel<<<blocks_for(P), kThreads, 0, stream>>>(u_in, v_in, a.u, a.v, g);
  const dim3 pd_grid((g.wp + kTX - 1) / kTX, (g.hp + kTY - 1) / kTY, g.n);
  const dim3 pd_block(kTX, kTY);
  State* cur = &a;
  State* nxt = &b;
  for (int wi = 0; wi < n_warps; ++wi) {
    clamp_kernel<<<blocks_for(P), kThreads, 0, stream>>>(cur->u, cur->v, P, (float)g.d);
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
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    for (int it = 0; it < n_iters; ++it) {
      pd_kernel<<<pd_grid, pd_block, 0, stream>>>(*cur, *nxt, rho_c, gx, gy, rgrad,
                                                   g.hp, g.wp, l_t, taut, theta);
      State* tmp = cur; cur = nxt; nxt = tmp;
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  crop_kernel<<<blocks_for((long long)g.n * g.h * g.w), kThreads, 0, stream>>>(
      cur->u, cur->v, u_out, v_out, g);
  return cudaGetLastError();
}

// What a band launch of (mode, cluster size) was found to be on a device:
// cudaOccupancyMaxActiveClusters asked once, at first use.
struct BandCheck {
  int device, mode, cluster;
  cudaError_t status;
};
std::mutex band_mu;
BandCheck band_checks[64];
int n_band_checks = 0;
bool smem_set[64];

template <int MODE>
cudaError_t check_band(const cudaLaunchConfig_t& cfg, int device, int cluster) {
  std::lock_guard<std::mutex> lock(band_mu);
  for (int i = 0; i < n_band_checks; ++i) {
    const BandCheck& c = band_checks[i];
    if (c.device == device && c.mode == MODE && c.cluster == cluster) return c.status;
  }
  cudaError_t err = cudaSuccess;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[device]) {
    for (const void* fn : {(const void*)tvl1_band_kernel<0>, (const void*)tvl1_band_kernel<1>,
                           (const void*)tvl1_band_kernel<2>}) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kBandSmem);
      if (err != cudaSuccess) return err;
    }
    smem_set[device] = true;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)tvl1_band_kernel<MODE>, &cfg);
  if (err == cudaSuccess && clusters < 1) err = cudaErrorInvalidConfiguration;
  if (n_band_checks < 64) band_checks[n_band_checks++] = {device, MODE, cluster, err};
  return err;
}

template <int MODE>
cudaError_t launch_band(const BandArgs& args, int n, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n * cluster));
  cfg.blockDim = dim3(kBandThreads);
  cfg.dynamicSmemBytes = (size_t)kBandSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if ((err = check_band<MODE>(cfg, device, cluster)) != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, tvl1_band_kernel<MODE>, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t run_band(const BandArgs& args, int n, int mode, int rows, int cluster, int smem,
                     cudaStream_t stream) {
  const Geo& g = args.g;
  // the plan's rules: the compiled band (16 rows of a 128-wide padded
  // domain, 80 KB), C = ceil(hp / 16) <= 8
  if (g.wp != kBandWidth || rows != kBandRows || smem != kBandSmem || cluster < 1
      || cluster > kMaxCluster || cluster != (g.hp + kBandRows - 1) / kBandRows
      || (long long)n * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch (mode) {
    case 0: return launch_band<0>(args, n, cluster, stream);
    case 1: return launch_band<1>(args, n, cluster, stream);
    case 2: return launch_band<2>(args, n, cluster, stream);
    default: return cudaErrorInvalidValue;
  }
}

float f32_from_bits(int64_t bits) {
  const uint32_t b = static_cast<uint32_t>(bits);
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
}

}  // namespace

// One pyramid level. args: 25 slots of 64 bits (kernels/_launch.py): i0, i1,
// i1x, i1y, u, v, u_out, v_out, scratch, n, h, w, d, mode, n_warps, n_iters,
// l_t, taut, theta, eps (each the bits of an f32), route (0 band, 1 tiles),
// rows, cluster, smem, stream. i0, i1, u, v (and i1x, i1y in modes 1 and 2)
// are unpadded [n, h, w]; u_out, v_out receive the updated flow [n, h, w].
// scratch (tiles route only) holds 17 * n * hp * wp + t * n * hp * ww floats,
// t = 1, 3, 0 in modes 0, 1, 2 (run_tiles).
// Returns the cudaError_t of the launches (0 = success).
extern "C" int vq_tvl1_level(const int64_t* args) {
  int64_t s[25];
  memcpy(s, args, sizeof s);
  auto fp = [&](int i) { return reinterpret_cast<float*>(s[i]); };
  auto num = [&](int i) { return static_cast<int>(s[i]); };
  const Geo g = make_geo(num(9), num(10), num(11), num(12));
  const int mode = num(13), route = num(20);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(s[24]);
  if (plane(g) == 0) return 0;
  if (mode < 0 || mode > 2 || g.d < 1) return (int)cudaErrorInvalidValue;
  const float l_t = f32_from_bits(s[16]), taut = f32_from_bits(s[17]);
  const float theta = f32_from_bits(s[18]), eps = f32_from_bits(s[19]);
  if (route == 1) {
    return (int)run_tiles(fp(0), fp(1), fp(2), fp(3), fp(4), fp(5), fp(6), fp(7), fp(8),
                          g, mode, num(14), num(15), l_t, taut, theta, eps, stream);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  BandArgs a;
  a.i0 = fp(0); a.i1 = fp(1); a.i1x = fp(2); a.i1y = fp(3);
  a.u_in = fp(4); a.v_in = fp(5); a.u_out = fp(6); a.v_out = fp(7);
  a.g = g;
  a.n_warps = num(14); a.n_iters = num(15);
  a.l_t = l_t; a.taut = taut; a.theta = theta; a.eps = eps;
  return (int)run_band(a, g.n, mode, num(21), num(22), num(23), stream);
}

