// K3: batched window warp for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel videoquery/kernels/tvl1_pallas.py::_warp_kernel
// (entry window_warp_pallas). out[n, y, x] samples img[n] at (y + v, x + u)
// with the flow clamped to +-d and edge-clamped borders.
//
// The TPU kernel sums a window of 2d+2 integer shifts, each a pltpu.roll of
// the edge-padded image times a triangle weight max(0, 1 - |f - k|). For a
// flow clamped to +-d only the two shifts k = floor(f) and floor(f) + 1 have
// a weight that is not exactly zero, so each window pass is a 2-tap linear
// interpolation; here it is a gather from L1, with the weights computed by
// the TPU kernel's own expression so that the sums are the same.
//   separable (production): a vertical lerp at each sampled column X with
//     weights from v taken at the CLAMPED column X (the TPU kernel's v_ext:
//     v edge-extended into the window margins), then a horizontal lerp of
//     those two columns with weights from u(y, x). This is the TPU kernel's
//     factorized result, exact only where the flow is locally constant; it
//     is reproduced, not replaced by exact bilinear.
//   full: the 4-tap bilinear, summed in the TPU loop's order.
// The output is cropped to [h, w], so no read ever wraps around the TPU
// kernel's circular roll and the padded image need not exist: a padded
// index becomes a clamp of the unpadded one.
//
// Bound: device-memory bytes. Each output pixel reads u, v and four image
// values (L1 hits for neighbouring threads) and writes one float: 16 bytes
// of compulsory traffic a pixel, 0.0313 ms at 400 x 128 x 128. Where w % 4
// == 0 and u, v and out lie on 16-byte boundaries (every production shape),
// one thread writes four neighbouring pixels of a row: u (and in full mode
// v) is one 16-byte load, the output one 16-byte store; the vertical taps
// and the image reads stay gathers. Other widths keep one thread a pixel.
// Each pixel's arithmetic is the same in both bodies (warp_pixel). Most of
// the extraction path's launches are the camera's small LK warps at 48 x 64,
// where the host's cost of a launch is the time: the entry takes its
// arguments as one packed block (kernels/_launch.py).
//
// Arithmetic follows the TPU kernel term by term; build with --fmad=false
// and without fast math so products and sums are rounded as written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float clampf(float x, float d) {
  return fminf(fmaxf(x, -d), d);
}

// Triangle weight of shift k for flow f: max(0, 1 - |f - k|).
__device__ __forceinline__ float tri(float f, float k) {
  return fmaxf(0.0f, 1.0f - fabsf(f - k));
}

// One output pixel (y, x) of a plane: img and v point at the pair's plane,
// u_raw is u there (and v_raw v, read by full mode only).
__device__ __forceinline__ float warp_pixel(const float* __restrict__ img,
                                            const float* __restrict__ v, int h, int w,
                                            int y, int x, float u_raw, float v_raw,
                                            float fd, int separable) {
  const float uu = clampf(u_raw, fd);
  const float dx0 = fminf(fmaxf(floorf(uu), -fd), fd);
  const float wx0 = tri(uu, dx0);
  const float wx1 = tri(uu, dx0 + 1.0f);
  const int ix = (int)dx0;
  if (separable) {
    float t[2];
    for (int j = 0; j < 2; ++j) {
      const int col = clampi(x + ix + j, 0, w - 1);   // sampled column
      const float vv = clampf(v[(long long)y * w + col], fd);
      const float dy0 = fminf(fmaxf(floorf(vv), -fd), fd);
      const int r0 = clampi(y + (int)dy0, 0, h - 1);
      const int r1 = clampi(y + (int)dy0 + 1, 0, h - 1);
      t[j] = tri(vv, dy0) * img[(long long)r0 * w + col]
           + tri(vv, dy0 + 1.0f) * img[(long long)r1 * w + col];
    }
    return wx0 * t[0] + wx1 * t[1];
  }
  const float vv = clampf(v_raw, fd);
  const float dy0 = fminf(fmaxf(floorf(vv), -fd), fd);
  const float wy0 = tri(vv, dy0);
  const float wy1 = tri(vv, dy0 + 1.0f);
  const int r0 = clampi(y + (int)dy0, 0, h - 1);
  const int r1 = clampi(y + (int)dy0 + 1, 0, h - 1);
  const int c0 = clampi(x + ix, 0, w - 1);
  const int c1 = clampi(x + ix + 1, 0, w - 1);
  const float* p0 = img + (long long)r0 * w;
  const float* p1 = img + (long long)r1 * w;
  float acc = (wy0 * wx0) * p0[c0];
  acc = acc + (wy0 * wx1) * p0[c1];
  acc = acc + (wy1 * wx0) * p1[c0];
  acc = acc + (wy1 * wx1) * p1[c1];
  return acc;
}

// One thread a pixel (any width).
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ img, const float* __restrict__ u,
            const float* __restrict__ v, float* __restrict__ out,
            int n, int h, int w, int d, int separable) {
  const long long total = (long long)n * h * w;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int x = (int)(idx % w);
  const int y = (int)((idx / w) % h);
  const long long base = idx - (long long)y * w - x;  // plane start
  out[idx] = warp_pixel(img + base, v + base, h, w, y, x, u[idx],
                        separable ? 0.0f : v[idx], (float)d, separable);
}

// Four neighbouring pixels of a row a thread (w % 4 == 0, 16-byte aligned
// u, v, out).
__global__ void __launch_bounds__(kThreads)
warp4_kernel(const float* __restrict__ img, const float* __restrict__ u,
             const float* __restrict__ v, float* __restrict__ out,
             int n, int h, int w, int d, int separable) {
  const long long total4 = (long long)n * h * w / 4;
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= total4) return;
  const long long idx = q * 4;
  const int x = (int)(idx % w);
  const int y = (int)((idx / w) % h);
  const long long base = idx - (long long)y * w - x;
  const float fd = (float)d;
  const float4 uq = __ldg(reinterpret_cast<const float4*>(u) + q);
  const float4 vq = separable ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                              : __ldg(reinterpret_cast<const float4*>(v) + q);
  const float* im = img + base;
  const float* vp = v + base;
  float4 o;
  o.x = warp_pixel(im, vp, h, w, y, x, uq.x, vq.x, fd, separable);
  o.y = warp_pixel(im, vp, h, w, y, x + 1, uq.y, vq.y, fd, separable);
  o.z = warp_pixel(im, vp, h, w, y, x + 2, uq.z, vq.z, fd, separable);
  o.w = warp_pixel(im, vp, h, w, y, x + 3, uq.w, vq.w, fd, separable);
  reinterpret_cast<float4*>(out)[q] = o;
}

}  // namespace

// One launch of K3. args: 10 slots of 64 bits (kernels/_launch.py): img, u,
// v, out, n, h, w, d, separable, stream; all [n, h, w] f32. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int vq_window_warp(const int64_t* args) {
  int64_t a[10];
  memcpy(a, args, sizeof a);
  const float* img = reinterpret_cast<const float*>(a[0]);
  const float* u = reinterpret_cast<const float*>(a[1]);
  const float* v = reinterpret_cast<const float*>(a[2]);
  float* out = reinterpret_cast<float*>(a[3]);
  const int n = static_cast<int>(a[4]), h = static_cast<int>(a[5]);
  const int w = static_cast<int>(a[6]), d = static_cast<int>(a[7]);
  const int separable = static_cast<int>(a[8]);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[9]);
  const long long total = (long long)n * h * w;
  if (total == 0) return 0;
  const bool vec = w % 4 == 0
      && ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(v)
           | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec) {
    const long long blocks = (total / 4 + kThreads - 1) / kThreads;
    warp4_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(img, u, v, out, n, h, w, d,
                                                            separable);
  } else {
    const long long blocks = (total + kThreads - 1) / kThreads;
    warp_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(img, u, v, out, n, h, w, d,
                                                           separable);
  }
  return (int)cudaGetLastError();
}
