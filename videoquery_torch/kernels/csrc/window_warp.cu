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
// Bound: device-memory bytes. One thread per output pixel reads u, v, two
// more v and four image values (L1 hits for neighbouring threads) and
// writes one float: ~12 bytes of compulsory traffic per pixel, so at the
// production shapes (400 x 128 x 128) the launch is a few microseconds of
// bandwidth plus launch latency.
//
// Arithmetic follows the TPU kernel term by term; build with --fmad=false
// and without fast math so products and sums are rounded as written.

#include <cuda_runtime.h>
#include <math.h>

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
  const float fd = (float)d;
  const float uu = clampf(u[idx], fd);
  const float dx0 = fminf(fmaxf(floorf(uu), -fd), fd);
  const float wx0 = tri(uu, dx0);
  const float wx1 = tri(uu, dx0 + 1.0f);
  const int ix = (int)dx0;
  float acc;
  if (separable) {
    float t[2];
    for (int j = 0; j < 2; ++j) {
      const int col = clampi(x + ix + j, 0, w - 1);   // sampled column
      const float vv = clampf(v[base + (long long)y * w + col], fd);
      const float dy0 = fminf(fmaxf(floorf(vv), -fd), fd);
      const int r0 = clampi(y + (int)dy0, 0, h - 1);
      const int r1 = clampi(y + (int)dy0 + 1, 0, h - 1);
      t[j] = tri(vv, dy0) * img[base + (long long)r0 * w + col]
           + tri(vv, dy0 + 1.0f) * img[base + (long long)r1 * w + col];
    }
    acc = wx0 * t[0] + wx1 * t[1];
  } else {
    const float vv = clampf(v[idx], fd);
    const float dy0 = fminf(fmaxf(floorf(vv), -fd), fd);
    const float wy0 = tri(vv, dy0);
    const float wy1 = tri(vv, dy0 + 1.0f);
    const int r0 = clampi(y + (int)dy0, 0, h - 1);
    const int r1 = clampi(y + (int)dy0 + 1, 0, h - 1);
    const int c0 = clampi(x + ix, 0, w - 1);
    const int c1 = clampi(x + ix + 1, 0, w - 1);
    const float* p0 = img + base + (long long)r0 * w;
    const float* p1 = img + base + (long long)r1 * w;
    acc = (wy0 * wx0) * p0[c0];
    acc = acc + (wy0 * wx1) * p0[c1];
    acc = acc + (wy1 * wx0) * p1[c0];
    acc = acc + (wy1 * wx1) * p1[c1];
  }
  out[idx] = acc;
}

}  // namespace

extern "C" int vq_window_warp(const float* img, const float* u, const float* v,
                              float* out, int n, int h, int w, int d,
                              int separable, void* stream) {
  const long long total = (long long)n * h * w;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  warp_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      img, u, v, out, n, h, w, d, separable);
  return (int)cudaGetLastError();
}
