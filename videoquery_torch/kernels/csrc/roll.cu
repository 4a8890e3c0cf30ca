// T2: roll of f32 planes by a shift read from device memory, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/mosaic_roll_repro.py (kernel `k` of
// make_kernel): pltpu.roll of an f32 [H, W] tile along axis 0 or 1 by a
// shift that the kernel reads from scalar memory (SMEM), of either sign.
// Here the shift is one int32 in device memory that every thread reads, so
// it stays a run-time value, as the TPU's SMEM scalar is: no launch argument
// carries it and no host sync is needed to learn it.
//
// Semantics are np.roll's: out[.., i, ..] = in[.., (i - shift) mod L, ..]
// along the rolled axis of length L, with the shift taken modulo L, so
// negative shifts (the case the TPU compiler got wrong on axis 0) are the
// positive complement.
//
// Bound: device-memory bytes, one read and one write of every element
// (2 x 80 x 256 x 4 bytes for the repro's tile, ~50 ns at 3.35 TB/s). At
// that size the device time is a few microseconds of launch and the host's
// submission sets the rate of back-to-back calls, so the wrapper's host
// path (kernels/_launch.py) matters more than this body. One warp copies
// one output row of W floats:
//   axis 0  the row is a whole input row: 16-byte vectors when W % 4 == 0
//           and both planes are 16-byte aligned, else scalars;
//   axis 1  the row is two contiguous runs of its input row, split at the
//           seam c = shift: each aligned group of 4 outputs is one 16-byte
//           store, read as one 16-byte load where its 4 sources are
//           contiguous and aligned, as 4 scalar loads at the seam or where
//           the shift is not a multiple of 4.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per output row

__global__ void __launch_bounds__(kThreads)
roll_kernel(const float* __restrict__ x, const int* __restrict__ shift,
            float* __restrict__ out, long long rows, int h, int w, int axis,
            int vec) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock
                        + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int len = axis == 0 ? h : w;
  int s = __ldg(shift) % len;          // C remainder keeps the sign ...
  if (s < 0) s += len;                 // ... so fold negatives to [0, len)
  float* dst = out + row * w;
  if (axis == 0) {
    const int r = static_cast<int>(row % h);
    int src_r = r - s;
    if (src_r < 0) src_r += h;
    const float* src = x + (row - r + src_r) * w;
    if (vec) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int c = lane; c < w / 4; c += 32) dst4[c] = __ldg(src4 + c);
    } else {
      for (int c = lane; c < w; c += 32) dst[c] = __ldg(src + c);
    }
    return;
  }
  const float* src = x + row * w;
  if (vec) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int g = lane; g < w / 4; g += 32) {
      const int c = g * 4;
      int sc = c - s;                  // source of output c
      if (sc < 0) sc += w;
      float4 v;
      if ((sc & 3) == 0 && (c + 3 < s || c >= s)) {  // one run, aligned
        v = __ldg(reinterpret_cast<const float4*>(src + sc));
      } else {                                       // the seam, or unaligned
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int si = sc + i;
          if (si >= w) si -= w;
          e[i] = __ldg(src + si);
        }
        v = make_float4(e[0], e[1], e[2], e[3]);
      }
      dst4[g] = v;
    }
  } else {
    for (int c = lane; c < w; c += 32) {
      int sc = c - s;
      if (sc < 0) sc += w;
      dst[c] = __ldg(src + sc);
    }
  }
}

}  // namespace

// One launch of T2. args: 8 slots of 64 bits (kernels/_launch.py): x, shift,
// out, n, h, w, axis, stream; out [n, h, w] = x rolled along axis 0 or 1 by
// *shift. Returns the cudaError_t of the launch (0 = success).
extern "C" int vq_roll(const int64_t* args) {
  int64_t a[8];
  memcpy(a, args, sizeof a);
  const float* x = reinterpret_cast<const float*>(a[0]);
  const int* shift = reinterpret_cast<const int*>(a[1]);
  float* out = reinterpret_cast<float*>(a[2]);
  const int h = static_cast<int>(a[4]), w = static_cast<int>(a[5]);
  const long long rows = a[3] * h;
  if (rows == 0 || w == 0) return 0;
  const int vec = w % 4 == 0
      && ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  roll_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                reinterpret_cast<cudaStream_t>(a[7])>>>(x, shift, out, rows, h, w,
                                                        static_cast<int>(a[6]), vec);
  return static_cast<int>(cudaGetLastError());
}
