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
// (2 x 80 x 256 x 4 bytes for the repro's tile): at that size the launch
// latency, not the 3.35 TB/s, sets the time. One thread per output element;
// neighbouring threads read and write neighbouring addresses except at the
// wrap of a row (axis 1).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
roll_kernel(const float* __restrict__ x, const int* __restrict__ shift,
            float* __restrict__ out, int n, int h, int w, int axis) {
  const long long total = (long long)n * h * w;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int len = axis == 0 ? h : w;
  int s = __ldg(shift) % len;          // C remainder keeps the sign ...
  if (s < 0) s += len;                 // ... so fold negatives to [0, len)
  const int col = (int)(idx % w);
  const int row = (int)((idx / w) % h);
  const long long plane = idx - (long long)row * w - col;
  int src_row = row, src_col = col;
  if (axis == 0) {
    src_row = row - s;
    if (src_row < 0) src_row += h;
  } else {
    src_col = col - s;
    if (src_col < 0) src_col += w;
  }
  out[idx] = x[plane + (long long)src_row * w + src_col];
}

}  // namespace

extern "C" int vq_roll(const float* x, const int* shift, float* out, int n,
                       int h, int w, int axis, void* stream) {
  const long long total = (long long)n * h * w;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  roll_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, shift, out, n, h, w, axis);
  return (int)cudaGetLastError();
}
