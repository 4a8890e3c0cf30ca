// N1: a residual add and the next LayerNorm in one pass over TimeSformer's
// token rows, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its LayerNorms and adds to
// XLA. It was added for TimeSformer's divided space-time blocks
// (videoquery_torch/nn/timesformer.py), whose residual adds, LayerNorms and
// the space step's [CLS; patches] concatenation ran as some five passes
// over each step's tokens, two of them on PyTorch's strided elementwise
// path, where one read of x and the step's output and one write of x and
// of the LayerNorm's output are compulsory.
//
// x [B, 1 + N T, D] is the residual stream, its patch rows in (n, t) order
// (n a patch site, t a frame), updated in place; z is the next LayerNorm's
// output, written in the row order the next step's GEMM reads. Three
// layouts, named after the step whose output `delta` is added:
//   time:  x[b, 1 + n T + t] += delta[(b N + n) T + t] (no add when delta is
//          null); z [B T, 1 + N, D]: row (b, t, 0) the LayerNorm of x's CLS
//          row (the same for every t), row (b, t, 1 + n) that of x's row
//          (b, 1 + n T + t);
//   space: x[b, 1 + n T + t] += delta[(b T + t)(1 + N) + 1 + n]; x[b, 0] +=
//          the mean over t of delta[(b T + t)(1 + N)], summed in float32 in
//          a fixed order and rounded to x's type once; z [B, 1 + N T, D] in
//          token order;
//   mlp:   x += delta row for row; z [B, N T, D], the patch rows.
// Each sum is float32(x) + float32(delta) rounded once to x's type (as
// PyTorch's add_). LayerNorm: mean and variance in float32 from the rounded
// new row, two passes over registers, rstd = rsqrtf(var + eps), then
// fmaf(gamma, rstd (x - mean), beta) in float32 rounded once (the
// expression of PyTorch's vectorized_layer_norm_kernel). bf16 or f32;
// gamma and beta in x's type.
//
// Bound: device-memory bytes (a few operations a byte). TimeSformer-L's
// batch of 8 moves ~926 MB a call in bf16 (x and delta read, x and z
// written), 32.4 GB over the 35 calls of a forward: 9.67 ms at 3.35 TB/s.
// The design keeps every byte moving at full width:
//   - a warp owns a row (768 bf16 values are 96 16-byte vectors, three a
//     lane; six at f32), so x and delta stay in registers and the two-pass
//     statistics are exact from them; each load and store is 16 bytes,
//     coalesced within its row, whatever the permutation (a row is 1.5 KB
//     of contiguous memory in every layout, so no gather tensor exists:
//     each warp computes its rows' places from (b, n, t));
//   - persistent blocks, as many as the SMs hold at once, walk the rows, a
//     row a warp at a time, so many rows' loads are in flight on each SM
//     while other warps reduce theirs (two rows a warp at once measured no
//     faster on an H100: 11.73 against 11.65 ms for a batch's 35 calls);
//     gamma and beta are staged in shared memory once a block;
//   - after a space step the 8 CLS rows each need the mean of 96 rows of
//     delta: the first B blocks take one CLS row each, their warps summing
//     every 8th frame row and the 8 partial sums added in warp order, so
//     the sum is deterministic; those blocks start first and are not the
//     stragglers.
//
// Offsets: rows as 32-bit indices (the wrapper checks B (1 + N T) < 2^31),
// elements 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVpl = 8;                         // 16-byte vectors a lane: rows of 4 KB

enum Layout { kTime = 0, kSpace = 1, kMlp = 2 };

struct Args {
  uint4* x;
  const uint4* delta;                              // null: no add (time layout only)
  const uint4* gamma;
  const uint4* beta;
  uint4* z;
  int b, n, t, d, vecs;                            // vecs: 16-byte vectors a row
  float eps;
  Layout layout;
  int rows;                                        // the rows the warps walk
};

// one row of the pass: x's row (read, and written when add), delta's row
// (-1: no add) and z's row (-1: no LayerNorm)
struct Task {
  int x, delta, z;
};

__device__ __forceinline__ Task task_of(int i, const Args& a) {
  const int nt = a.n * a.t, s = 1 + nt;
  Task k;
  if (a.layout == kTime) {
    const int cls = a.b * a.t;                     // first: z's CLS rows
    if (i < cls) {
      const int b = i / a.t, t = i - b * a.t;
      k.x = b * s;
      k.delta = -1;
      k.z = (b * a.t + t) * (1 + a.n);
      return k;
    }
    const int j = i - cls, b = j / nt, r = j - b * nt, n = r / a.t, t = r - n * a.t;
    k.x = b * s + 1 + r;
    k.delta = a.delta ? j : -1;
    k.z = (b * a.t + t) * (1 + a.n) + 1 + n;
  } else if (a.layout == kSpace) {
    const int b = i / nt, r = i - b * nt, n = r / a.t, t = r - n * a.t;
    k.x = b * s + 1 + r;
    k.delta = (b * a.t + t) * (1 + a.n) + 1 + n;
    k.z = k.x;
  } else {
    const int b = i / s, token = i - b * s;
    k.x = i;
    k.delta = i;
    k.z = token ? b * nt + token - 1 : -1;
  }
  return k;
}

template <bool kBf16>
struct Elems {
  static constexpr int kN = kBf16 ? 8 : 4;         // values a 16-byte vector
};

template <bool kBf16>
__device__ __forceinline__ void unpack(const uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kBf16) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    } else {
      f[j] = __uint_as_float(w[j]);
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kBf16) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
      memcpy(&w[j], &h, 4);
    } else {
      w[j] = __float_as_uint(f[j]);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// v rounded to the working type, as float
template <bool kBf16>
__device__ __forceinline__ float rounded(const float v) {
  if constexpr (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ float warp_sum(float s) {
  // a butterfly: every lane ends with the same bits (each step adds a pair
  // in both orders, and a float sum of two commutes)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
  return s;
}

// The LayerNorm of a row held by a warp, f the lane's values of it (its
// vectors lane, lane + 32, ...), written to z's row zr (-1: none).
template <bool kBf16, int kVpl>
__device__ __forceinline__ void norm_row(const float (&f)[kVpl * Elems<kBf16>::kN],
                                         const int zr, const uint4* gb, const Args& a) {
  constexpr int E = Elems<kBf16>::kN;
  const int lane = threadIdx.x & 31;
  float mean = 0.0f, var = 0.0f;
#pragma unroll
  for (int k = 0; k < kVpl; ++k) {
    if (k * 32 + lane >= a.vecs) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) mean += f[k * E + e];
  }
  mean = warp_sum(mean) / static_cast<float>(a.d);
#pragma unroll
  for (int k = 0; k < kVpl; ++k) {
    if (k * 32 + lane >= a.vecs) continue;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float c = f[k * E + e] - mean;
      var += c * c;
    }
  }
  var = warp_sum(var);
  if (zr < 0) return;
  const float rstd = rsqrtf(var / static_cast<float>(a.d) + a.eps);
  uint4* zrow = a.z + static_cast<long long>(zr) * a.vecs;
#pragma unroll
  for (int k = 0; k < kVpl; ++k) {
    const int v = k * 32 + lane;
    if (v >= a.vecs) continue;
    float g[E], be[E], out[E];
    unpack<kBf16>(gb[v], g);
    unpack<kBf16>(gb[a.vecs + v], be);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = fmaf(g[e], rstd * (f[k * E + e] - mean), be[e]);
    zrow[v] = pack<kBf16>(out);
  }
}

// After a space step: CLS row b of x gains the frame mean of delta's rows
// (b, t, 0), and its LayerNorm goes to z's row (b, 0). One block: warp w
// sums frames w, w + 8, ...; the partial sums are added in warp order.
template <bool kBf16, int kVpl>
__device__ void space_cls_row(const int b, const uint4* gb, const Args& a) {
  constexpr int E = Elems<kBf16>::kN;
  __shared__ float total[kVpl * 32 * E];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kVpl * E];
#pragma unroll
  for (int q = 0; q < kVpl * E; ++q) acc[q] = 0.0f;
  for (int t = warp; t < a.t; t += kWarps) {
    const uint4* row = a.delta + static_cast<long long>((b * a.t + t) * (1 + a.n)) * a.vecs;
#pragma unroll
    for (int k = 0; k < kVpl; ++k) {
      const int v = k * 32 + lane;
      if (v >= a.vecs) continue;
      float f[E];
      unpack<kBf16>(__ldg(row + v), f);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[k * E + e] += f[e];
    }
  }
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < kVpl; ++k) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float& s = total[(k * 32 + lane) * E + e];
          s = w == 0 ? acc[k * E + e] : s + acc[k * E + e];
        }
      }
    }
    __syncthreads();
  }
  if (warp != 0) return;
  // the mean rounded to the working type, then added and rounded again
  const float inv_t = 1.0f / static_cast<float>(a.t);
  uint4* xrow = a.x + static_cast<long long>(b) * (1 + a.n * a.t) * a.vecs;
  float f[kVpl * E];
#pragma unroll
  for (int k = 0; k < kVpl; ++k) {
    const int v = k * 32 + lane;
    if (v >= a.vecs) continue;
    float xv[E];
    unpack<kBf16>(xrow[v], xv);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float mean = rounded<kBf16>(total[(k * 32 + lane) * E + e] * inv_t);
      f[k * E + e] = rounded<kBf16>(xv[e] + mean);
    }
    xrow[v] = pack<kBf16>(&f[k * E]);
  }
  norm_row<kBf16, kVpl>(f, b * (1 + a.n * a.t), gb, a);
}

template <bool kBf16, int kVpl>
__global__ void __launch_bounds__(kThreads) add_norm_kernel(const Args a) {
  constexpr int E = Elems<kBf16>::kN;
  __shared__ uint4 gb[2 * kVpl * 32];              // gamma's vectors, then beta's
  for (int v = threadIdx.x; v < a.vecs; v += kThreads) {
    gb[v] = __ldg(a.gamma + v);
    gb[a.vecs + v] = __ldg(a.beta + v);
  }
  __syncthreads();
  int block = blockIdx.x, blocks = gridDim.x;
  if (a.layout == kSpace) {
    if (block < a.b) {
      space_cls_row<kBf16, kVpl>(block, gb, a);
      return;
    }
    block -= a.b;
    blocks -= a.b;
  }
  const int lane = threadIdx.x & 31;
  for (int i = block * kWarps + (threadIdx.x >> 5); i < a.rows; i += blocks * kWarps) {
    const Task k = task_of(i, a);
    uint4 xv[kVpl], dv[kVpl];
#pragma unroll
    for (int q = 0; q < kVpl; ++q) {
      const int v = q * 32 + lane;
      xv[q] = dv[q] = make_uint4(0, 0, 0, 0);
      if (v >= a.vecs) continue;
      xv[q] = a.x[static_cast<long long>(k.x) * a.vecs + v];
      if (k.delta >= 0) dv[q] = __ldg(a.delta + static_cast<long long>(k.delta) * a.vecs + v);
    }
    float f[kVpl * E];
#pragma unroll
    for (int q = 0; q < kVpl; ++q) {
      unpack<kBf16>(xv[q], &f[q * E]);
      if (k.delta < 0) continue;
      float dd[E];
      unpack<kBf16>(dv[q], dd);
#pragma unroll
      for (int e = 0; e < E; ++e) f[q * E + e] = rounded<kBf16>(f[q * E + e] + dd[e]);
      const int v = q * 32 + lane;
      if (v < a.vecs) a.x[static_cast<long long>(k.x) * a.vecs + v] = pack<kBf16>(&f[q * E]);
    }
    norm_row<kBf16, kVpl>(f, k.z, gb, a);
  }
}

template <bool kBf16, int kVpl>
int launch(const Args& a, cudaStream_t stream) {
  // blocks an SM holds at once: asked once a process
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, add_norm_kernel<kBf16, kVpl>,
                                                      kThreads, 0) != cudaSuccess)
      n = 1;
    return n > 0 ? n : 1;
  }();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (a.rows + kWarps - 1) / kWarps;
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (need < blocks) blocks = need;
  if (blocks < 1) blocks = 1;
  if (a.layout == kSpace) blocks += a.b;           // the CLS rows' blocks, first
  add_norm_kernel<kBf16, kVpl><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instance whose lanes hold a row: 16-byte vectors a lane, rounded up
template <bool kBf16>
int launch_width(const Args& a, cudaStream_t stream) {
  const int vpl = (a.vecs + 31) / 32;
  if (vpl <= 1) return launch<kBf16, 1>(a, stream);
  if (vpl <= 2) return launch<kBf16, 2>(a, stream);
  if (vpl <= 3) return launch<kBf16, 3>(a, stream);
  if (vpl <= 4) return launch<kBf16, 4>(a, stream);
  if (vpl <= 6) return launch<kBf16, 6>(a, stream);
  return launch<kBf16, kMaxVpl>(a, stream);
}

}  // namespace

// One launch of N1. args: 13 slots of 64 bits (kernels/_launch.py): x,
// delta (0: no add; time layout only), gamma, beta, z, b, n, t, d, layout
// (0 time, 1 space, 2 mlp), bf16, eps (its float32 bits), stream. x [b, 1 +
// n t, d] and delta, gamma, beta and z as the note above lays them out, all
// contiguous and 16-byte aligned, d times the element size a multiple of 16
// bytes and at most 4 KB, b (1 + n t) < 2^31. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int vq_add_norm(const int64_t* args) {
  int64_t v[13];
  memcpy(v, args, sizeof v);
  Args a;
  a.x = reinterpret_cast<uint4*>(v[0]);
  a.delta = reinterpret_cast<const uint4*>(v[1]);
  a.gamma = reinterpret_cast<const uint4*>(v[2]);
  a.beta = reinterpret_cast<const uint4*>(v[3]);
  a.z = reinterpret_cast<uint4*>(v[4]);
  a.b = static_cast<int>(v[5]);
  a.n = static_cast<int>(v[6]);
  a.t = static_cast<int>(v[7]);
  a.d = static_cast<int>(v[8]);
  const int layout = static_cast<int>(v[9]);
  const bool bf16 = v[10] != 0;
  const uint32_t eps_bits = static_cast<uint32_t>(v[11]);
  memcpy(&a.eps, &eps_bits, 4);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(v[12]);
  a.vecs = a.d * (bf16 ? 2 : 4) / 16;
  if (layout < kTime || layout > kMlp || a.b < 0 || a.n < 1 || a.t < 1 || a.vecs < 1 ||
      a.vecs > kMaxVpl * 32 || (a.delta == nullptr && layout != kTime))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.b == 0) return 0;
  a.layout = static_cast<Layout>(layout);
  const int nt = a.n * a.t;
  a.rows = layout == kTime ? a.b * a.t + a.b * nt : layout == kSpace ? a.b * nt : a.b * (1 + nt);
  return bf16 ? launch_width<true>(a, stream) : launch_width<false>(a, stream);
}
