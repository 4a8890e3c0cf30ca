// T1: one stride-1 BN-Inception block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tools/inception_pallas.py::_block_kernel (entry
// fused_inception). For NHWC x [N, H, W, Cin] and K ensemble members it
// writes out [K, N, H, W, Cout], the concat of four branches:
//   1x1                       -> channels [0, c1)
//   1x1 r3, then 3x3 c3        -> [c1, c1 + c3)
//   1x1 rd, then 3x3 d1, 3x3 d2 -> [c1 + c3, c1 + c3 + d2)
//   3x3 AVE or MAX pool, 1x1 pp -> the last pp channels
// Every conv is relu(sum + bias) with the sum in f32 and the result cast to
// the activation type (f32 or bf16). The intermediates r3, rd and d1 are
// rounded to the activation type after ReLU, as the TPU kernel rounds them.
//
// Design. The TPU kernel keeps g whole zero-padded images in ~100 MB of
// VMEM; a Hopper block has 227 KB of shared memory, less than one padded
// 28x28x256 bf16 image. So the block runs as five launches of one implicit
// GEMM kernel inside this one C call (as K2 runs a level), with the reduce
// outputs in device-memory scratch:
//   1. x -> [c1 | r3 | rd]: the three 1x1 convs that read x as ONE GEMM
//      over the concatenated weights; columns [0, c1) go to the output,
//      the rest to the scratch `red` [K, P, r3 + rd] (P = N*H*W pixels);
//   2. red[:, :, :r3] -> c3 (3x3) into the output;
//   3. red[:, :, r3:] -> d1 (3x3) into the scratch `dd1` [K, P, d1];
//   4. dd1 -> d2 (3x3) into the output;
//   5. pool(x) -> pp (1x1) into the output: the pool is computed while the
//      A tile is loaded (f32 sum in window order, /9, cast; or max).
// Each launch writes its own channel slice of the NHWC output, so there is
// no concat pass. x is shared by the members (grid z = member); weights,
// scratch and output are strided by member.
//
// The GEMM: rows are output pixels, columns output channels, the depth is
// taps x input channels (tap-major, the HWIO order of the weights, which the
// wrapper lays out as [cout][taps * cin]). The 9 shifted-tap matmuls of the
// TPU kernel (a Mosaic limit) become this one implicit GEMM: the A loader
// maps depth index k to (tap, channel) and reads the shifted pixel, or zero
// outside the image (the conv's zero padding). A block computes a 128-pixel
// x 64-channel tile in 32-deep steps; the next step's operands are loaded
// into registers while the current step is multiplied.
//   bf16: mma.sync m16n8k16 with f32 accumulation (a bf16 product is exact
//         in f32); 8 warps, each a 32 x 32 tile.
//   f32:  explicit fmaf on the CUDA cores (no TF32 anywhere), each thread
//         an 8 x 4 tile.
// Zero padding stands in for -inf in the MAX pool because a block's input
// is a concat of ReLU outputs and pools of them (>= 0): the wrapper states
// the precondition.
//
// Bound: tensor-core operations. At 3 members x 200 images in bf16 the 8
// stride-1 blocks do 1.49 TFLOP against 1.63 GB of compulsory bytes (x read
// once, the output written once), ~900 FLOP per byte, far above the card's
// ~295 FLOP/byte ridge: 1.51 ms at 989 TFLOP/s. This first kernel has no TMA, no wgmma and no
// cp.async pipeline; the scratch round trip and the 4-fold re-read of x
// (launches 1 and 5, and per column tile) are the fused design's later work.
//
// Build with --fmad=false and without fast math: the bias add, the pool's
// sum and /9 are rounded as written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 32;        // depth per step
constexpr int kThreads = 256;

enum Mode { kConv1x1 = 0, kConv3x3 = 1, kPoolAve = 2, kPoolMax = 3 };

struct ConvArgs {
  const void* in;           // activations, [.., P, in_ld], channels at in_off
  long long in_member;      // elements between members (0: shared input)
  int in_ld, in_off, cin;
  const void* wgt;          // [cout][depth] per member
  long long w_member;
  const float* b;           // [cout] per member
  long long b_member;
  int cout;
  int split;                // columns [0, split) -> dst0, the rest -> dst1
  void* dst0;
  long long dst0_member;
  int ld0, off0;
  void* dst1;
  long long dst1_member;
  int ld1, off1;
  int n, h, w;
};

// Shared-memory row strides (elements): bf16 rows of 80 bytes keep the
// fragment reads conflict-free and 16-byte aligned; f32 rows of 33 floats.
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> { static constexpr int ld = kBK + 8; };
template <> struct Tile<float> { static constexpr int ld = kBK + 1; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements (16-byte aligned for bf16, 32 for f32).
template <typename T> struct __align__(16) Vec8 { T v[8]; };

__device__ __forceinline__ void load8(const __nv_bfloat16* p, Vec8<__nv_bfloat16>& r) {
  *reinterpret_cast<uint4*>(r.v) = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load8(const float* p, Vec8<float>& r) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  r.v[0] = a.x; r.v[1] = a.y; r.v[2] = a.z; r.v[3] = a.w;
  r.v[4] = b.x; r.v[5] = b.y; r.v[6] = b.z; r.v[7] = b.w;
}
template <typename T> __device__ __forceinline__ void zero8(Vec8<T>& r) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = from_f<T>(0.0f);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output value pair (columns col, col + 1) of pixel p to its segment.
template <typename T>
__device__ __forceinline__ void store2(const ConvArgs& a, int member, long long p,
                                       int col, float v0, float v1) {
  T* dst;
  if (col < a.split) {
    dst = static_cast<T*>(a.dst0) + member * a.dst0_member + p * a.ld0 + a.off0 + col;
  } else {
    dst = static_cast<T*>(a.dst1) + member * a.dst1_member + p * a.ld1 + a.off1
        + (col - a.split);
  }
  dst[0] = from_f<T>(v0);
  dst[1] = from_f<T>(v1);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
inception_conv_kernel(const ConvArgs a) {
  constexpr int LD = Tile<T>::ld;
  __shared__ __align__(16) unsigned char smem[(kBM + kBN) * LD * sizeof(T)];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + kBM * LD;

  const int tid = threadIdx.x;
  const int member = blockIdx.z;
  const long long P = (long long)a.n * a.h * a.w;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int taps = MODE == kConv3x3 ? 9 : 1;
  const int depth = taps * a.cin;

  const T* in = static_cast<const T*>(a.in) + member * a.in_member;
  const T* wt = static_cast<const T*>(a.wgt) + member * a.w_member;
  const float* bias = a.b + member * a.b_member;

  // This thread loads rows ra[i] = tid / 4 + 64 i of the A tile and row
  // tid / 4 of the B tile, 8 depth values at column (tid % 4) * 8.
  const int kv = (tid & 3) * 8;
  int img[2], py[2], px[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long p = m0 + (tid >> 2) + 64 * i;
    live[i] = p < P;
    const long long q = live[i] ? p : 0;
    img[i] = (int)(q / ((long long)a.h * a.w));
    const int rem = (int)(q - (long long)img[i] * a.h * a.w);
    py[i] = rem / a.w;
    px[i] = rem - py[i] * a.w;
  }
  const int bcol = n0 + (tid >> 2);

  Vec8<T> ra[2], rb;
  auto load_tiles = [&](int k0) {
    const int k = k0 + kv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      zero8(ra[i]);
      if (!live[i] || k >= depth) continue;
      if (MODE == kConv1x1) {
        const long long pix = ((long long)img[i] * a.h + py[i]) * a.w + px[i];
        load8(in + pix * a.in_ld + a.in_off + k, ra[i]);
      } else if (MODE == kConv3x3) {
        const int tap = k / a.cin;
        const int c = k - tap * a.cin;
        const int yy = py[i] + tap / 3 - 1, xx = px[i] + tap % 3 - 1;
        if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
          const long long pix = ((long long)img[i] * a.h + yy) * a.w + xx;
          load8(in + pix * a.in_ld + a.in_off + c, ra[i]);
        }
      } else {
        // the 3x3 pool of x at this pixel, window in row-major order with
        // zeros outside the image: an f32 sum then /9, or a max
        float acc[8];
        Vec8<T> s;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int yy = py[i] + t / 3 - 1, xx = px[i] + t % 3 - 1;
          zero8(s);
          if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
            const long long pix = ((long long)img[i] * a.h + yy) * a.w + xx;
            load8(in + pix * a.in_ld + a.in_off + k, s);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float v = to_f(s.v[e]);
            if (t == 0) acc[e] = v;
            else if (MODE == kPoolAve) acc[e] = acc[e] + v;
            else acc[e] = fmaxf(acc[e], v);
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          ra[i].v[e] = from_f<T>(MODE == kPoolAve ? acc[e] / 9.0f : acc[e]);
      }
    }
    zero8(rb);
    if (bcol < a.cout && k < depth) load8(wt + (long long)bcol * depth + k, rb);
  };
  auto store8 = [](T* dst, const Vec8<T>& r) {
    if constexpr (sizeof(T) == 2) {   // 80-byte rows: 16-byte aligned
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(r.v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = r.v[e];
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) store8(As + ((tid >> 2) + 64 * i) * LD + kv, ra[i]);
    store8(Bs + (tid >> 2) * LD + kv, rb);
  };

  if constexpr (sizeof(T) == 2) {
    // 8 warps as 4 (rows) x 2 (columns), each a 32 x 32 tile of m16n8k16
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
    const int g = lane >> 2, tg = lane & 3;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

    load_tiles(0);
    for (int k0 = 0; k0 < depth; k0 += kBK) {
      store_tiles();
      __syncthreads();
      if (k0 + kBK < depth) load_tiles(k0 + kBK);
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const T* r0 = As + (wm + mi * 16 + g) * LD + ks + 2 * tg;
          const T* r1 = r0 + 8 * LD;
          af[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
          af[mi][1] = *reinterpret_cast<const uint32_t*>(r1);
          af[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
          af[mi][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const T* c0 = Bs + (wn + ni * 8 + g) * LD + ks + 2 * tg;
          bf[ni][0] = *reinterpret_cast<const uint32_t*>(c0);
          bf[ni][1] = *reinterpret_cast<const uint32_t*>(c0 + 8);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long p = m0 + wm + mi * 16 + g + 8 * half;
        if (p >= P) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + wn + ni * 8 + 2 * tg;
          if (col >= a.cout) continue;
          const float v0 = fmaxf(acc[mi][ni][2 * half] + bias[col], 0.0f);
          const float v1 = fmaxf(acc[mi][ni][2 * half + 1] + bias[col + 1], 0.0f);
          store2<T>(a, member, p, col, v0, v1);
        }
      }
  } else {
    // f32: thread (tm, tn) owns rows tm*8 .. +8 and columns tn*4 .. +4
    const int tm = tid >> 4, tn = tid & 15;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    load_tiles(0);
    for (int k0 = 0; k0 < depth; k0 += kBK) {
      store_tiles();
      __syncthreads();
      if (k0 + kBK < depth) load_tiles(k0 + kBK);
#pragma unroll 4
      for (int k = 0; k < kBK; ++k) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(As[(tm * 8 + i) * LD + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = to_f(Bs[(tn * 4 + j) * LD + k]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long p = m0 + tm * 8 + i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int col = n0 + tn * 4 + j;
        if (col >= a.cout) continue;
        const float v0 = fmaxf(acc[i][j] + bias[col], 0.0f);
        const float v1 = fmaxf(acc[i][j + 1] + bias[col + 1], 0.0f);
        store2<T>(a, member, p, col, v0, v1);
      }
    }
  }
}

template <typename T, int MODE>
int launch(const ConvArgs& a, int members, cudaStream_t stream) {
  const long long P = (long long)a.n * a.h * a.w;
  const dim3 grid((unsigned)((P + kBM - 1) / kBM), (unsigned)((a.cout + kBN - 1) / kBN),
                  (unsigned)members);
  inception_conv_kernel<T, MODE><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

ConvArgs conv(const void* in, long long in_member, int in_ld, int in_off, int cin,
              const void* w, const float* b, int cout, void* dst, long long dst_member,
              int ld, int off, int n, int h, int wd, int taps) {
  ConvArgs a{};
  a.in = in; a.in_member = in_member; a.in_ld = in_ld; a.in_off = in_off; a.cin = cin;
  a.wgt = w; a.w_member = (long long)cout * taps * cin;
  a.b = b; a.b_member = cout;
  a.cout = cout; a.split = cout;
  a.dst0 = dst; a.dst0_member = dst_member; a.ld0 = ld; a.off0 = off;
  a.dst1 = dst; a.dst1_member = dst_member; a.ld1 = ld; a.off1 = off;
  a.n = n; a.h = h; a.w = wd;
  return a;
}

template <typename T>
int run_block(const void* x, int n, int h, int w, int cin, int members, int c1,
              int r3, int c3, int rd, int d1, int d2, int pp, int pool_max,
              const void* w1, const float* b1, const void* w3, const float* b3,
              const void* wd1, const float* bd1, const void* wd2, const float* bd2,
              const void* wpp, const float* bpp, void* red, void* dd1, void* out,
              cudaStream_t stream) {
  const long long P = (long long)n * h * w;
  const int cout = c1 + c3 + d2 + pp;
  const int nred = r3 + rd;
  int err;
  // 1. x -> [c1 | r3 | rd]: c1 into the output, r3 and rd into `red`
  ConvArgs a = conv(x, 0, cin, 0, cin, w1, b1, c1 + nred, out, P * cout, cout, 0,
                    n, h, w, 1);
  a.split = c1;
  a.dst1 = red; a.dst1_member = P * nred; a.ld1 = nred; a.off1 = 0;
  if ((err = launch<T, kConv1x1>(a, members, stream))) return err;
  // 2. 3x3 r3 -> c3 into the output
  a = conv(red, P * nred, nred, 0, r3, w3, b3, c3, out, P * cout, cout, c1, n, h, w, 9);
  if ((err = launch<T, kConv3x3>(a, members, stream))) return err;
  // 3. 3x3 rd -> d1 into `dd1`
  a = conv(red, P * nred, nred, r3, rd, wd1, bd1, d1, dd1, P * d1, d1, 0, n, h, w, 9);
  if ((err = launch<T, kConv3x3>(a, members, stream))) return err;
  // 4. 3x3 d1 -> d2 into the output
  a = conv(dd1, P * d1, d1, 0, d1, wd2, bd2, d2, out, P * cout, cout, c1 + c3, n, h, w, 9);
  if ((err = launch<T, kConv3x3>(a, members, stream))) return err;
  // 5. pool(x) -> pp into the output
  a = conv(x, 0, cin, 0, cin, wpp, bpp, pp, out, P * cout, cout, c1 + c3 + d2, n, h, w, 1);
  return pool_max ? launch<T, kPoolMax>(a, members, stream)
                  : launch<T, kPoolAve>(a, members, stream);
}

}  // namespace

// x [N, H, W, cin] (shared by the members); weights [members][cout][taps*cin]
// and f32 biases [members][cout]; scratch red [members, P, r3 + rd] and dd1
// [members, P, d1]; out [members, N, H, W, c1 + c3 + d2 + pp]. Every channel
// count is a multiple of 8 and every pointer 16-byte aligned (the wrapper
// checks). bf16 != 0 selects bfloat16 activations and weights, else f32.
extern "C" int vq_inception_block(
    const void* x, int bf16, int n, int h, int w, int cin, int members, int c1,
    int r3, int c3, int rd, int d1, int d2, int pp, int pool_max,
    const void* w1, const float* b1, const void* w3, const float* b3,
    const void* wd1, const float* bd1, const void* wd2, const float* bd2,
    const void* wpp, const float* bpp, void* red, void* dd1, void* out, void* stream) {
  if ((long long)n * h * w == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return run_block<__nv_bfloat16>(x, n, h, w, cin, members, c1, r3, c3, rd, d1, d2,
                                    pp, pool_max, w1, b1, w3, b3, wd1, bd1, wd2, bd2,
                                    wpp, bpp, red, dd1, out, s);
  return run_block<float>(x, n, h, w, cin, members, c1, r3, c3, rd, d1, d2, pp,
                          pool_max, w1, b1, w3, b3, wd1, bd1, wd2, bd2, wpp, bpp,
                          red, dd1, out, s);
}
