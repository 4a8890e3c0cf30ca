// S1: I3D's stem conv, Conv3d_1a_7x7, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no I3D. It was added for the
// first conv of I3D (videoquery_torch/nn/i3d.py), which ran as cuDNN's sm80
// implicit GEMM on a 2x2x2 space-to-depth copy of a SAME-padded copy of the
// clip, with the 7x7x7 kernel zero-padded to 8x8x8 (1.49x the products).
//
// y[n, ot, oh, ow, co] = relu(b[co] + sum over (kt, kh, kw, c) of
//   x[n, 2 ot - pt + kt, 2 oh - ph + kh, 2 ow - pw + kw, c] * w[co, c, kt, kh, kw])
// for x [N, T, H, W, C] bf16 (C = 3 rgb or 2 flow), 64 output channels,
// stride 2, TensorFlow SAME padding (ceil(n / 2) outputs an axis, the
// padded cells split with the odd one at the end; cells past the input are
// zero). Products of bf16 in f32 sums, the f32 bias added, ReLU, one
// rounding to bf16; y is [N, To, Ho, Wo, 64] (channels-last-3d).
//
// Bound: tensor-core operations. At the I3D cell's shapes (8 volumes of
// 250 frames at 224 x 224) the rgb stem does 1.652 TFLOP against 2.2 GB
// of compulsory bytes (the clip read once, the output written once), ~750
// operations a byte, and the flow stem ~550, against the card's ~295 a
// byte: 1.67 + 1.11 ms at 989 TFLOP/s. So the design feeds the tensor
// cores:
//   - an implicit GEMM on wgmma m64n64k16 (bf16, f32 sums): M is the output
//     positions, N the 64 output channels in one tile, K the 343 taps x C,
//     ordered (kt; kh, kw, c) with each kh's 7 C values padded to 22 (rgb)
//     or 16 (flow) cells and each kt's K to a multiple of 16 (160 rgb, 112
//     flow): 8.8% (rgb) or 14% (flow) more products than the taps, where
//     the space-to-depth form had 49%;
//   - A from registers: a pixel is 6 or 4 bytes, so no descriptor can
//     address the im2col rows (core-matrix rows are 16 bytes apart). Each
//     thread loads its fragment pairs from frame rows staged in shared
//     memory with 4-byte loads (a pair never straddles a kh row: a row's
//     cells are even and start 4-byte aligned); its 20 (rgb) or 14 (flow) K
//     offsets are computed once. Flow's 16-cell rows keep each lane quad's
//     8 cells in one row, so its loads never conflict; rgb's 22 cost one
//     load in four a second shared-memory pass;
//   - B, the packed weights (kernels/stem_conv3d.py::pack_weight, 140 KB
//     rgb / 98 KB flow), is read once a block into shared memory in the
//     no-swizzle core-matrix layout and stays there;
//   - a block is persistent (one an SM): two consumer warpgroups and one
//     producer warpgroup, which hands its registers to the consumers
//     (setmaxnreg: 232 a consumer thread holds 128 accumulators, two
//     fragment buffers, the K offsets). A tile is 512 consecutive output
//     positions of one (n, ot) plane, 256 a consumer warpgroup as 4 chunks
//     of 64 rows; a step is one kt of a tile, 10 (rgb) or 7 (flow) k16
//     steps of 4 wgmma a warpgroup, the next k16 step's fragments loaded
//     while the last one runs. The producer stages the input rows a step's
//     positions read at frame 2 ot - pt + kt (17 rows of a 224-wide frame)
//     with cp.async (16-byte pieces where a frame row is a multiple of 16
//     bytes, else 4) into a ring of 3 (or 2) stages, each with a full and an
//     empty mbarrier: no block-wide barrier in the loop, and a step's last
//     MMAs run on while the next step's fragments load;
//   - SAME's zeros are the staged rows' margins, written once a block, and
//     cp.async's zero fill for rows and frames past the input: no padded
//     copy exists in device memory;
//   - the epilogue adds the bias, applies ReLU and rounds each f32 sum once
//     in registers; a transpose inside each lane quad turns the
//     accumulators' channel pairs into 16-byte runs, so each position's 128
//     bytes leave in 8 full 16-byte stores.
// The zero-weight K cells (the padding above) meet real input cells, as
// the space-to-depth form's padded taps did: the input is finite.
//
// Offsets: 64-bit for frames and output planes, 32-bit inside a frame and
// in shared memory (the wrapper checks the sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kCout = 64;
constexpr int kTaps = 7;                            // the kernel's extent on each axis
constexpr int kWarpgroups = 2;                      // the consumers
constexpr int kChunks = 4;                          // 64-row chunks a warpgroup
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 128;          // and one producer warpgroup
// registers a thread: the producers give theirs up to the consumers
// (3 warps an SM sub-partition: 40 + 2 x 232 of 512)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 3;
constexpr int kTile = 64 * kChunks * kWarpgroups;   // output positions a tile: 512
constexpr int kLead = 8;                            // elements before a staged row's w = 0
constexpr int kStepBytes = kCout * 16 * 2;          // the weights of one k16 step: 2 KB
constexpr int kMaxSmem = 232448;

// A kt's K: 7 rows (kh) of kWindow cells, the 7 C values of a row padded
// to an even count, or to a multiple of 8 where that costs no k16 step (a
// row then never shares a lane quad's 8 cells with the next: no bank
// conflicts); the kt padded to a multiple of 16
constexpr int k16_steps(int window) { return (kTaps * window + 15) / 16; }
constexpr int even_window(int c) { return (kTaps * c + 1) & ~1; }
constexpr int window_of(int c) {
  return k16_steps((kTaps * c + 7) & ~7) == k16_steps(even_window(c)) ? (kTaps * c + 7) & ~7
                                                                       : even_window(c);
}

template <int C>
struct Geom {
  static constexpr int kWindow = window_of(C);           // 22 rgb, 16 flow
  static constexpr int kSteps = k16_steps(kWindow);      // k16 steps a kt: 10 or 7
  static constexpr int kWeightBytes = kTaps * kSteps * kStepBytes;
};

struct Params {
  const unsigned char* x;    // [n, t, h, w, c] bf16
  const unsigned char* wp;   // packed weights [kt][k16 step][8 n-groups][2 k-groups][8][8]
  const float* bias;         // [64]
  bf16* y;                   // [n, to, ho, wo, 64]
  int t, h, row_bytes;       // input frames, rows, bytes a row (w * c * 2)
  int to, ho, wo;            // output frames, rows, columns
  int pt, ph;                // SAME's cells before, t and h
  int lead;                  // elements from a staged row's start to ow = 0's window
  int rs;                    // bytes between staged rows
  int stage_rows, stages;
  int tiles_per_plane, tiles;
  int vec16;                 // rows staged in 16-byte pieces (else 4)
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// make the cp.async writes of the weights visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async MMAs
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory descriptor, no swizzle, K-major: core matrices of 8
// rows x 16 bytes; lbo the bytes between K-neighbour core matrices, sbo
// between 8-row groups
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
       | ((uint64_t)(sbo >> 4) << 32);
}

// D[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T, bf16 in, f32 sums; A from
// registers (thread lane of warp w: rows 16 w + lane / 4 and + 8, K pairs
// 2 (lane % 4) and + 8), B K-major in shared memory; scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Lane q of a quad holds row q of a 4 x 4 matrix of words (v0 .. v3);
// returns column q (row r's word in element r), in two exchanges
__device__ __forceinline__ uint4 quad_transpose(uint32_t v0, uint32_t v1, uint32_t v2,
                                                uint32_t v3, int q) {
  const bool hi = q & 2, odd = q & 1;
  // lanes q and q ^ 2 swap halves: q < 2 keeps columns 0-1, q >= 2 columns 2-3
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, hi ? v0 : v2, 2);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, hi ? v1 : v3, 2);
  const uint32_t n0 = hi ? r0 : v0, n1 = hi ? r1 : v1, n2 = hi ? v2 : r0, n3 = hi ? v3 : r1;
  // lanes q and q ^ 1 swap the other column of each pair
  r0 = __shfl_xor_sync(0xffffffffu, odd ? n0 : n1, 1);
  r1 = __shfl_xor_sync(0xffffffffu, odd ? n2 : n3, 1);
  return odd ? make_uint4(r0, n1, r1, n3) : make_uint4(n0, r0, n2, r1);
}

// A fragments of one k16 step for the warpgroup's 4 chunks: registers 0-1
// are rows quad and quad + 8 at K pair k0, registers 2-3 at K pair k1
__device__ __forceinline__ void load_frags(uint32_t (&dst)[kChunks][4], const unsigned char* stage,
                                           const uint32_t (&rb)[kChunks][2], uint32_t k0,
                                           uint32_t k1) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    dst[c][0] = *reinterpret_cast<const uint32_t*>(stage + rb[c][0] + k0);
    dst[c][1] = *reinterpret_cast<const uint32_t*>(stage + rb[c][1] + k0);
    dst[c][2] = *reinterpret_cast<const uint32_t*>(stage + rb[c][0] + k1);
    dst[c][3] = *reinterpret_cast<const uint32_t*>(stage + rb[c][1] + k1);
  }
}

// One tile of the launch: its output plane (n * to + ot), its first
// position in the plane, its first output row and the input rows it reads
// at one kt
struct Tile {
  int plane, m0, oh0, rows;
};

__device__ __forceinline__ Tile tile_at(const Params& p, int tile) {
  Tile tl;
  tl.plane = tile / p.tiles_per_plane;
  tl.m0 = (tile - tl.plane * p.tiles_per_plane) * kTile;
  tl.oh0 = tl.m0 / p.wo;
  const int last = min(tl.m0 + kTile, p.ho * p.wo) - 1;
  tl.rows = 2 * (last / p.wo - tl.oh0) + kTaps;
  return tl;
}

// One step's k16 steps for the warpgroup: A fragments from the staged rows,
// B from the resident weights, 4 chunks a k16 step. P is the register
// buffer of the step's first k16 step; k16 step s of the step uses buffer
// (P + s) % 2, so one group of the step before may still be in flight: its
// last k16 step's, in buffer 1 - P. The step ends with its last group in
// flight.
template <int C, int P>
__device__ __forceinline__ void mma_step(float (&acc)[kChunks][32], uint32_t (&a)[2][kChunks][4],
                                         const unsigned char* stage,
                                         const uint32_t (&rb)[kChunks][2],
                                         const uint32_t (&koff)[Geom<C>::kSteps][2],
                                         uint32_t weights, int kt, uint32_t empty) {
  typedef Geom<C> G;
  wgmma_wait<1>();            // buffer P is free
  load_frags(a[P], stage, rb, koff[0][0], koff[0][1]);
#pragma unroll
  for (int s = 0; s < G::kSteps; ++s) {
    wgmma_fence();
    const uint64_t db = smem_desc(weights + (kt * G::kSteps + s) * kStepBytes, 128, 256);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) wgmma_rs(acc[c], a[(P + s) & 1][c], db, (kt | s) != 0);
    wgmma_commit();
    if (s + 1 < G::kSteps) {
      wgmma_wait<1>();        // k16 step s - 1 is done with the other buffer
      load_frags(a[(P + s + 1) & 1], stage, rb, koff[s + 1][0], koff[s + 1][1]);
    }
    if (s + 2 == G::kSteps) {
      // the warp's last reads of the stage are done: hand it back
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1) stem_conv_kernel(const Params p) {
  typedef Geom<C> G;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const float* bias_s = reinterpret_cast<const float*>(smem + G::kWeightBytes);
  // the stages' full and empty barriers, then the ring
  const uint32_t full = sbase + G::kWeightBytes + kCout * 4;
  const uint32_t empty = full + 8 * kMaxStages;
  const int ring = G::kWeightBytes + kCout * 4 + 16 * kMaxStages;
  const int stage_bytes = p.stage_rows * p.rs;
  const int plane_len = p.ho * p.wo;
  const int steps = (int)((p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x) * kTaps;

  // the packed weights and the bias, once a block
  for (int i = tid; i < G::kWeightBytes / 16; i += kThreads)
    cp_async16(sbase + 16 * i, p.wp + 16 * i, true);
  cp_async_commit();
  if (tid < kCout) reinterpret_cast<float*>(smem + G::kWeightBytes)[tid] = p.bias[tid];
  // the ring zeroed: a staged row's margins (SAME's zeros) are never written again
  for (int i = tid; i < p.stages * stage_bytes / 16; i += kThreads)
    *reinterpret_cast<uint4*>(smem + ring + 16 * i) = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + 8 * i, kThreads - kConsumers);     // the producer's threads
      mbar_init(empty + 8 * i, kConsumers / 32);          // the consumers' warps
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int lane = tid & 31;
  if (tid >= kConsumers) {
    // the producers: step j of this block is tile blockIdx.x + (j / 7)
    // gridDim.x at kt = j % 7. Its input rows 2 oh0 - ph .. at frame
    // 2 ot - pt + kt go into stage j % stages, a warp a row, each lane a
    // piece of it; rows and frames past the input are zero filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const int pwarp = (tid - kConsumers) >> 5;
    const int piece = p.vec16 ? 16 : 4;
    const int per_row = p.row_bytes / piece;
    Tile lt;
    for (int j = 0; j < steps; ++j) {
      const int kt = j % kTaps, slot = j % p.stages;
      if (kt == 0) lt = tile_at(p, blockIdx.x + (j / kTaps) * gridDim.x);
      if (j >= p.stages) mbar_wait(empty + 8 * slot, ((j / p.stages) & 1) ^ 1);
      const int tt = 2 * (lt.plane % p.to) - p.pt + kt;
      const bool tin = tt >= 0 && tt < p.t;
      const long long frame = (long long)(lt.plane / p.to) * p.t + (tin ? tt : 0);
      const unsigned char* src = p.x + frame * p.h * (long long)p.row_bytes;
      const int h0 = 2 * lt.oh0 - p.ph;
      const uint32_t dst = sbase + ring + slot * stage_bytes + 2 * kLead;
      for (int r = pwarp; r < lt.rows; r += (kThreads - kConsumers) / 32) {
        const int hh = h0 + r;
        const bool ok = tin && hh >= 0 && hh < p.h;
        const unsigned char* row = ok ? src + hh * p.row_bytes : p.x;
        for (int c = lane; c < per_row; c += 32) {
          if (p.vec16) cp_async16(dst + r * p.rs + c * piece, ok ? row + c * piece : p.x, ok);
          else cp_async4(dst + r * p.rs + c * piece, ok ? row + c * piece : p.x, ok);
        }
      }
      cp_async_arrive(full + 8 * slot);
    }
    cp_async_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int quad = lane >> 2, q = lane & 3;
  // this thread's K pairs, as byte offsets from a position's window: pair
  // (k, k + 1) of a kt at K index k = 16 s + 8 h + 2 q is (kh, e) of the
  // window; the padding past a kt's K continues kh = 6's row (its weights
  // are zero), so a warp's loads stay on distinct banks
  uint32_t koff[G::kSteps][2];
#pragma unroll
  for (int s = 0; s < G::kSteps; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * s + 8 * h + 2 * q;
      const int kh = min(k / G::kWindow, kTaps - 1);
      koff[s][h] = kh * p.rs + 2 * (k - kh * G::kWindow);
    }
  }

  float acc[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  uint32_t a[2][kChunks][4];
  uint32_t rb[kChunks][2];      // this thread's 8 positions' windows in a stage
  Tile cur;

  for (int j = 0; j < steps; ++j) {
    const int kt = j % kTaps, slot = j % p.stages;
    if (kt == 0) {
      cur = tile_at(p, blockIdx.x + (j / kTaps) * gridDim.x);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int m = cur.m0 + 256 * wg + 64 * c + 16 * warp + quad + 8 * h;
          if (m >= plane_len) m = cur.m0;     // past the plane: computed, not stored
          const int oh = m / p.wo, ow = m - oh * p.wo;
          rb[c][h] = 2 * (oh - cur.oh0) * p.rs + 2 * (p.lead + 2 * ow * C);
        }
      }
    }
    mbar_wait(full + 8 * slot, (j / p.stages) & 1);     // step j landed
    const unsigned char* stage = smem + ring + slot * stage_bytes;
    if ((G::kSteps & 1) && (j & 1))
      mma_step<C, 1>(acc, a, stage, rb, koff, sbase, kt, empty + 8 * slot);
    else
      mma_step<C, 0>(acc, a, stage, rb, koff, sbase, kt, empty + 8 * slot);
    if (kt != kTaps - 1) continue;

    // the epilogue: accumulator (4 i + 2 h + b) of chunk c is position
    // m0 + 256 wg + 64 c + 16 warp + quad + 8 h, channel 8 i + 2 q + b.
    // Bias, ReLU and one rounding give each lane of a quad channel pair q of
    // each 8 channels; a transpose in the quad gives lane q channels
    // 8 q .. + 8 and 32 + 8 q .. + 8, two 16-byte stores a position
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) fence_regs(acc[c]);
    bf16* out = p.y + (long long)cur.plane * plane_len * kCout + 8 * q;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = cur.m0 + 256 * wg + 64 * c + 16 * warp + quad + 8 * h;
        uint32_t v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 b = *reinterpret_cast<const float2*>(bias_s + 8 * i + 2 * q);
          const __nv_bfloat162 r = __floats2bfloat162_rn(
              fmaxf(acc[c][4 * i + 2 * h] + b.x, 0.0f), fmaxf(acc[c][4 * i + 2 * h + 1] + b.y, 0.0f));
          v[i] = *reinterpret_cast<const uint32_t*>(&r);
        }
        const uint4 lo = quad_transpose(v[0], v[1], v[2], v[3], q);
        const uint4 hi = quad_transpose(v[4], v[5], v[6], v[7], q);
        if (m < plane_len) {
          *reinterpret_cast<uint4*>(out + (long long)m * kCout) = lo;
          *reinterpret_cast<uint4*>(out + (long long)m * kCout + 32) = hi;
        }
      }
    }
  }
  wgmma_wait<0>();
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int imax(int a, int b) { return a > b ? a : b; }

bool smem_attr_set[2][64];

}  // namespace

// One launch of S1. args: 14 slots of 64 bits (kernels/_launch.py): x, the
// packed weights, bias (f32 [64]), y, n, t, h, w, c, rs, stage_rows,
// stages, grid, stream. x [n, t, h, w, c] bf16 with c = 3 or 2, 16-byte
// aligned, w * c * 2 a multiple of 4; y [n, ceil(t / 2), ceil(h / 2),
// ceil(w / 2), 64] bf16; rs, stage_rows and stages as
// kernels/stem_conv3d.py::plan gives them. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int vq_stem_conv3d(const int64_t* args) {
  int64_t a[14];
  memcpy(a, args, sizeof a);
  Params p;
  p.x = reinterpret_cast<const unsigned char*>(a[0]);
  p.wp = reinterpret_cast<const unsigned char*>(a[1]);
  p.bias = reinterpret_cast<const float*>(a[2]);
  p.y = reinterpret_cast<bf16*>(a[3]);
  const long long n = a[4];
  p.t = (int)a[5];
  p.h = (int)a[6];
  const int w = (int)a[7], c = (int)a[8];
  p.rs = (int)a[9];
  p.stage_rows = (int)a[10];
  p.stages = (int)a[11];
  const int grid = (int)a[12];
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[13]);
  if ((c != 2 && c != 3) || p.stages < 2 || p.stages > 3 || grid < 1 || p.rs % 16)
    return (int)cudaErrorInvalidValue;
  p.row_bytes = w * c * 2;
  if (p.row_bytes % 4 || a[0] % 16) return (int)cudaErrorInvalidValue;
  p.to = ceil_div(p.t, 2);
  p.ho = ceil_div(p.h, 2);
  p.wo = ceil_div(w, 2);
  // SAME's cells before: total max((out - 1) * 2 + 7 - n, 0), the odd one after
  p.pt = imax((p.to - 1) * 2 + kTaps - p.t, 0) / 2;
  p.ph = imax((p.ho - 1) * 2 + kTaps - p.h, 0) / 2;
  const int pw = imax((p.wo - 1) * 2 + kTaps - w, 0) / 2;
  p.lead = kLead - pw * c;
  if (p.lead < 0 || p.lead % 2) return (int)cudaErrorInvalidValue;
  p.vec16 = p.row_bytes % 16 == 0;
  p.tiles_per_plane = ceil_div(p.ho * p.wo, kTile);
  const long long tiles = n * p.to * p.tiles_per_plane;
  if (tiles * kTaps >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  if (p.tiles == 0) return 0;
  const int weight_bytes = c == 3 ? Geom<3>::kWeightBytes : Geom<2>::kWeightBytes;
  const size_t smem = (size_t)weight_bytes + kCout * 4 + 16 * kMaxStages +
                      (size_t)p.stages * p.stage_rows * p.rs;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const void* fn = c == 3 ? (const void*)stem_conv_kernel<3> : (const void*)stem_conv_kernel<2>;
  if (!smem_attr_set[c - 2][dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    smem_attr_set[c - 2][dev] = true;
  }
  const unsigned blocks = (unsigned)(p.tiles < grid ? p.tiles : grid);
  if (c == 3) stem_conv_kernel<3><<<blocks, kThreads, smem, stream>>>(p);
  else stem_conv_kernel<2><<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
