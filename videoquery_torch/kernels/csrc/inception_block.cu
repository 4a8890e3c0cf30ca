// T1: one stride-1 BN-Inception block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tools/inception_pallas.py::_block_kernel (entry
// fused_inception). For NHWC x [N, H, W, Cin] and K ensemble members it
// writes out [K, N, H, W, Cout], the concat of four branches:
//   1x1                       -> channels [0, c1)
//   1x1 r3, then 3x3 c3        -> [c1, c1 + c3)
//   1x1 rd, then 3x3 d1, 3x3 d2 -> [c1 + c3, c1 + c3 + d2)
//   3x3 AVE or MAX pool, 1x1 pp -> the last pp channels
// Every conv is relu(f32 sum + f32 bias) rounded once to the activation
// type (bf16 or f32). The intermediates r3, rd and d1 are rounded to that
// type after ReLU, as the TPU kernel rounds them. Zero padding stands in for
// -inf in the MAX pool because a block's input is a concat of ReLU outputs
// and pools of them (>= 0): the wrapper states the precondition.
//
// Bound: tensor-core operations. The 8 stride-1 blocks at 200 bf16 images
// do ~0.5 TFLOP against ~0.8 GB of compulsory bytes (x read once, the
// output written once), ~600 FLOP per byte, above the card's ~295 FLOP/byte
// ridge: 0.50 ms at 989 TFLOP/s. So the design is about feeding the tensor
// cores from shared memory. A TPU kernel that keeps whole padded images in
// ~100 MB of VMEM does not carry over: a Hopper block has 227 KB of shared
// memory, and a tile streamed from L2 at the ~3 TB/s a card sustains feeds
// the tensor cores only at ~300 FLOP per byte it brings.
//
// bf16 design: three launches, each a list of jobs; a block computes a
// 256-pixel x 128-channel tile of one job with 4 warpgroups, each 64 rows
// through wgmma (m64n128k16, or m64n64k16 where a chunk has 64 columns or
// fewer), A and B read from shared memory through descriptors (no-swizzle
// core-matrix layouts), f32 accumulators in registers. Tiles span images.
//   1. xtile_kernel, every job that reads x: the 1x1 convs [c1 | r3 | rd] as
//      ONE GEMM over their concatenated weights (c1 to the output, r3 and
//      rd to the scratch `red`), and the pool projection, whose block brings
//      x's tile with a halo of W + 1 pixel rows into shared memory and pools
//      it there (f32 sum in window order, /9, rounded; or max), once per
//      pixel tile and 64 channels, for the pp GEMM. The chunks of one pixel
//      tile are neighbours in the grid, so they read x together from L2.
//      64-deep steps through a ring of up to 3 stages filled by 16-byte
//      cp.async with zero fill.
//   2. conv3x3_kernel: r3 -> c3 (output) and rd -> d1 (scratch `dd1`);
//   3. conv3x3_kernel: d1 -> d2 (output).
// `red` and `dd1` are kept in a zero-bordered layout [N][H + 2][W + 2] (the
// x-tile epilogue writes each border cell's zeros from its nearest pixel;
// the d1 job writes its border rows as zeros), and the 3x3 kernel computes
// rows of that layout, dropping the border rows. So a tap (dy, dx) reads
// the tile's rows shifted by dy (W + 2) + dx with no masks: a step of 32
// input channels brings the tile with a halo of W + 3 rows once, in
// 16-byte planes, and the 9 taps' weight tiles, and the 9 taps are 9
// descriptor offsets into the same halo tile (A read from L2 once a step,
// not once a tap), double-buffered. The scratch is read by the next launch
// while it is still in the 50 MB L2 (46 MB of padded `red` at 200 images of
// 28x28).
// Each epilogue adds the f32 bias, applies ReLU, rounds once, stages the
// tile in shared memory and stores 16-byte vectors into the job's channel
// slice of the NHWC output, so there is no concat pass.
// Not done: TMA (a 256-pixel tile spanning images has no box shape; TMA's
// im2col mode was not tried), a warp-specialised producer and a persistent
// grid; the x-tile launch, 1 block an SM with its register file full, now
// takes most of the time.
//
// f32 body (on no path; the JAX tool's f32 mode): five launches of a
// CUDA-core implicit GEMM (explicit fmaf, no TF32 anywhere), 128 x 64
// tiles, the reduce outputs and d1 in device-memory scratch.
//
// Build with --fmad=false and without fast math: the bias add, the pool's
// sum and /9 are rounded as written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

enum Mode { kConv1x1 = 0, kConv3x3 = 1, kPoolAve = 2, kPoolMax = 3 };

// ---------------------------------------------------------------------------
// bf16: wgmma implicit GEMM
// ---------------------------------------------------------------------------

constexpr int kWarpgroups = 4;
constexpr int kBM = 64 * kWarpgroups;     // output rows (pixels) per block, 64 a warpgroup
constexpr int kBN = 128;                  // output channels per block
constexpr int kGemmThreads = 128 * kWarpgroups;
constexpr int kStageLd = kBN + 8;         // epilogue staging row, elements (272 bytes)
constexpr int kMaxChunks = 16;
constexpr int kMaxSmem = 232448;
constexpr int kThreads = 256;             // the f32 body
// the x-tile kernel: 64-deep steps in a ring of up to 3 stages
constexpr int kBK = 64;
constexpr int kRowStep = kGemmThreads / 8;  // rows a pass of 16-byte loads covers
constexpr int kMaxStages = 3;
constexpr int kATile = kBM * kBK * 2;     // bytes of an A (pixel) tile
constexpr int kBTile = kBN * kBK * 2;     // bytes of a B (weight) tile
// the 3x3 kernel: 32-deep steps, each the halo tile and the 9 taps' weights
constexpr int kBK3 = 32;
constexpr int kPlanes3 = kBK3 / 8;        // 16-byte planes a step
constexpr int kBTap3 = kBN * kBK3 * 2;    // bytes of one tap's weight tile
constexpr int kStages3 = 2;

// One GEMM of a launch: A rows from `src` (a pixel's channels at src_off, a
// row every src_ld elements), B = wgt [cout][taps * cin]; columns [0, split)
// go to dst0, the rest to dst1, each at its own channel offset. A padded
// destination (pad0, pad1) is the zero-bordered layout [N][H + 2][W + 2]
// that the 3x3 kernel reads: its border cells are written as zeros.
struct Job {
  const bf16* src;
  long long src_member;       // elements between members (0: shared input)
  int src_ld, src_off, cin, mode;
  const bf16* wgt;
  long long w_member;
  const float* bias;
  long long b_member;
  int cout, split;
  bf16* dst0;
  long long dst0_member;
  int ld0, off0, pad0;
  bf16* dst1;
  long long dst1_member;
  int ld1, off1, pad1;
};

struct Launch {
  Job job[2];
  int chunk_job[kMaxChunks];  // block x -> (job, first column)
  int chunk_n0[kMaxChunks];
  int n, h, w;
  long long p;                // n * h * w
  long long pp;               // n * (h + 2) * (w + 2): rows of the padded layout
  int a_rows;                 // rows of a stage's A region (a halo included)
  int stages;                 // of the x-tile kernel's ring: 3, or 2 where a wide halo leaves no room
};

// Offset in bytes of (row r, 8-element group kg) in a tile of 64-deep rows:
// core matrices of 8 rows x 16 bytes, K-neighbours 128 bytes apart.
__device__ __forceinline__ uint32_t tile_off(int r, int kg) {
  return (uint32_t)(((r >> 3) * (kBK / 8) + kg) * 128 + (r & 7) * 16);
}

// wgmma shared-memory descriptor, no swizzle, K-major: core matrices of 8
// rows x 16 bytes; lbo the bytes between K-neighbour core matrices, sbo
// between 8-row groups. The start may be any 16-byte row.
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
       | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// make this thread's generic-proxy shared-memory writes (cp.async, st.shared)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across the async MMAs
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x N] += A[64 x 16] * B[N x 16]^T, bf16 in, f32 sums; both operands
// K-major in shared memory
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


// The bias, ReLU and one rounding of a block's accumulators into the
// staging tile (row-major, kStageLd a row): accumulator (c, e) of thread
// lane in warp w of warpgroup wg is row 64 wg + 16 w + lane / 4 + 8 (e / 2),
// column 8 c + 2 (lane % 4) + e % 2.
template <int N>
__device__ __forceinline__ void stage_tile(const float (&acc)[N], const float* bias, int width,
                                           bf16* stage) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const int col = 8 * c + 2 * (lane & 3);
    if (col < width) {
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            fmaxf(acc[4 * c + 2 * hh] + b0, 0.0f), fmaxf(acc[4 * c + 2 * hh + 1] + b1, 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(stage + (row + 8 * hh) * kStageLd + col) = v;
      }
    }
  }
}

// x-tile kernel, one block's tile: a 1x1 conv of x, or the pool of x and
// the pool projection. WIDE multiplies 128 columns a step (m64n128k16),
// else 64 (m64n64k16: a chunk of 64 columns or fewer).
template <bool WIDE>
__device__ __forceinline__ void xtile(const Launch& L, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const Job& J = L.job[L.chunk_job[chunk]];
  const int n0 = L.chunk_n0[chunk];
  const int member = blockIdx.z;
  const long long P = L.p;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int H = L.h, W = L.w;
  const int mode = J.mode;
  const bool pool = mode >= kPoolAve;
  const int cin = J.cin;
  const int steps = (cin + kBK - 1) / kBK;
  const int width = min(kBN, J.cout - n0);
  const int halo = pool ? W + 1 : 0;
  const int a_rows = pool ? L.a_rows : kBM;
  const int stages = L.stages;

  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int stage_bytes = L.a_rows * kBK * 2 + kBTile;
  auto a_addr = [&](int slot) { return sbase + slot * stage_bytes; };
  auto b_addr = [&](int slot) { return sbase + slot * stage_bytes + L.a_rows * kBK * 2; };
  const uint32_t pool_addr = sbase + stages * stage_bytes;

  const bf16* src = J.src + member * J.src_member + J.src_off;
  const bf16* wgt = J.wgt + member * J.w_member;

  // this thread's rows of the A and B tiles: (tid >> 3) + kRowStep j, group tid & 7
  constexpr int kARows = kBM / kRowStep, kBRows = kBN / kRowStep;
  const int g = tid & 7;
  const int r0 = tid >> 3;

  auto load_step = [&](int s, int slot) {
    const int c0 = s * kBK;
    const bool kin = c0 + g * 8 < cin;
    if (pool) {
      // x rows m0 - halo .. m0 + kBM + halo: the tile and its pool window
      for (int r = r0; r < a_rows; r += kRowStep) {
        const long long q = m0 - halo + r;
        const bool ok = kin && q >= 0 && q < P;
        cp_async16(a_addr(slot) + tile_off(r, g),
                   src + (ok ? q : 0) * J.src_ld + c0 + g * 8, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kARows; ++j) {
        const long long q = m0 + r0 + kRowStep * j;
        const bool ok = kin && q < P;
        cp_async16(a_addr(slot) + tile_off(r0 + kRowStep * j, g),
                   src + (ok ? q : 0) * J.src_ld + c0 + g * 8, ok);
      }
    }
#pragma unroll
    for (int j = 0; j < kBRows; ++j) {
      const int col = n0 + r0 + kRowStep * j;
      const bool ok = kin && col < J.cout;
      cp_async16(b_addr(slot) + tile_off(r0 + kRowStep * j, g),
                 wgt + (ok ? (long long)col * cin + c0 + g * 8 : 0), ok);
    }
  };

  // the pool of this thread's row (tid >> 1) and groups (tid & 1) * 4 .. + 4
  // from the halo tile in `slot` into the pooled tile
  const int pr = tid >> 1;
  int ppy = 0, ppx = 0;
  bool plive = false;
  if (pool) {
    const long long p = m0 + pr;
    plive = p < P;
    const int q = plive ? (int)p : 0;      // pixel indices fit in 31 bits (the wrapper checks)
    const int rem = q % (H * W);
    ppy = rem / W;
    ppx = rem - ppy * W;
  }
  auto pool_step = [&](int s, int slot) {
    const int c0 = s * kBK;
    const unsigned char* halo_tile = smem + (a_addr(slot) - sbase);
    unsigned char* out = smem + (pool_addr - sbase);
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      const int pg = (tid & 1) * 4 + gi;
      if (c0 + pg * 8 >= cin) break;
      float acc[8];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3 - 1, dx = t % 3 - 1;
        const bool ok = plive && (unsigned)(ppy + dy) < (unsigned)H
                     && (unsigned)(ppx + dx) < (unsigned)W;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (ok) v = *reinterpret_cast<const uint4*>(
            halo_tile + tile_off(pr + halo + dy * W + dx, pg));
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float f = __bfloat162float(e[k]);
          if (t == 0) acc[k] = f;
          else if (mode == kPoolAve) acc[k] = acc[k] + f;
          else acc[k] = fmaxf(acc[k], f);
        }
      }
      uint4 o;
      bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        oe[k] = __float2bfloat16_rn(mode == kPoolAve ? acc[k] / 9.0f : acc[k]);
      *reinterpret_cast<uint4*>(out + tile_off(pr, pg)) = o;
    }
  };

  constexpr int kAcc = WIDE ? 64 : 32;     // f32 accumulators a thread
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int wg = tid >> 7;                 // warpgroup: rows 64 wg .. + 64

  for (int s = 0; s < stages - 1; ++s) {
    if (s < steps) load_step(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int slot = s % stages;
    if (stages == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();          // step s landed; every warpgroup is done with step s - 1
    if (s + stages - 1 < steps) load_step(s + stages - 1, (s + stages - 1) % stages);
    cp_async_commit();
    uint32_t a_tile = a_addr(slot);
    if (pool) {
      pool_step(s, slot);
      fence_proxy_async();
      __syncthreads();
      a_tile = pool_addr;
    }
    const int k16 = (min(kBK, cin - s * kBK) + 15) / 16;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk < k16) {
        const uint64_t da = smem_desc(a_tile + tile_off(64 * wg, 2 * kk), 128, 1024);
        const uint64_t db = smem_desc(b_addr(slot) + tile_off(0, 2 * kk), 128, 1024);
        if (WIDE) wgmma_n128(acc, da, db);
        else wgmma_n64(acc, da, db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free: stage the output tile there

  bf16* stage = reinterpret_cast<bf16*>(smem);
  stage_tile(acc, J.bias + member * J.b_member + n0, width, stage);
  __syncthreads();
  // 16-byte stores of 8 columns each into the job's channel slices
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < kBM * (kBN / 8) / kGemmThreads; ++j) {
    const int i = tid + kGemmThreads * j;
    const int r = i >> 4, col = (i & 15) * 8;
    const long long p = m0 + r;
    if (col >= width || p >= P) continue;
    const int gcol = n0 + col;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + r * kStageLd + col);
    if (gcol < J.split) {
      *reinterpret_cast<uint4*>(J.dst0 + member * J.dst0_member + p * J.ld0 + J.off0 + gcol) = v;
      continue;
    }
    bf16* base = J.dst1 + member * J.dst1_member + J.off1 + (gcol - J.split);
    if (!J.pad1) {
      *reinterpret_cast<uint4*>(base + p * J.ld1) = v;
      continue;
    }
    // the padded layout: the pixel, and the border cells whose nearest
    // pixel it is (as zeros)
    const int img = (int)p / (H * W);
    const int rem = (int)p - img * H * W;
    const int y = rem / W, x = rem - y * W;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const bool oy = (unsigned)(y + dy) >= (unsigned)H, ox = (unsigned)(x + dx) >= (unsigned)W;
        if ((dy != 0 && !oy) || (dx != 0 && !ox)) continue;
        const long long q = ((long long)img * (H + 2) + y + 1 + dy) * (W + 2) + x + 1 + dx;
        *reinterpret_cast<uint4*>(base + q * J.ld1) = dy == 0 && dx == 0 ? v : zero;
      }
  }
}

__global__ void __launch_bounds__(kGemmThreads, 1)
xtile_kernel(const __grid_constant__ Launch L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk = blockIdx.x;
  if (L.job[L.chunk_job[chunk]].cout - L.chunk_n0[chunk] > 64) xtile<true>(L, smem);
  else xtile<false>(L, smem);
}

// 3x3 kernel, one block's tile: kBM rows of the padded layout [N][H+2][W+2]
// (border rows are computed and then dropped or written as zeros). A step
// is 32 input channels: the tile with a halo of W + 3 rows on each side, in
// 16-byte planes (row r of plane k at k * a_rows * 16 + r * 16), and the 9
// taps' weight tiles in the same layout; tap (dy, dx) is the halo tile
// shifted by dy (W + 2) + dx rows, an offset of the wgmma descriptor.
template <bool WIDE>
__device__ __forceinline__ void conv3x3(const Launch& L, unsigned char* smem) {
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const Job& J = L.job[L.chunk_job[chunk]];
  const int n0 = L.chunk_n0[chunk];
  const int member = blockIdx.z;
  const long long PP = L.pp;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int H = L.h, W = L.w, Wp = W + 2;
  const int halo = Wp + 1;
  const int a_rows = L.a_rows;
  const int cin = J.cin;
  const int steps = cin / kBK3;             // the wrapper checks cin % 32 == 0
  const long long depth = 9LL * cin;
  const int width = min(kBN, J.cout - n0);

  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int a_bytes = a_rows * kPlanes3 * 16;
  const int stage_bytes = a_bytes + 9 * kBTap3;
  auto a_addr = [&](int slot) { return sbase + slot * stage_bytes; };
  auto b_addr = [&](int slot) { return sbase + slot * stage_bytes + a_bytes; };

  const bf16* src = J.src + member * J.src_member + J.src_off;
  const bf16* wgt = J.wgt + member * J.w_member;
  const int k = tid & 3;                    // this thread's 16-byte plane
  const int n = tid >> 2;                   // its weight row (kGemmThreads / 4 == kBN)
  const bool n_ok = n0 + n < J.cout;
  const bf16* wrow = wgt + (n_ok ? (long long)(n0 + n) * depth : 0) + k * 8;

  auto load_step = [&](int s, int slot) {
    const int c0 = s * kBK3;
    for (int r = n; r < a_rows; r += kGemmThreads / 4) {
      const long long q = m0 - halo + r;
      const bool ok = q >= 0 && q < PP;
      cp_async16(a_addr(slot) + (k * a_rows + r) * 16,
                 src + (ok ? q : 0) * J.src_ld + c0 + k * 8, ok);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      cp_async16(b_addr(slot) + tap * kBTap3 + (k * kBN + n) * 16,
                 wrow + (n_ok ? tap * cin + c0 : 0), n_ok);
  };

  constexpr int kAcc = WIDE ? 64 : 32;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  const int wg = tid >> 7;

  load_step(0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int slot = s & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();          // step s landed; every warpgroup is done with step s - 1
    if (s + 1 < steps) load_step(s + 1, slot ^ 1);
    cp_async_commit();
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int row = halo + (tap / 3 - 1) * Wp + (tap % 3 - 1) + 64 * wg;
#pragma unroll
      for (int kk = 0; kk < kBK3 / 16; ++kk) {
        const uint64_t da = smem_desc(a_addr(slot) + (2 * kk * a_rows + row) * 16,
                                      a_rows * 16, 128);
        const uint64_t db = smem_desc(b_addr(slot) + tap * kBTap3 + 2 * kk * kBN * 16,
                                      kBN * 16, 128);
        if (WIDE) wgmma_n128(acc, da, db);
        else wgmma_n64(acc, da, db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  bf16* stage = reinterpret_cast<bf16*>(smem);
  stage_tile(acc, J.bias + member * J.b_member + n0, width, stage);
  __syncthreads();
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < kBM * (kBN / 8) / kGemmThreads; ++j) {
    const int i = tid + kGemmThreads * j;
    const int r = i >> 4, col = (i & 15) * 8;
    const long long q = m0 + r;
    if (col >= width || q >= PP) continue;
    const int img = (int)q / ((H + 2) * Wp);  // padded rows fit in 31 bits (the wrapper checks)
    const int rem = (int)q - img * (H + 2) * Wp;
    const int yp = rem / Wp, xp = rem - yp * Wp;
    const bool inside = yp >= 1 && yp <= H && xp >= 1 && xp <= W;
    const uint4 v = *reinterpret_cast<const uint4*>(stage + r * kStageLd + col);
    bf16* base = J.dst0 + member * J.dst0_member + J.off0 + n0 + col;
    if (J.pad0) {
      *reinterpret_cast<uint4*>(base + q * J.ld0) = inside ? v : zero;
    } else if (inside) {
      const long long p = ((long long)img * H + yp - 1) * W + xp - 1;
      *reinterpret_cast<uint4*>(base + p * J.ld0) = v;
    }
  }
}

__global__ void __launch_bounds__(kGemmThreads, 1)
conv3x3_kernel(const __grid_constant__ Launch L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk = blockIdx.x;
  if (L.job[L.chunk_job[chunk]].cout - L.chunk_n0[chunk] > 64) conv3x3<true>(L, smem);
  else conv3x3<false>(L, smem);
}

Job job(const void* src, long long src_member, int src_ld, int src_off, int cin, int mode,
        const void* w, const float* b, int cout, void* dst, long long dst_member, int ld,
        int off) {
  const int taps = mode == kConv3x3 ? 9 : 1;
  Job j{};
  j.src = static_cast<const bf16*>(src); j.src_member = src_member;
  j.src_ld = src_ld; j.src_off = src_off; j.cin = cin; j.mode = mode;
  j.wgt = static_cast<const bf16*>(w); j.w_member = (long long)cout * taps * cin;
  j.bias = b; j.b_member = cout;
  j.cout = cout; j.split = cout;
  j.dst0 = j.dst1 = static_cast<bf16*>(dst);
  j.dst0_member = j.dst1_member = dst_member;
  j.ld0 = j.ld1 = ld; j.off0 = j.off1 = off;
  return j;
}

bool smem_attr_set[64];

// One launch over the jobs, 128 columns a chunk: the x-tile kernel, or
// (conv3x3) the 3x3 kernel.
int launch(Launch& L, int njobs, bool conv3x3, int members, cudaStream_t stream) {
  int chunks = 0;
  bool pool = false;
  for (int j = 0; j < njobs; ++j) {
    pool = pool || L.job[j].mode >= kPoolAve;
    for (int n0 = 0; n0 < L.job[j].cout; n0 += kBN) {
      if (chunks == kMaxChunks) return (int)cudaErrorInvalidValue;
      L.chunk_job[chunks] = j;
      L.chunk_n0[chunks++] = n0;
    }
  }
  size_t smem = 0;
  if (conv3x3) {
    L.a_rows = (kBM + 2 * (L.w + 3) + 7) / 8 * 8;
    smem = (size_t)kStages3 * (L.a_rows * kPlanes3 * 16 + 9 * kBTap3);
  } else {
    // a pool job's A region holds the tile and W + 1 rows on each side, and
    // the pooled tile has a buffer of its own after the ring
    L.a_rows = pool ? (kBM + 2 * (L.w + 1) + 7) / 8 * 8 : kBM;
    for (L.stages = kMaxStages; L.stages >= 2; --L.stages) {
      smem = (size_t)L.stages * (L.a_rows * kBK * 2 + kBTile) + (pool ? kATile : 0);
      if (smem <= (size_t)kMaxSmem) break;
    }
    if (L.stages < 2) return (int)cudaErrorInvalidValue;
  }
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_attr_set[dev]) {
    for (const void* fn : {(const void*)xtile_kernel, (const void*)conv3x3_kernel}) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return (int)err;
    }
    smem_attr_set[dev] = true;
  }
  const long long rows = conv3x3 ? L.pp : L.p;
  const dim3 grid((unsigned)chunks, (unsigned)((rows + kBM - 1) / kBM), (unsigned)members);
  if (conv3x3) conv3x3_kernel<<<grid, kGemmThreads, smem, stream>>>(L);
  else xtile_kernel<<<grid, kGemmThreads, smem, stream>>>(L);
  return (int)cudaGetLastError();
}

// red and dd1 are in the padded layout [members][N][H + 2][W + 2][channels].
int run_block_bf16(const void* x, int n, int h, int w, int cin, int members, int c1, int r3,
                   int c3, int rd, int d1, int d2, int pp, int pool_max, const void* w1,
                   const float* b1, const void* w3, const float* b3, const void* wd1,
                   const float* bd1, const void* wd2, const float* bd2, const void* wpp,
                   const float* bpp, void* red, void* dd1, void* out, cudaStream_t stream) {
  const long long P = (long long)n * h * w;
  const long long PP = (long long)n * (h + 2) * (w + 2);
  const int cout = c1 + c3 + d2 + pp;
  const int nred = r3 + rd;
  Launch L{};
  L.n = n; L.h = h; L.w = w; L.p = P; L.pp = PP;
  int err;
  // 1. x -> [c1 | r3 | rd] (c1 to the output, r3 and rd to `red`) and
  //    pool(x) -> pp (the output)
  L.job[0] = job(x, 0, cin, 0, cin, kConv1x1, w1, b1, c1 + nred, out, P * cout, cout, 0);
  L.job[0].split = c1;
  L.job[0].dst1 = static_cast<bf16*>(red);
  L.job[0].dst1_member = PP * nred; L.job[0].ld1 = nred; L.job[0].off1 = 0;
  L.job[0].pad1 = 1;
  L.job[1] = job(x, 0, cin, 0, cin, pool_max ? kPoolMax : kPoolAve, wpp, bpp, pp, out,
                 P * cout, cout, c1 + c3 + d2);
  if ((err = launch(L, 2, false, members, stream))) return err;
  // 2. 3x3 r3 -> c3 (the output) and 3x3 rd -> d1 (`dd1`)
  L.job[0] = job(red, PP * nred, nred, 0, r3, kConv3x3, w3, b3, c3, out, P * cout, cout, c1);
  L.job[1] = job(red, PP * nred, nred, r3, rd, kConv3x3, wd1, bd1, d1, dd1, PP * d1, d1, 0);
  L.job[1].pad0 = 1;
  if ((err = launch(L, 2, true, members, stream))) return err;
  // 3. 3x3 d1 -> d2 (the output)
  L.job[0] = job(dd1, PP * d1, d1, 0, d1, kConv3x3, wd2, bd2, d2, out, P * cout, cout, c1 + c3);
  return launch(L, 1, true, members, stream);
}

// ---------------------------------------------------------------------------
// f32: CUDA-core implicit GEMM, five launches
// ---------------------------------------------------------------------------

constexpr int kFM = 128;       // output pixels per block
constexpr int kFN = 64;        // output channels per block
constexpr int kFK = 32;        // depth per step
constexpr int kFLd = kFK + 1;  // shared row stride (floats)

struct ConvArgs {
  const float* in;          // activations, [.., P, in_ld], channels at in_off
  long long in_member;      // elements between members (0: shared input)
  int in_ld, in_off, cin;
  const float* wgt;         // [cout][depth] per member
  long long w_member;
  const float* b;           // [cout] per member
  long long b_member;
  int cout;
  int split;                // columns [0, split) -> dst0, the rest -> dst1
  float* dst0;
  long long dst0_member;
  int ld0, off0;
  float* dst1;
  long long dst1_member;
  int ld1, off1;
  int n, h, w;
};

__device__ __forceinline__ void load8(const float* p, float (&r)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
f32_conv_kernel(const ConvArgs a) {
  __shared__ float As[kFM * kFLd];
  __shared__ float Bs[kFN * kFLd];

  const int tid = threadIdx.x;
  const int member = blockIdx.z;
  const long long P = (long long)a.n * a.h * a.w;
  const long long m0 = (long long)blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;
  const int taps = MODE == kConv3x3 ? 9 : 1;
  const int depth = taps * a.cin;

  const float* in = a.in + member * a.in_member;
  const float* wt = a.wgt + member * a.w_member;
  const float* bias = a.b + member * a.b_member;

  // this thread loads rows tid / 4 + 64 i of the A tile and row tid / 4 of
  // the B tile, 8 depth values at column (tid % 4) * 8
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

  float ra[2][8], rb[8];
  auto load_tiles = [&](int k0) {
    const int k = k0 + kv;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) ra[i][e] = 0.0f;
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
        float s[8];
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int yy = py[i] + t / 3 - 1, xx = px[i] + t % 3 - 1;
#pragma unroll
          for (int e = 0; e < 8; ++e) s[e] = 0.0f;
          if (yy >= 0 && yy < a.h && xx >= 0 && xx < a.w) {
            const long long pix = ((long long)img[i] * a.h + yy) * a.w + xx;
            load8(in + pix * a.in_ld + a.in_off + k, s);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (t == 0) ra[i][e] = s[e];
            else if (MODE == kPoolAve) ra[i][e] = ra[i][e] + s[e];
            else ra[i][e] = fmaxf(ra[i][e], s[e]);
          }
        }
        if (MODE == kPoolAve) {
#pragma unroll
          for (int e = 0; e < 8; ++e) ra[i][e] = ra[i][e] / 9.0f;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) rb[e] = 0.0f;
    if (bcol < a.cout && k < depth) load8(wt + (long long)bcol * depth + k, rb);
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) As[((tid >> 2) + 64 * i) * kFLd + kv + e] = ra[i][e];
#pragma unroll
    for (int e = 0; e < 8; ++e) Bs[(tid >> 2) * kFLd + kv + e] = rb[e];
  };

  // thread (tm, tn) owns rows tm*8 .. +8 and columns tn*4 .. +4
  const int tm = tid >> 4, tn = tid & 15;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  load_tiles(0);
  for (int k0 = 0; k0 < depth; k0 += kFK) {
    store_tiles();
    __syncthreads();
    if (k0 + kFK < depth) load_tiles(k0 + kFK);
#pragma unroll 4
    for (int k = 0; k < kFK; ++k) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[(tm * 8 + i) * kFLd + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[(tn * 4 + j) * kFLd + k];
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
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tn * 4 + j;
      if (col >= a.cout) continue;
      const float v = fmaxf(acc[i][j] + bias[col], 0.0f);
      float* dst = col < a.split
          ? a.dst0 + member * a.dst0_member + p * a.ld0 + a.off0 + col
          : a.dst1 + member * a.dst1_member + p * a.ld1 + a.off1 + (col - a.split);
      *dst = v;
    }
  }
}

template <int MODE>
int launch_f32(const ConvArgs& a, int members, cudaStream_t stream) {
  const long long P = (long long)a.n * a.h * a.w;
  const dim3 grid((unsigned)((P + kFM - 1) / kFM), (unsigned)((a.cout + kFN - 1) / kFN),
                  (unsigned)members);
  f32_conv_kernel<MODE><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

ConvArgs conv(const void* in, long long in_member, int in_ld, int in_off, int cin,
              const void* w, const float* b, int cout, void* dst, long long dst_member,
              int ld, int off, int n, int h, int wd, int taps) {
  ConvArgs a{};
  a.in = static_cast<const float*>(in); a.in_member = in_member; a.in_ld = in_ld;
  a.in_off = in_off; a.cin = cin;
  a.wgt = static_cast<const float*>(w); a.w_member = (long long)cout * taps * cin;
  a.b = b; a.b_member = cout;
  a.cout = cout; a.split = cout;
  a.dst0 = a.dst1 = static_cast<float*>(dst);
  a.dst0_member = a.dst1_member = dst_member;
  a.ld0 = a.ld1 = ld; a.off0 = a.off1 = off;
  a.n = n; a.h = h; a.w = wd;
  return a;
}

int run_block_f32(const void* x, int n, int h, int w, int cin, int members, int c1, int r3,
                  int c3, int rd, int d1, int d2, int pp, int pool_max, const void* w1,
                  const float* b1, const void* w3, const float* b3, const void* wd1,
                  const float* bd1, const void* wd2, const float* bd2, const void* wpp,
                  const float* bpp, void* red, void* dd1, void* out, cudaStream_t stream) {
  const long long P = (long long)n * h * w;
  const int cout = c1 + c3 + d2 + pp;
  const int nred = r3 + rd;
  int err;
  // 1. x -> [c1 | r3 | rd]: c1 into the output, r3 and rd into `red`
  ConvArgs a = conv(x, 0, cin, 0, cin, w1, b1, c1 + nred, out, P * cout, cout, 0,
                    n, h, w, 1);
  a.split = c1;
  a.dst1 = static_cast<float*>(red); a.dst1_member = P * nred; a.ld1 = nred; a.off1 = 0;
  if ((err = launch_f32<kConv1x1>(a, members, stream))) return err;
  // 2. 3x3 r3 -> c3 into the output
  a = conv(red, P * nred, nred, 0, r3, w3, b3, c3, out, P * cout, cout, c1, n, h, w, 9);
  if ((err = launch_f32<kConv3x3>(a, members, stream))) return err;
  // 3. 3x3 rd -> d1 into `dd1`
  a = conv(red, P * nred, nred, r3, rd, wd1, bd1, d1, dd1, P * d1, d1, 0, n, h, w, 9);
  if ((err = launch_f32<kConv3x3>(a, members, stream))) return err;
  // 4. 3x3 d1 -> d2 into the output
  a = conv(dd1, P * d1, d1, 0, d1, wd2, bd2, d2, out, P * cout, cout, c1 + c3, n, h, w, 9);
  if ((err = launch_f32<kConv3x3>(a, members, stream))) return err;
  // 5. pool(x) -> pp into the output
  a = conv(x, 0, cin, 0, cin, wpp, bpp, pp, out, P * cout, cout, c1 + c3 + d2, n, h, w, 1);
  return pool_max ? launch_f32<kPoolMax>(a, members, stream)
                  : launch_f32<kPoolAve>(a, members, stream);
}

}  // namespace

// One T1 call. args: 29 slots of 64 bits (kernels/_launch.py): x, bf16, n, h,
// w, cin, members, c1, r3, c3, rd, d1, d2, pp, pool_max, w1, b1, w3, b3, wd1,
// bd1, wd2, bd2, wpp, bpp, red, dd1, out, stream. x [N, H, W, cin] (shared by
// the members); weights [members][cout][taps*cin] and f32 biases
// [members][cout]; scratch red [members, P, r3 + rd] and dd1 [members, P,
// d1]; out [members, N, H, W, c1 + c3 + d2 + pp]. Every channel count is a
// multiple of 8 and every pointer 16-byte aligned (the wrapper checks).
// bf16 != 0 selects bfloat16 activations and weights (3 launches), else f32
// (5 launches). Returns the cudaError_t of the first launch that failed.
extern "C" int vq_inception_block(const int64_t* args) {
  int64_t a[29];
  memcpy(a, args, sizeof a);
  const int n = (int)a[2], h = (int)a[3], w = (int)a[4];
  if ((long long)n * h * w == 0) return 0;
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  auto fptr = [&](int i) { return reinterpret_cast<const float*>(a[i]); };
  auto run = a[1] ? run_block_bf16 : run_block_f32;
  return run(ptr(0), n, h, w, (int)a[5], (int)a[6], (int)a[7], (int)a[8], (int)a[9],
             (int)a[10], (int)a[11], (int)a[12], (int)a[13], (int)a[14], ptr(15), fptr(16),
             ptr(17), fptr(18), ptr(19), fptr(20), ptr(21), fptr(22), ptr(23), fptr(24),
             ptr(25), ptr(26), ptr(27), reinterpret_cast<cudaStream_t>(a[28]));
}
