// W1: Video Swin's window attention core, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no Video Swin. It was added
// for the attention of each Video Swin block (videoquery_torch/nn/
// video_swin.py), which ran as one cuDNN SDPA call that read a stored bf16
// bias-and-shift-mask tensor [windows x heads, 1, N, N] beside q, k and v
// (1.22 GB over a forward's 24 blocks).
//
// For every window w, view b and head h of a block:
//   o = softmax(q k^T * scale + B[h][idx(i, j)] (+ M_w(i, j))) v
// over the N <= 392 positions of a window, head dim 32. q, k and v are read
// where qkv's GEMM left them: qkv [B N nW, 3C], rows in (view, position,
// window) order, columns in (head, q/k/v, channel) order. o is written in
// the row order the proj GEMM reads: [B N nW, C], the heads' 32 channels
// side by side. The bias is a row of the block's table [T, heads] (f32, any
// strides), rounded to the working type as it is loaded (the rounding of
// the stored bf16 mask on every unmasked logit): idx(i, j) = base(i) -
// base(j) + centre, where base(n) = d (2Wh-1)(2Ww-1) + h (2Ww-1) + w for
// the coordinates (d, h, w) of position n in the published window (Wd, Wh,
// Ww), as relative_position_index[:N, :N] has it. The shift mask is the
// published -100 (MASK_VALUE) wherever two positions' region ids differ;
// each id follows from the window's coordinates, the clamped window and the
// shift. Every logit is computed: no key block is skipped for a mask.
//
// Two kernels:
//   - simple_kernel (float32): a thread a query row, the sequence's K and V
//     in shared memory, an online softmax with expf, the bias and mask
//     built as the stored mask was. The first correct version; the float32
//     route.
//   - fast_kernel (bf16): the route of a bf16 forward, below.
//
// Bound of the fast kernel. A sequence of 392 moves 100 KB (q, k, v, o)
// and does 19.7 MFLOP, but needs 153,664 exponentials; at the published
// stages a batch of 96 views has 381 k sequences: 11.4 ms of bytes, 7.6 ms
// of tensor-core operations, and ~15 ms of the MUFU's ~3.9 T exponentials
// a second. So the exponentials and the instructions a logit issues set
// the floor, and the design keeps those few:
//   - a block a sequence (head fastest, so neighbouring blocks read
//     neighbouring 64-byte pieces of qkv's rows); q, k and v staged once in
//     shared memory with cp.async (16-byte pieces, XOR-swizzled rows so
//     ldmatrix meets no bank conflict; rows past N zero-filled); 8 warps,
//     each taking 32 query rows at a time (the 400 rows of N = 392 in 13
//     tasks, the last one m16 tile), 2 blocks an SM;
//   - mma.sync m16n8k16 (bf16, f32 sums) for q k^T and p v, keys in chunks
//     of 16 (N = 392 ends on a chunk of 8 valid keys; the other 8 are
//     masked to p = 0, their v rows zeros);
//   - no running max: each row is shifted by a bound M_i of its logits,
//     C |q_i| max_j |k_j| + max B (Cauchy-Schwarz; the mask only lowers a
//     logit), folded into the q k^T accumulator's initial value, so a
//     logit is one FFMA from the MMA's sum: t = s C + B' with C = scale
//     log2(e) and B' = B log2(e) from the table in shared memory (one IADD
//     and one LDS: the row's base in a register, the column's in shared
//     memory), then ex2.approx. Softmax is shift-invariant, so this is the
//     softmax exactly; where a row's bound lies more than kGap (64, in
//     log2 units) above its own diagonal logit (a lower bound of its max),
//     so the row's largest p could fall below 2^-64, the warp first takes
//     the rows' exact maxima in a pass without exponentials, and shifts by
//     those;
//   - the row sums come from the p v MMA: a fifth n8 tile of ones beside v
//     (one MMA a 16 x 16 block of p in place of eight FADDs a thread), the
//     sums of the same bf16 p the numerator sums;
//   - windows whose positions all lie in one region (every unshifted
//     window, and the inner ones of a shifted block) take an instance
//     without the mask's compare and add;
//   - the output is normalised in registers, staged in the warp's q rows
//     in shared memory and written as 16-byte pieces;
//   - the next chunk's k fragments are loaded before this chunk's logits,
//     and the table's loads are all in flight at once.
// Measured on an H100 (a batch's 24 blocks at 96 views, 43.0 ms against
// cuDNN SDPA's 109 on the stored mask): no one unit sets the pace. Without
// the exponentials the kernel took 44.1 ms of 44.5, without the bias loads
// 42.9, without p v 41.6, without q k^T 40.4; staging q, k, v and the table
// alone 11.7 (compulsory loads, overlapped with the other block's MMAs).
// Slower or no faster: a wgmma version (m64n56k16 q k^T, m64n40k16 p v with
// p in registers, bf16 pair tables for the bias) 63.2 ms; a persistent
// block an SM, 16 warps taking tasks across a ring of 3 sequences in shared
// memory (no idle warps, every load overlapped) 47.3 against 42.9; two
// chunks a loop (spills at 128 registers) 43.9; 6 or 7 warps a block 44.7 /
// 45.6; the row sums by FADD 45.9 against 45.8.
// Numbers: the bias rounded to bf16 then scaled by log2(e) in f32; the
// masked logits get bf16(B) - 100 where the stored mask held bf16(B - 100)
// (both give p ~ e^-100, flushed to 0); p rounded to bf16 for the MMA; f32
// sums and statistics; o rounded once to bf16.
//
// Offsets: 64-bit for qkv and o, 32-bit in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHeadDim = 32;
constexpr int kMaxN = 392;                          // 8 x 7 x 7
constexpr int kMaxN16 = 400;                        // kMaxN rounded up to 16
constexpr int kMaxTable = 3136;                     // table rows: < 8 N
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -100.0f;               // the published compute_mask's fill
constexpr float kGap = 64.0f;                       // log2 units; see the note above

// -- geometry ------------------------------------------------------------------

struct Args {
  const void* qkv;             // [views n windows, 3 heads 32], working type
  const float* table;          // [table_rows, heads] at (trs, ths) strides
  void* out;                   // [views n windows, heads 32], working type
  long long trs, ths;
  int views, n, windows, heads;
  int wd, wh, ww;              // the clamped window
  int nd, nh, nw;              // windows a dim
  int sd, sh, sw;              // the shift (0 on a dim that does not shift)
  int pub_h, pub_w;            // the published window's h and w (position bases)
  int stride_d, stride_h;      // (2 Wh - 1)(2 Ww - 1) and 2 Ww - 1
  int centre;                  // the table row of a zero offset
  int table_rows;
  int n16;                     // n rounded up to 16
  float scale;                 // head_dim^-0.5
  bool shifted;
};

// base(n): position n's coordinates in the published window, as a table row
__device__ __forceinline__ int base_of(int n, const Args& a) {
  const int per_d = a.pub_h * a.pub_w;
  const int d = n / per_d, r = n - d * per_d, h = r / a.pub_w, w = r - h * a.pub_w;
  return d * a.stride_d + h * a.stride_h + w;
}

__device__ __forceinline__ int region_1d(int p, int size, int shift, int padded) {
  if (shift == 0) return 0;
  return p < padded - size ? 0 : (p < padded - shift ? 1 : 2);
}

// position n of window `win`: its region of compute_mask's grid (0 .. 26)
__device__ __forceinline__ int region_of(int n, int win, const Args& a) {
  const int per_d = a.wh * a.ww;
  const int d = n / per_d, r = n - d * per_d, h = r / a.ww, w = r - h * a.ww;
  const int iw = win % a.nw, ih = (win / a.nw) % a.nh, id = win / (a.nw * a.nh);
  return region_1d(id * a.wd + d, a.wd, a.sd, a.nd * a.wd) * 9 +
         region_1d(ih * a.wh + h, a.wh, a.sh, a.nh * a.wh) * 3 +
         region_1d(iw * a.ww + w, a.ww, a.sw, a.nw * a.ww);
}

// v rounded to bf16, as float
__device__ __forceinline__ float rounded_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// -- the simple kernel -------------------------------------------------------------

constexpr int kSimpleThreads = 128;
constexpr int kSimpleSmem = 2 * kMaxN * kHeadDim * 4 + kMaxTable * 4 + kMaxN * 4;

__global__ void __launch_bounds__(kSimpleThreads) simple_kernel(const Args a) {
  extern __shared__ float sm[];
  float* ks = sm;                                   // [n][32]
  float* vs = ks + kMaxN * kHeadDim;                // [n][32]
  float* tab = vs + kMaxN * kHeadDim;               // [table_rows]
  int* rid = reinterpret_cast<int*>(tab + kMaxTable);
  int s = blockIdx.x;
  const int head = s % a.heads;
  s /= a.heads;
  const int win = s % a.windows, view = s / a.windows;
  const long long row_stride = 3LL * a.heads * kHeadDim;
  const float* qkv = static_cast<const float*>(a.qkv) +
                     (static_cast<long long>(view) * a.n * a.windows + win) * row_stride +
                     head * 3 * kHeadDim;
  const long long pos_stride = static_cast<long long>(a.windows) * row_stride;
  for (int e = threadIdx.x; e < a.n * kHeadDim; e += kSimpleThreads) {
    const int j = e / kHeadDim, c = e - j * kHeadDim;
    ks[e] = qkv[j * pos_stride + kHeadDim + c];
    vs[e] = qkv[j * pos_stride + 2 * kHeadDim + c];
  }
  for (int r = threadIdx.x; r < a.table_rows; r += kSimpleThreads)
    tab[r] = a.table[r * a.trs + head * a.ths];
  for (int j = threadIdx.x; j < a.n; j += kSimpleThreads)
    rid[j] = a.shifted ? region_of(j, win, a) : 0;
  __syncthreads();
  float* out = static_cast<float*>(a.out);
  for (int i = threadIdx.x; i < a.n; i += kSimpleThreads) {
    float q[kHeadDim], acc[kHeadDim];
#pragma unroll
    for (int c = 0; c < kHeadDim; ++c) {
      q[c] = qkv[i * pos_stride + c];
      acc[c] = 0.0f;
    }
    const int bi = base_of(i, a) + a.centre, ri = rid[i];
    float m = -INFINITY, l = 0.0f;
    for (int j = 0; j < a.n; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < kHeadDim; ++c) s = fmaf(q[c], ks[j * kHeadDim + c], s);
      const float bias = tab[bi - base_of(j, a)] + (ri != rid[j] ? kMaskValue : 0.0f);
      const float t = fmaf(s, a.scale, bias);
      if (t > m) {
        const float c = expf(m - t);
        l *= c;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) acc[d] *= c;
        m = t;
      }
      const float p = expf(t - m);
      l += p;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(p, vs[j * kHeadDim + d], acc[d]);
    }
    float* o = out + (static_cast<long long>(view * a.n + i) * a.windows + win) * a.heads *
                         kHeadDim + head * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) o[d] = acc[d] / l;
  }
}

// -- the fast kernel (bf16) ----------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = kHeadDim * 2;             // 64: four 16-byte chunks
// shared memory, in bytes
constexpr int kKOff = 0;
constexpr int kVOff = kKOff + kMaxN16 * kRowBytes;
constexpr int kTabOff = kVOff + kMaxN16 * kRowBytes;   // f32 B log2(e)
constexpr int kRidOff = kTabOff + kMaxTable * 4;       // int region id
constexpr int kColOff = kRidOff + kMaxN16 * 4;         // int 4 base(j)
constexpr int kQOff = kColOff + kMaxN16 * 4;
constexpr int kStatOff = kQOff + kMaxN16 * kRowBytes;  // float2 (|q_i|, q_i . k_i)
constexpr int kRedOff = kStatOff + kMaxN16 * 8;        // 2 x kWarps floats
constexpr int kFastSmem = kRedOff + 2 * kWarps * 4;

// byte offset of 16-byte chunk c (0..3) of row r: rows r and r + 2 share
// banks unswizzled (64-byte rows), so the chunk index is XORed with (r/2)%4
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ ((r >> 1) & 3)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d = a b + c, m16n8k16, bf16 in, f32 sums; c0 for row g, c1 for row g + 8
__device__ __forceinline__ void mma_init(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, float c0, float c1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %11, %11};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c0), "f"(c1));
}

// d += a b
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// what a warp holds for the MT m16 tiles of its task: row g and g + 8 of
// each tile (index [m][half])
template <int MT>
struct Rows {
  uint32_t qa[MT][2][4];       // q's A fragments, two k16 steps
  int key[MT][2];              // byte offset of the row's table base (+ centre)
  int rid[MT][2];
  float off[MT][2];            // -M_i / C: the accumulator's initial value
};

// k's B fragments for the 16 keys at k0
__device__ __forceinline__ void load_k(uint32_t (&kb)[2][4], const int k0, const uint32_t sbase) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n8 = 0; n8 < 2; ++n8)
    ldsm_x4(kb[n8], sbase + kKOff + sw(k0 + n8 * 8 + (lane & 7), lane >> 3));
}

// One chunk of 16 keys at k0 for the task's rows, its k fragments in kb;
// leaves the next chunk's there (past the last, rows of v: never used).
// kPass 0: the maxima pass (mx), 1: the main pass (o, l). kMasked: the
// shift mask's compare; kRagged: keys past n get p = 0.
template <int MT, int kPass, bool kMasked, bool kRagged>
__device__ __forceinline__ void chunk(const int k0, const char* smem, const Args& a,
                                      const Rows<MT>& rw, const float c1,
                                      float (&o)[MT][4][4], float (&l)[MT][4],
                                      float (&mx)[MT][2], uint32_t (&kb)[2][4]) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const uint32_t sbase = smem_u32(smem);
  // in a ragged chunk, an n8 tile wholly past n (N = 392's last 8 keys)
  // is skipped: its p are 0
  const bool second = !kRagged || k0 + 8 < a.n;
  float s[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n8 = 0; n8 < 2; ++n8) {
      const float c0 = kPass ? rw.off[m][0] : 0.0f, c8 = kPass ? rw.off[m][1] : 0.0f;
      if (n8 == 1 && !second) {
        s[m][n8][0] = s[m][n8][1] = s[m][n8][2] = s[m][n8][3] = 0.0f;
        continue;
      }
      mma_init(s[m][n8], rw.qa[m][0], kb[n8][0], kb[n8][1], c0, c8);
      mma_acc(s[m][n8], rw.qa[m][1], kb[n8][2], kb[n8][3]);
    }
  }
  load_k(kb, k0 + 16, sbase);
  // the logits (log2 units, shifted in the main pass)
#pragma unroll
  for (int n8 = 0; n8 < 2; ++n8) {
    if (n8 == 1 && !second) continue;
    const int col = k0 + n8 * 8 + 2 * t4;
    const int2 ck = *reinterpret_cast<const int2*>(smem + kColOff + col * 4);
    int2 cr = make_int2(0, 0);
    if (kMasked) cr = *reinterpret_cast<const int2*>(smem + kRidOff + col * 4);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, odd = e & 1;
        const float bias = *reinterpret_cast<const float*>(
            smem + (rw.key[m][half] - (odd ? ck.y : ck.x)));
        float t = fmaf(s[m][n8][e], c1, bias);
        if (kMasked && rw.rid[m][half] != (odd ? cr.y : cr.x)) t += kMaskValue * kLog2e;
        if (kRagged && col + odd >= a.n) t = -INFINITY;
        if (kPass == 0) mx[m][half] = fmaxf(mx[m][half], t);
        else s[m][n8][e] = ex2(t);
      }
    }
  }
  if (kPass == 0) return;
  uint32_t vb[4][2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    uint32_t r[4];
    ldsm_x4_t(r, sbase + kVOff + sw(k0 + ((lane >> 3) & 1) * 8 + (lane & 7), (lane >> 4) + 2 * h2));
    vb[2 * h2][0] = r[0];
    vb[2 * h2][1] = r[1];
    vb[2 * h2 + 1][0] = r[2];
    vb[2 * h2 + 1][1] = r[3];
  }
  const uint32_t ones = 0x3F803F80u;                // bf16 (1, 1)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const uint32_t pa[4] = {pack_bf16(s[m][0][0], s[m][0][1]), pack_bf16(s[m][0][2], s[m][0][3]),
                            pack_bf16(s[m][1][0], s[m][1][1]), pack_bf16(s[m][1][2], s[m][1][3])};
#pragma unroll
    for (int c = 0; c < 4; ++c) mma_acc(o[m][c], pa, vb[c][0], vb[c][1]);
    mma_acc(l[m], pa, ones, ones);
  }
}

template <int MT, int kPass, bool kMasked>
__device__ __forceinline__ void pass(const char* smem, const Args& a, const Rows<MT>& rw,
                                     const float c1, float (&o)[MT][4][4], float (&l)[MT][4],
                                     float (&mx)[MT][2]) {
  const int full = a.n / 16;
  uint32_t kb[2][4];
  load_k(kb, 0, smem_u32(smem));
#pragma unroll 1
  for (int kc = 0; kc < full; ++kc)
    chunk<MT, kPass, kMasked, false>(kc * 16, smem, a, rw, c1, o, l, mx, kb);
  if (full * 16 < a.n)
    chunk<MT, kPass, kMasked, true>(full * 16, smem, a, rw, c1, o, l, mx, kb);
}

// The 16 MT query rows from r0 of the block's sequence, written to out.
template <int MT, bool kMasked>
__device__ __forceinline__ void task(const int r0, char* smem, const Args& a, const float c1,
                     const float kmax, const float tmax, bf16* out_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t sbase = smem_u32(smem);
  Rows<MT> rw;
  bool exact = false;
  const float diag_bias = *reinterpret_cast<const float*>(smem + kTabOff + a.centre * 4);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16)
      ldsm_x4(rw.qa[m][k16], sbase + kQOff + sw(r0 + m * 16 + (lane & 15), 2 * k16 + (lane >> 4)));
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = min(r0 + m * 16 + g + 8 * half, a.n - 1);
      rw.key[m][half] = kTabOff + 4 * (base_of(i, a) + a.centre);
      rw.rid[m][half] = reinterpret_cast<const int*>(smem + kRidOff)[i];
      const float2 st = reinterpret_cast<const float2*>(smem + kStatOff)[i];
      const float bound = c1 * st.x * kmax + tmax;
      exact |= bound - (fmaf(st.y, c1, diag_bias)) > kGap;
      rw.off[m][half] = bound;
    }
  }
  float o[MT][4][4], l[MT][4], mx[MT][2];
  if (__any_sync(0xFFFFFFFFu, exact)) {
#pragma unroll
    for (int m = 0; m < MT; ++m) mx[m][0] = mx[m][1] = -INFINITY;
    pass<MT, 0, kMasked>(smem, a, rw, c1, o, l, mx);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = mx[m][half];
        v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
        rw.off[m][half] = v;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    rw.off[m][0] = -rw.off[m][0] / c1;
    rw.off[m][1] = -rw.off[m][1] / c1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      l[m][c] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[m][c][e] = 0.0f;
    }
  }
  pass<MT, 1, kMasked>(smem, a, rw, c1, o, l, mx);
  // normalise, stage in this warp's q rows, write 16-byte pieces
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float inv0 = 1.0f / l[m][0], inv1 = 1.0f / l[m][2];
    const int r = r0 + m * 16 + g;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<uint32_t*>(smem + kQOff + sw(r, c) + 4 * t4) =
          pack_bf16(o[m][c][0] * inv0, o[m][c][1] * inv0);
      *reinterpret_cast<uint32_t*>(smem + kQOff + sw(r + 8, c) + 4 * t4) =
          pack_bf16(o[m][c][2] * inv1, o[m][c][3] * inv1);
    }
  }
  __syncwarp();
  const long long pos_stride = static_cast<long long>(a.windows) * a.heads * kHeadDim;
#pragma unroll
  for (int k = 0; k < MT * 2; ++k) {
    const int idx = lane + 32 * k, r = r0 + (idx >> 2), c = idx & 3;
    if (r < a.n)
      *reinterpret_cast<uint4*>(out_rows + r * pos_stride + c * 8) =
          *reinterpret_cast<const uint4*>(smem + kQOff + sw(r, c));
  }
}

__global__ void __launch_bounds__(kThreads, 2) fast_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int s = blockIdx.x;
  const int head = s % a.heads;
  s /= a.heads;
  const int win = s % a.windows, view = s / a.windows;
  const long long row_stride = 3LL * a.heads * kHeadDim;
  const bf16* qkv = static_cast<const bf16*>(a.qkv) +
                    (static_cast<long long>(view) * a.n * a.windows + win) * row_stride +
                    head * 3 * kHeadDim;
  const long long pos_stride = static_cast<long long>(a.windows) * row_stride;
  // q, k and v: 16-byte pieces, rows past n zero-filled
  const uint32_t sbase = smem_u32(smem);
  for (int e = tid; e < 3 * a.n16 * 4; e += kThreads) {
    const int which = e / (a.n16 * 4), rem = e - which * a.n16 * 4, r = rem >> 2, c = rem & 3;
    const bool valid = r < a.n;
    const bf16* src = valid ? qkv + r * pos_stride + which * kHeadDim + c * 8 : qkv;
    cp_async16(sbase + (which == 0 ? kQOff : which == 1 ? kKOff : kVOff) + sw(r, c), src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the table rounded to bf16, in log2 units; the columns' bases and regions
  float tmax = -INFINITY;
  float* tab = reinterpret_cast<float*>(smem + kTabOff);
  {
    // every load in flight at once
    constexpr int kIters = (kMaxTable + kThreads - 1) / kThreads;
    float tv[kIters];
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int r = tid + k * kThreads;
      tv[k] = r < a.table_rows ? a.table[r * a.trs + head * a.ths] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int r = tid + k * kThreads;
      if (r >= a.table_rows) continue;
      const float v = rounded_bf16(tv[k]) * kLog2e;
      tab[r] = v;
      tmax = fmaxf(tmax, v);
    }
  }
  int* col = reinterpret_cast<int*>(smem + kColOff);
  int* rid = reinterpret_cast<int*>(smem + kRidOff);
  int mixed = 0;
  for (int j = tid; j < a.n16; j += kThreads) {
    const int jj = min(j, a.n - 1);
    col[j] = 4 * base_of(jj, a);
    rid[j] = a.shifted ? region_of(jj, win, a) : 0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (a.shifted)
    for (int j = tid; j < a.n; j += kThreads) mixed |= rid[j] != rid[0];
  // each row's |q| and q . k (its diagonal), and max_j |k_j|
  float kmax = 0.0f;
  for (int r = tid; r < a.n16; r += kThreads) {
    float qq = 0.0f, kk = 0.0f, qk = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 qv = *reinterpret_cast<const uint4*>(smem + kQOff + sw(r, c));
      const uint4 kv = *reinterpret_cast<const uint4*>(smem + kKOff + sw(r, c));
      const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w}, kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float q0 = __uint_as_float(qw[u] << 16), q1 = __uint_as_float(qw[u] & 0xFFFF0000u);
        const float k0 = __uint_as_float(kw[u] << 16), k1 = __uint_as_float(kw[u] & 0xFFFF0000u);
        qq = fmaf(q1, q1, fmaf(q0, q0, qq));
        kk = fmaf(k1, k1, fmaf(k0, k0, kk));
        qk = fmaf(q1, k1, fmaf(q0, k0, qk));
      }
    }
    reinterpret_cast<float2*>(smem + kStatOff)[r] = make_float2(sqrtf(qq), qk);
    if (r < a.n) kmax = fmaxf(kmax, sqrtf(kk));
  }
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  kmax = warp_max(kmax);
  tmax = warp_max(tmax);
  if (lane == 0) {
    red[warp] = kmax;
    red[kWarps + warp] = tmax;
  }
  mixed = __syncthreads_or(mixed);
  kmax = red[0];
  tmax = red[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    kmax = fmaxf(kmax, red[w]);
    tmax = fmaxf(tmax, red[kWarps + w]);
  }
  const float c1 = a.scale * kLog2e;
  bf16* out_rows = static_cast<bf16*>(a.out) +
                   (static_cast<long long>(view) * a.n * a.windows + win) * a.heads * kHeadDim +
                   head * kHeadDim;
  const int tasks = (a.n16 + 31) / 32;
  for (int tk = warp; tk < tasks; tk += kWarps) {
    const int r0 = tk * 32;
    const bool two = a.n16 - r0 >= 32;
    if (mixed) {
      if (two) task<2, true>(r0, smem, a, c1, kmax, tmax, out_rows);
      else task<1, true>(r0, smem, a, c1, kmax, tmax, out_rows);
    } else {
      if (two) task<2, false>(r0, smem, a, c1, kmax, tmax, out_rows);
      else task<1, false>(r0, smem, a, c1, kmax, tmax, out_rows);
    }
  }
}

template <typename K>
int prepare(K kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

}  // namespace

// One launch of W1. args: 24 slots of 64 bits (kernels/_launch.py): qkv,
// table, out, views, n, windows, heads, the clamped window (wd, wh, ww),
// the windows a dim (nd, nh, nw), the shift (sd, sh, sw), the published
// window (Wd, Wh, Ww), the table's row and head strides, the variant (0:
// the fast bf16 kernel, 1: the simple float32 kernel), the scale (its
// float32 bits), stream. qkv [views n windows, 3 heads 32] and out [views
// n windows, heads 32], both contiguous and 16-byte aligned; table f32
// [(2Wd-1)(2Wh-1)(2Ww-1), heads]; n = wd wh ww <= 392, n <= Wd Wh Ww.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int vq_window_attention(const int64_t* args) {
  int64_t v[24];
  memcpy(v, args, sizeof v);
  Args a;
  a.qkv = reinterpret_cast<const void*>(v[0]);
  a.table = reinterpret_cast<const float*>(v[1]);
  a.out = reinterpret_cast<void*>(v[2]);
  a.views = static_cast<int>(v[3]);
  a.n = static_cast<int>(v[4]);
  a.windows = static_cast<int>(v[5]);
  a.heads = static_cast<int>(v[6]);
  a.wd = static_cast<int>(v[7]);
  a.wh = static_cast<int>(v[8]);
  a.ww = static_cast<int>(v[9]);
  a.nd = static_cast<int>(v[10]);
  a.nh = static_cast<int>(v[11]);
  a.nw = static_cast<int>(v[12]);
  a.sd = static_cast<int>(v[13]);
  a.sh = static_cast<int>(v[14]);
  a.sw = static_cast<int>(v[15]);
  const int pd = static_cast<int>(v[16]);
  a.pub_h = static_cast<int>(v[17]);
  a.pub_w = static_cast<int>(v[18]);
  a.trs = v[19];
  a.ths = v[20];
  const int variant = static_cast<int>(v[21]);
  const uint32_t scale_bits = static_cast<uint32_t>(v[22]);
  memcpy(&a.scale, &scale_bits, 4);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(v[23]);
  a.stride_h = 2 * a.pub_w - 1;
  a.stride_d = (2 * a.pub_h - 1) * a.stride_h;
  a.centre = (pd - 1) * a.stride_d + (a.pub_h - 1) * a.stride_h + a.pub_w - 1;
  a.table_rows = (2 * pd - 1) * a.stride_d;
  a.n16 = (a.n + 15) / 16 * 16;
  a.shifted = a.sd || a.sh || a.sw;
  if (a.n < 1 || a.n > kMaxN || a.n != a.wd * a.wh * a.ww || a.n > pd * a.pub_h * a.pub_w ||
      a.heads < 1 || a.views < 0 || a.windows != a.nd * a.nh * a.nw || a.table_rows > kMaxTable ||
      variant < 0 || variant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(a.views) * a.windows * a.heads;
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 0) {
    static const int ready = prepare(fast_kernel, kFastSmem);
    if (ready) return ready;
    fast_kernel<<<static_cast<unsigned>(blocks), kThreads, kFastSmem, stream>>>(a);
  } else {
    static const int ready = prepare(simple_kernel, kSimpleSmem);
    if (ready) return ready;
    simple_kernel<<<static_cast<unsigned>(blocks), kSimpleThreads, kSimpleSmem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
