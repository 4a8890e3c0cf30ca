// K1: fused multi-query ensemble similarity for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel videoquery/kernels/query_pallas.py::_query_kernel.
// For every clip n and query q it walks the ensemble members (s, k) in
// order, takes the dot product of target (q, s, k) with feats[s, k, n] over
// D, and keeps, per stream, the masked sum and count under
// mask[s, k, n] && tmask[q, s, k]. Two epilogues:
//   avg+counts  avg[q, s, n] = sum / max(count, 1) (f32), counts[q, s, n]
//               (int32) -- the engine's batched similarity;
//   scores      score[q, n] = 1 - sqrt(sum_s (w_qs (1 - avg))^2 / sum_s w_qs^2),
//               -1e30 where a stream has no member -- fused_query_scores.
//
// Bound: bytes of the index. At Q = 16 the products are ~16 flop per bf16
// byte read, far below the H100's ridge point (~295), so both bodies read
// every index byte from device memory once per launch. The TPU grid's
// sequential (s, k) axes become loops inside the block (blocks run
// unordered and carry nothing between them); per-stream sums and counts
// live in registers and the epilogue writes once.
//
// bf16 index: query_mma_kernel, on the tensor cores. A block owns 128 clips
// (8 warps x 16) and streams each member's [128, D] rows through a ring of
// kStages shared-memory stages of 64-deep slices, filled by 16-byte
// cp.async.cg copies (the L2 fetching 256 bytes a row), so the next slices'
// copies overlap the current one's products. Beside each index slice the stage holds the targets' [Q, 64]
// slice (bf16, zero rows up to the n-tile). Fragments come from shared
// memory through ldmatrix; rows are 144 bytes apart, so the eight 16-byte
// rows of an 8x8 matrix fall on distinct banks. Products are
// mma.sync.m16n8k16 bf16 x bf16 with f32 accumulation: clips on the M side,
// queries on the N side (n-tiles of 8), d on the K side. Bytes moved: the
// index once; the targets once per block and member, T x Q x D x 2 bytes per
// 128 clips (T = 1 or 3 terms, below), which at Q = 16 and T = 1 is 1/8 of
// the index bytes and reads from L2; the mask once; the outputs once.
//
// Targets on the bf16 path come in T terms of bf16, [Q, T, S, K, D]:
//   T = 1  the scores path rounds them to bf16 (the TPU kernel's cast), so
//          each product is exact in f32, as on the TPU's MXU;
//   T = 3  the engine keeps f32 targets: the wrapper splits each into
//          t = t_hi + t_mid + t_lo, each the round-to-nearest bf16 of what
//          the previous terms leave (exact for normal f32), and every k-step
//          runs three MMAs, t_lo first, then t_mid, then t_hi; each
//          bf16 x bf16 product is exact in f32.
//
// Reduction order is part of the contract: every output element is the
// same sequence of MMAs -- 16-deep k-steps over d = 0, 16, ... in ascending
// order, the T terms in the order above, accumulated in one f32 fragment
// element from zero -- fixed by D alone, whatever Q, the query's column in
// its n-tile or the other queries of the launch. The instruction shape is
// always m16n8k16, padding query rows are zeros, and there is no split-K.
// So a query scored alone gives the same bits as the same query inside any
// batch -- the broker's batched-equals-solo promise rests on it. The masked
// per-stream sums, counts, average and score then follow as plain f32
// operations in the order of the f32 body below.
//
// f32 index: query_kernel, exact f32 on the CUDA cores: the dot product of
// one (q, s, k, n) is accumulated by ONE thread with fmaf over d = 0, 1, ...,
// D-1 in ascending order, from a [64, 128] slice staged (f32) in shared
// memory for 256 threads. It serves the 100k-segment f32 rounds, which are
// host-bound.
//
// No TF32, no fast math: build without --use_fast_math so '/' and sqrtf stay
// correctly rounded, and with --fmad=false so the epilogue's products and
// sums are not contracted (only the explicit fmaf of the f32 body fuses).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxQ = 64;                   // queries per launch
constexpr float kNegInf = -1e30f;           // query_pallas.py NEG_INF

// -- f32 index: CUDA cores ----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTileN = 64;                  // clips per block
constexpr int kLanes = kThreads / kTileN;   // query lanes per clip (4)
constexpr int kChunkD = 128;                // D slice staged per step
constexpr int kRowPad = 4;                  // floats: rows 528 B apart, so a
                                            // quarter-warp's float4 reads of 8
                                            // rows hit distinct banks
constexpr int kLd = kChunkD + kRowPad;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// QPT: queries per thread (query q = lane + j * kLanes, j < QPT).
template <int QPT, bool kScores>
__global__ void __launch_bounds__(kThreads)
query_kernel(const float* __restrict__ feats,      // [S, K, N, D]
             const uint8_t* __restrict__ mask,     // [S, K, N]
             const float* __restrict__ targets,    // [Q, S, K, D]
             const uint8_t* __restrict__ tmask,    // [Q, S, K]
             const float* __restrict__ weights,    // [Q, S] (scores only)
             float* __restrict__ out,              // avg [Q, S, N] | scores [Q, N]
             int32_t* __restrict__ counts_out,     // [Q, S, N] (avg only)
             int Q, int S, int K, int N, int D, int vec) {
  extern __shared__ float4 smem4[];
  float* feat_s = reinterpret_cast<float*>(smem4);  // [kTileN][kLd]
  float* tgt_s = feat_s + kTileN * kLd;             // [QPT * kLanes][kChunkD]
  constexpr int kQRows = QPT * kLanes;

  const int tid = threadIdx.x;
  const int nl = tid % kTileN;  // a warp covers 32 clips of ONE query lane
  const int lane = tid / kTileN;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTileN;
  const int64_t n = n0 + nl;
  const bool in_range = n < N;
  const int members = S * K;

  float num[QPT];
  bool valid[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    num[j] = 0.0f;
    valid[j] = true;
  }

  for (int s = 0; s < S; ++s) {
    float sum[QPT];
    int cnt[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      sum[j] = 0.0f;
      cnt[j] = 0;
    }
    for (int k = 0; k < K; ++k) {
      const int64_t member = static_cast<int64_t>(s) * K + k;
      const float* fbase = feats + (member * N + n0) * D;
      float dot[QPT];
#pragma unroll
      for (int j = 0; j < QPT; ++j) dot[j] = 0.0f;

      for (int d0 = 0; d0 < D; d0 += kChunkD) {
        const int dc = min(kChunkD, D - d0);
        __syncthreads();  // the previous slice is consumed
        if (vec) {        // D % 4 == 0 and aligned: 4 elements per load
          const int c4 = dc / 4;
          for (int i = tid; i < kTileN * c4; i += kThreads) {
            const int r = i / c4;
            const int c = (i % c4) * 4;
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (n0 + r < N) v = load4(fbase + static_cast<int64_t>(r) * D + d0 + c);
            *reinterpret_cast<float4*>(feat_s + r * kLd + c) = v;
          }
        } else {
          for (int i = tid; i < kTileN * dc; i += kThreads) {
            const int r = i / dc;
            const int c = i % dc;
            float v = 0.0f;
            if (n0 + r < N) v = fbase[static_cast<int64_t>(r) * D + d0 + c];
            feat_s[r * kLd + c] = v;
          }
        }
        for (int i = tid; i < kQRows * dc; i += kThreads) {
          const int q = i / dc;
          const int c = i % dc;
          tgt_s[q * kChunkD + c] =
              q < Q ? targets[(static_cast<int64_t>(q) * members + member) * D + d0 + c]
                    : 0.0f;
        }
        __syncthreads();

        const float* frow = feat_s + nl * kLd;
        int c = 0;
        for (; c + 4 <= dc; c += 4) {
          const float4 f = *reinterpret_cast<const float4*>(frow + c);
#pragma unroll
          for (int j = 0; j < QPT; ++j) {
            const float4 t = *reinterpret_cast<const float4*>(
                tgt_s + (lane + j * kLanes) * kChunkD + c);
            dot[j] = fmaf(t.x, f.x, dot[j]);
            dot[j] = fmaf(t.y, f.y, dot[j]);
            dot[j] = fmaf(t.z, f.z, dot[j]);
            dot[j] = fmaf(t.w, f.w, dot[j]);
          }
        }
        for (; c < dc; ++c) {
          const float f = frow[c];
#pragma unroll
          for (int j = 0; j < QPT; ++j)
            dot[j] = fmaf(tgt_s[(lane + j * kLanes) * kChunkD + c], f, dot[j]);
        }
      }

      const bool m_clip = in_range && mask[member * N + n] != 0;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const int q = lane + j * kLanes;
        if (m_clip && q < Q && tmask[static_cast<int64_t>(q) * members + member]) {
          sum[j] += dot[j];
          cnt[j] += 1;
        }
      }
    }

    // stream s is complete: its epilogue
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int q = lane + j * kLanes;
      if (q >= Q || !in_range) continue;
      const float avg = sum[j] / static_cast<float>(max(cnt[j], 1));
      if (kScores) {
        const float dev = weights[q * S + s] * (1.0f - avg);
        num[j] = num[j] + dev * dev;
        valid[j] = valid[j] && cnt[j] > 0;
      } else {
        const int64_t o = (static_cast<int64_t>(q) * S + s) * N + n;
        out[o] = avg;
        counts_out[o] = cnt[j];
      }
    }
  }

  if (kScores) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int q = lane + j * kLanes;
      if (q >= Q || !in_range) continue;
      float den = 0.0f;
      for (int s = 0; s < S; ++s) {
        const float w = weights[q * S + s];
        den = den + w * w;
      }
      const float score = 1.0f - sqrtf(num[j] / den);
      out[static_cast<int64_t>(q) * N + n] = valid[j] ? score : kNegInf;
    }
  }
}

template <int QPT, bool kScores>
cudaError_t launch_f32(const void* feats, const void* mask, const void* targets,
                       const void* tmask, const void* weights, void* out,
                       void* counts, int Q, int S, int K, int N, int D, int vec,
                       cudaStream_t stream) {
  auto kernel = query_kernel<QPT, kScores>;
  const int smem = (kTileN * kLd + QPT * kLanes * kChunkD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileN - 1) / kTileN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(feats), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(targets), static_cast<const uint8_t*>(tmask),
      static_cast<const float*>(weights), static_cast<float*>(out),
      static_cast<int32_t*>(counts), Q, S, K, N, D, vec);
  return cudaGetLastError();
}

template <bool kScores>
cudaError_t dispatch_f32(const void* feats, const void* mask, const void* targets,
                         const void* tmask, const void* weights, void* out,
                         void* counts, int Q, int S, int K, int N, int D, int vec,
                         cudaStream_t stream) {
#define VQ_LAUNCH(QPT)                                                         \
  return launch_f32<QPT, kScores>(feats, mask, targets, tmask, weights, out,  \
                                  counts, Q, S, K, N, D, vec, stream)
  if (Q <= 1 * kLanes) VQ_LAUNCH(1);
  if (Q <= 2 * kLanes) VQ_LAUNCH(2);
  if (Q <= 4 * kLanes) VQ_LAUNCH(4);
  if (Q <= 8 * kLanes) VQ_LAUNCH(8);
  VQ_LAUNCH(16);
#undef VQ_LAUNCH
}

// -- bf16 index: tensor cores -------------------------------------------------

constexpr int kMmaThreads = 256;
constexpr int kTileM = (kMmaThreads / 32) * 16;  // clips per block, 16 per warp
constexpr int kChunkK = 64;                      // d per stage
constexpr int kPieces = kChunkK / 8;             // 16-byte pieces per row slice
constexpr int kLdS = kChunkK + 8;                // bf16: rows 144 B apart
constexpr int kStages = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !full. The L2
// fetches the 256-byte block around it: the next stage reads the rest of
// the row's 256 bytes, and the larger requests stream the index faster.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT: n-tiles of 8 queries; TERMS: bf16 terms per target (1 or 3).
// Fragment element i of n-tile j belongs to clip row warp * 16 + lane / 4
// (+ 8 for i >= 2) and query j * 8 + (lane % 4) * 2 + (i & 1).
template <int NT, int TERMS, bool kScores>
__global__ void __launch_bounds__(kMmaThreads)
query_mma_kernel(const uint16_t* __restrict__ feats,   // bf16 [S, K, N, D]
                 const uint8_t* __restrict__ mask,     // [S, K, N]
                 const uint16_t* __restrict__ tparts,  // bf16 [Q, TERMS, S, K, D]
                 const uint8_t* __restrict__ tmask,    // [Q, S, K]
                 const float* __restrict__ weights,    // [Q, S] (scores only)
                 float* __restrict__ out,              // avg [Q, S, N] | scores [Q, N]
                 int32_t* __restrict__ counts_out,     // [Q, S, N] (avg only)
                 int Q, int S, int K, int N, int D, int vec) {
  constexpr int kQRows = NT * 8;
  constexpr int kRows = kTileM + TERMS * kQRows;  // index rows, then term-major targets
  constexpr int kStage = kRows * kLdS;            // bf16 elements per stage
  extern __shared__ __align__(16) uint16_t ring[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int members = S * K;
  const int nchunk = (D + kChunkK - 1) / kChunkK;
  const int total = members * nchunk;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTileM;

  // Fill the stage of iteration `it` (member it / nchunk, d-slice it % nchunk)
  // and commit it as one cp.async group (empty past the end, so that the
  // group count stays in step with the iterations).
  auto issue = [&](int it) {
    if (it < total) {
      const int member = it / nchunk;
      const int d0 = (it - member * nchunk) * kChunkK;
      uint16_t* st = ring + (it % kStages) * kStage;
      if (vec) {  // D % 8 == 0, 16-byte aligned rows
        for (int i = tid; i < kRows * kPieces; i += kMmaThreads) {
          const int r = i / kPieces;
          const int c = (i % kPieces) * 8;
          const uint16_t* src;
          bool ok;
          if (r < kTileM) {
            ok = n0 + r < N && d0 + c < D;
            src = feats + (static_cast<int64_t>(member) * N + n0 + r) * D + d0 + c;
          } else {
            const int t = (r - kTileM) / kQRows;
            const int q = (r - kTileM) % kQRows;
            ok = q < Q && d0 + c < D;
            src = tparts + ((static_cast<int64_t>(q) * TERMS + t) * members + member) * D
                  + d0 + c;
          }
          cp_async16(smem_addr(st + r * kLdS + c), ok ? src : feats, ok);
        }
      } else {  // any D: element by element, zeros past N, Q and D
        for (int i = tid; i < kRows * kChunkK; i += kMmaThreads) {
          const int r = i / kChunkK;
          const int c = i % kChunkK;
          uint16_t v = 0;
          if (d0 + c < D) {
            if (r < kTileM) {
              if (n0 + r < N)
                v = feats[(static_cast<int64_t>(member) * N + n0 + r) * D + d0 + c];
            } else {
              const int t = (r - kTileM) / kQRows;
              const int q = (r - kTileM) % kQRows;
              if (q < Q)
                v = tparts[((static_cast<int64_t>(q) * TERMS + t) * members + member) * D
                           + d0 + c];
            }
          }
          st[r * kLdS + c] = v;
        }
      }
    }
    cp_async_commit();
  };

  float acc[NT][4], sum[NT][4], num[NT][4];
  int cnt[NT][4];
  bool valid[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[j][i] = sum[j][i] = num[j][i] = 0.0f;
      cnt[j][i] = 0;
      valid[j][i] = true;
    }
  }

  const int64_t n_a = n0 + warp * 16 + (lane >> 2);  // fragment rows n_a, n_a + 8
  const int64_t n_b = n_a + 8;
  const bool in_a = n_a < N;
  const bool in_b = n_b < N;
  const int qc = (lane & 3) * 2;

  // ldmatrix row addresses, in bytes from a stage's start. A (x4): lanes
  // 0-15 give rows 0-15 at k 0, lanes 16-31 the same rows at k 8. B (x4 over
  // n-tiles j, j+1): matrix lane / 8 is n-tile j + (lane / 16), k half
  // (lane / 8) % 2; (x2, NT = 1): lanes 0-15 give n-tile 0 at k 0 and k 8.
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t a_off = ((warp * 16 + (lane & 15)) * kLdS + (lane >> 4) * 8) * 2;
  const uint32_t b_off =
      ((kTileM + (NT > 1 ? (lane >> 4) * 8 : 0) + (lane & 7)) * kLdS
       + ((lane >> 3) & 1) * 8) * 2;

#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  int member = 0, chunk = 0;
#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();  // the stage of `it` has landed ...
    __syncthreads();               // ... for all threads; the stage of it-1 is free
    issue(it + kStages - 1);

    const uint32_t st = ring_s + (it % kStages) * kStage * 2;
    const int ksteps = (min(kChunkK, D - chunk * kChunkK) + 15) / 16;
#pragma unroll
    for (int kk = 0; kk < kChunkK / 16; ++kk) {
      if (kk < ksteps) {
        uint32_t a[4];
        ldsm_x4(a, st + a_off + kk * 32);
#pragma unroll
        for (int t = TERMS - 1; t >= 0; --t) {  // t_lo first, t_hi last
          const uint32_t tb = st + b_off + t * kQRows * kLdS * 2 + kk * 32;
          if constexpr (NT == 1) {
            uint32_t b[2];
            ldsm_x2(b, tb);
            mma_bf16(acc[0], a, b[0], b[1]);
          } else {
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
              uint32_t b[4];
              ldsm_x4(b, tb + j * 8 * kLdS * 2);
              mma_bf16(acc[j], a, b[0], b[1]);
              mma_bf16(acc[j + 1], a, b[2], b[3]);
            }
          }
        }
      }
    }

    if (++chunk < nchunk) continue;
    // member (s, k) is complete: masked sums and counts, as in the f32 body
    chunk = 0;
    const int s = member / K;
    const bool stream_done = member - s * K == K - 1;
    const bool m_a = in_a && mask[static_cast<int64_t>(member) * N + n_a] != 0;
    const bool m_b = in_b && mask[static_cast<int64_t>(member) * N + n_b] != 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = j * 8 + qc + e;
        const bool t_on = q < Q && tmask[static_cast<int64_t>(q) * members + member];
        if (m_a && t_on) {
          sum[j][e] += acc[j][e];
          cnt[j][e] += 1;
        }
        if (m_b && t_on) {
          sum[j][e + 2] += acc[j][e + 2];
          cnt[j][e + 2] += 1;
        }
        acc[j][e] = acc[j][e + 2] = 0.0f;
      }
    }
    ++member;
    if (stream_done) {
      // stream s is complete: its epilogue
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = j * 8 + qc + (i & 1);
          const int64_t n = i < 2 ? n_a : n_b;
          if (q < Q && (i < 2 ? in_a : in_b)) {
            const float avg = sum[j][i] / static_cast<float>(max(cnt[j][i], 1));
            if (kScores) {
              const float dev = weights[q * S + s] * (1.0f - avg);
              num[j][i] = num[j][i] + dev * dev;
              valid[j][i] = valid[j][i] && cnt[j][i] > 0;
            } else {
              const int64_t o = (static_cast<int64_t>(q) * S + s) * N + n;
              out[o] = avg;
              counts_out[o] = cnt[j][i];
            }
          }
          sum[j][i] = 0.0f;
          cnt[j][i] = 0;
        }
      }
    }
  }

  if (kScores) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = j * 8 + qc + e;
        if (q >= Q) continue;
        float den = 0.0f;
        for (int s = 0; s < S; ++s) {
          const float w = weights[q * S + s];
          den = den + w * w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = e + 2 * h;
          if (!(h == 0 ? in_a : in_b)) continue;
          const float score = 1.0f - sqrtf(num[j][i] / den);
          out[static_cast<int64_t>(q) * N + (h == 0 ? n_a : n_b)] =
              valid[j][i] ? score : kNegInf;
        }
      }
    }
  }
}

template <int NT, int TERMS, bool kScores>
cudaError_t launch_mma(const void* feats, const void* mask, const void* tparts,
                       const void* tmask, const void* weights, void* out,
                       void* counts, int Q, int S, int K, int N, int D, int vec,
                       cudaStream_t stream) {
  auto kernel = query_mma_kernel<NT, TERMS, kScores>;
  constexpr int smem = kStages * (kTileM + TERMS * NT * 8) * kLdS * 2;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileM - 1) / kTileM);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const uint16_t*>(feats), static_cast<const uint8_t*>(mask),
      static_cast<const uint16_t*>(tparts), static_cast<const uint8_t*>(tmask),
      static_cast<const float*>(weights), static_cast<float*>(out),
      static_cast<int32_t*>(counts), Q, S, K, N, D, vec);
  return cudaGetLastError();
}

template <int TERMS, bool kScores>
cudaError_t dispatch_mma(const void* feats, const void* mask, const void* tparts,
                         const void* tmask, const void* weights, void* out,
                         void* counts, int Q, int S, int K, int N, int D, int vec,
                         cudaStream_t stream) {
#define VQ_LAUNCH(NT)                                                              \
  return launch_mma<NT, TERMS, kScores>(feats, mask, tparts, tmask, weights, out, \
                                        counts, Q, S, K, N, D, vec, stream)
  if (Q <= 8) VQ_LAUNCH(1);
  if (Q <= 16) VQ_LAUNCH(2);
  if (Q <= 32) VQ_LAUNCH(4);
  VQ_LAUNCH(8);
#undef VQ_LAUNCH
}

// One launch of K1 on `stream`. feats_bf16 == 0: f32 feats and f32 targets
// [Q, S, K, D] (terms must be 1); feats_bf16 != 0: bf16 feats and bf16
// targets [Q, terms, S, K, D], terms 1 or 3 (hi, mid, lo). scores == 0:
// avg+counts epilogue into out [Q, S, N] f32 and counts [Q, S, N] int32;
// scores != 0: out [Q, N] f32 from weights [Q, S]. vec: D and the row
// starts allow 16-byte loads.
cudaError_t launch_k1(const void* feats, int feats_bf16, const void* mask,
                      const void* targets, int terms, const void* tmask,
                      const void* weights, void* out, void* counts, int Q, int S,
                      int K, int N, int D, int scores, int vec, cudaStream_t st) {
  if (Q < 1 || Q > kMaxQ || S < 1 || K < 1 || N < 1 || D < 1
      || (feats_bf16 ? (terms != 1 && terms != 3) : terms != 1))
    return cudaErrorInvalidValue;
  if (feats_bf16 && terms == 3) {
    return scores ? dispatch_mma<3, true>(feats, mask, targets, tmask, weights, out,
                                          counts, Q, S, K, N, D, vec, st)
                  : dispatch_mma<3, false>(feats, mask, targets, tmask, weights, out,
                                           counts, Q, S, K, N, D, vec, st);
  }
  if (feats_bf16) {
    return scores ? dispatch_mma<1, true>(feats, mask, targets, tmask, weights, out,
                                          counts, Q, S, K, N, D, vec, st)
                  : dispatch_mma<1, false>(feats, mask, targets, tmask, weights, out,
                                           counts, Q, S, K, N, D, vec, st);
  }
  return scores ? dispatch_f32<true>(feats, mask, targets, tmask, weights, out,
                                     counts, Q, S, K, N, D, vec, st)
                : dispatch_f32<false>(feats, mask, targets, tmask, weights, out,
                                      counts, Q, S, K, N, D, vec, st);
}

}  // namespace

extern "C" {

int vq_query_max_q() { return kMaxQ; }

// One launch of K1. args: 17 slots of 64 bits (kernels/_launch.py), the
// arguments of launch_k1 above in its order: feats, feats_bf16, mask,
// targets, terms, tmask, weights, out, counts, Q, S, K, N, D, scores, vec,
// stream (pointers as addresses, 0 for null). Returns the cudaError_t of
// the launch (0 = success); the kernel's own faults surface at the
// caller's next synchronisation.
int vq_query_launch(const int64_t* args) {
  int64_t a[17];
  memcpy(a, args, sizeof a);
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  auto num = [&](int i) { return static_cast<int>(a[i]); };
  return static_cast<int>(launch_k1(
      ptr(0), num(1), ptr(2), ptr(3), num(4), ptr(5), ptr(6), ptr(7), ptr(8), num(9),
      num(10), num(11), num(12), num(13), num(14), num(15),
      reinterpret_cast<cudaStream_t>(a[16])));
}

}  // extern "C"
