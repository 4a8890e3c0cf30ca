// P1: 3D max pool with TensorFlow SAME padding on channels-last-3d
// (NDHWC) volumes, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package pools with XLA's reduce_window.
// It was added for I3D (the two-stream Inflated 3D ConvNet of
// videoquery_torch/nn/i3d.py), whose 13 max pools a forward ran as an NHWC
// max_pool2d over (h, w), a -inf F.pad over t and strided torch.maximum
// calls: some eight passes over each tensor where two are compulsory.
//
// y[n, ot, oh, ow, c] = max over the window of x, the window of output o on
// an axis of n cells with kernel k and stride s starting at o * s - before,
// where SAME pads max((ceil(n / s) - 1) * s + k - n, 0) cells, the odd one
// at the end (before = total / 2). Cells past the input never win: they are
// -inf in shared memory and no padded copy exists in device memory. NaN
// propagates, as max_pool2d and torch.maximum propagate it. bf16 or f32.
//
// Bound: device-memory bytes, each input read once and each output written
// once (a max does no arithmetic to speak of). The design keeps the traffic
// near that:
//   - channels innermost, 16-byte vectors (8 bf16 or 4 f32 channels); a
//     block's channel slab is a contiguous run of each position, up to 8
//     vectors (128 bytes: narrower slabs measured slower, 16-byte ones 2.5x);
//   - a block owns an output tile of (h, w) positions times a slab and a run
//     of output t, and walks the input t planes of that run in order,
//     staging each plane's tile plus its (h, w) halo in shared memory once:
//     cp.async copies, three stages, two planes in flight while the block
//     computes a third, one barrier a plane. Cells past the input are -inf,
//     written once a stage (the same cells in every plane);
//   - each thread takes the (kh, kw) max of its positions from shared
//     memory and keeps the newest kt plane maxima in registers; an output's
//     t window is the max of the newest ones when its last plane arrives, so
//     no t plane is read twice inside a block. Only the t halo between two
//     blocks' runs and the (h, w) halo between tiles are read again, mostly
//     from L2.
// The tiling follows the shape, not the layer: the widest slab for which a
// tile fits a 16 KB stage and the block's 512 outputs; of the tiles that
// split each axis evenly, the one reading the fewest input cells (a tile
// that spans an axis reads no halo there: SAME's padding is never read);
// t runs of about 4,096 blocks a launch, at least 4 (kt - st) outputs
// long so that the re-read t halo adds at most a quarter.
//
// Offsets: 64-bit for the planes (I3D's first pool reads 0.8 G elements at
// 8 clips), 32-bit inside one plane (the wrapper checks H * W * C < 2^31).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 2;                          // output vectors a thread, a plane
constexpr int kMaxKt = 3;                          // t window held in registers
constexpr int kLoads = 4;                          // staged vectors a thread, a plane
constexpr int kPlaneVecs = kThreads * kLoads;      // 1,024 x 16 B = 16 KB a stage
constexpr int kStages = 3;                         // planes in shared memory
constexpr int kTileCap = 32;                       // outputs an axis of a tile
constexpr int kSlabCap = 8;                        // vectors of a slab
constexpr long long kTargetBlocks = 4096;
static_assert(kStages * kPlaneVecs * 16 <= 48 * 1024, "stages beyond the default 48 KB");

struct Geometry {
  int t, h, w, cvs;                                // input; cvs: 16-byte vectors a position
  int to, ho, wo;                                  // output
  int kt, kh, kw, st, sh, sw, pt, ph, pw;          // window, stride, SAME's before
  int slab, oh, ow, ih, iw;                        // tile: slab, outputs, staged inputs
  int chunk;                                       // output t a block
  int slabs, tiles_h, tiles_w, chunks;
};

template <bool kBf16>
__device__ __forceinline__ uint32_t max_word(uint32_t a, uint32_t b) {
  if constexpr (kBf16) {
    __nv_bfloat162 x, y;
    memcpy(&x, &a, 4);
    memcpy(&y, &b, 4);
    const __nv_bfloat162 r = __hmax2_nan(x, y);
    uint32_t out;
    memcpy(&out, &r, 4);
    return out;
  } else {
    const float x = __uint_as_float(a), y = __uint_as_float(b);
    return (x > y || x != x) ? a : b;              // a NaN on either side wins
  }
}

template <bool kBf16>
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(max_word<kBf16>(a.x, b.x), max_word<kBf16>(a.y, b.y),
                    max_word<kBf16>(a.z, b.z), max_word<kBf16>(a.w, b.w));
}

template <bool kBf16>
__device__ __forceinline__ uint4 neg_inf() {
  const uint32_t v = kBf16 ? 0xFF80FF80u : 0xFF800000u;
  return make_uint4(v, v, v, v);
}

__device__ __forceinline__ void copy_async(uint4* dst, const uint4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most kStages - 2 groups of copies, the newest, are in flight
__device__ __forceinline__ void wait_copies_but_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
max_pool3d_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, const Geometry g) {
  extern __shared__ uint4 stage[];                 // kStages staged planes
  long long b = blockIdx.x;
  const int slab = static_cast<int>(b % g.slabs);
  b /= g.slabs;
  const int tw = static_cast<int>(b % g.tiles_w);
  b /= g.tiles_w;
  const int th = static_cast<int>(b % g.tiles_h);
  b /= g.tiles_h;
  const int tc = static_cast<int>(b % g.chunks);
  const long long n = b / g.chunks;
  const int oh0 = th * g.oh, ow0 = tw * g.ow;
  const int ih0 = oh0 * g.sh - g.ph, iw0 = ow0 * g.sw - g.pw;
  const int c0 = slab * g.slab;
  const int ot0 = tc * g.chunk, ot1 = min(ot0 + g.chunk, g.to);
  const int plane_vecs = g.ih * g.iw * g.slab;

  // what this thread stages of each plane: an offset inside the input plane,
  // or -1 for a cell past the input, whose -inf is written once to every
  // stage (the same cells in every plane)
  int src[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int v = threadIdx.x + j * kThreads;
    src[j] = -1;
    if (v < plane_vecs) {
      const int cv = v % g.slab, r = v / g.slab;
      const int hh = ih0 + r / g.iw, ww = iw0 + r % g.iw;
      if (hh >= 0 && hh < g.h && ww >= 0 && ww < g.w) {
        src[j] = (hh * g.w + ww) * g.cvs + c0 + cv;
      } else {
        for (int q = 0; q < kStages; ++q) stage[q * plane_vecs + v] = neg_inf<kBf16>();
      }
    }
  }
  // the output vectors this thread computes: their window's first staged
  // vector, and their offset inside an output plane (-1: none)
  int base[kItems], dst[kItems];
  const int items = g.oh * g.ow * g.slab;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = threadIdx.x + k * kThreads;
    dst[k] = -1;
    base[k] = 0;
    if (i < items) {
      const int cv = i % g.slab, r = i / g.slab;
      const int oh = r / g.ow, ow = r % g.ow;
      if (oh0 + oh < g.ho && ow0 + ow < g.wo) {
        base[k] = (oh * g.sh * g.iw + ow * g.sw) * g.slab + cv;
        dst[k] = ((oh0 + oh) * g.wo + ow0 + ow) * g.cvs + c0 + cv;
      }
    }
  }
  const long long in_plane = static_cast<long long>(g.h) * g.w * g.cvs;
  const long long out_plane = static_cast<long long>(g.ho) * g.wo * g.cvs;

  // the planes of this block's outputs in order, each in some window (the
  // wrapper takes no t stride above the t kernel)
  const int first = max(0, ot0 * g.st - g.pt);
  const int last = min(g.t - 1, (ot1 - 1) * g.st - g.pt + g.kt - 1);
  // stage a plane (cp.async, 16 bytes a copy) two planes ahead of the one
  // computed; every thread commits one group a plane, empty past the last
  int staged = first, into = 0;
  auto stage_next = [&]() {
    if (staged <= last) {
      const uint4* plane = x + (n * g.t + staged) * in_plane;
      uint4* tile = stage + into * plane_vecs;
#pragma unroll
      for (int j = 0; j < kLoads; ++j)
        if (src[j] >= 0) copy_async(tile + threadIdx.x + j * kThreads, plane + src[j]);
      ++staged;
    }
    commit_copies();
    into = into == kStages - 1 ? 0 : into + 1;
  };
  for (int q = 0; q < kStages - 1; ++q) stage_next();

  // the newest plane maxima of each output vector, newest first
  uint4 ring[kItems][kMaxKt];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
#pragma unroll
    for (int r = 0; r < kMaxKt; ++r) ring[k][r] = neg_inf<kBf16>();

  int next = ot0;                                  // the next output t to write
  int cur = 0;
  for (int p = first; p <= last; ++p) {
    wait_copies_but_newest();                      // this thread's copies of plane p
    __syncthreads();                               // everyone's; plane p - 1 is done
    stage_next();                                  // into plane p - 1's stage
    const uint4* tile = stage + cur * plane_vecs;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (dst[k] < 0) continue;
      uint4 m = neg_inf<kBf16>();
      for (int dh = 0; dh < g.kh; ++dh) {
        const uint4* row = tile + base[k] + dh * g.iw * g.slab;
        for (int dw = 0; dw < g.kw; ++dw) m = vmax<kBf16>(m, row[dw * g.slab]);
      }
#pragma unroll
      for (int r = kMaxKt - 1; r > 0; --r) ring[k][r] = ring[k][r - 1];
      ring[k][0] = m;
    }
    // every output whose last plane inside the input is p
    while (next < ot1 && min(g.t - 1, next * g.st - g.pt + g.kt - 1) == p) {
      const int planes = p - max(0, next * g.st - g.pt) + 1;
      uint4* out = y + (n * g.to + next) * out_plane;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (dst[k] < 0) continue;
        uint4 v = ring[k][0];
#pragma unroll
        for (int r = 1; r < kMaxKt; ++r)
          if (r < planes) v = vmax<kBf16>(v, ring[k][r]);
        out[dst[k]] = v;
      }
      ++next;
    }
    cur = cur == kStages - 1 ? 0 : cur + 1;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// SAME's padding before the first cell of an axis
int same_before(int n, int k, int s) {
  const int total = (ceil_div(n, s) - 1) * s + k - n;
  return total > 0 ? total / 2 : 0;
}

// input cells of an axis of n read by all tiles of `tile` outputs: each
// tile's window span clipped to the input
long long axis_reads(int n, int k, int s, int before, int tile) {
  const int outs = ceil_div(n, s), span = (tile - 1) * s + k;
  long long cells = 0;
  for (int o = 0; o < outs; o += tile) {
    const int lo = o * s - before, hi = lo + span;
    cells += (hi < n ? hi : n) - (lo > 0 ? lo : 0);
  }
  return cells;
}

// The tiling of one launch (module note); false when no tile fits. The
// widest slab (a divisor of the position's vectors, at most kSlabCap) for
// which some (h, w) tile fits a stage and the block's threads, the tiles
// splitting each axis evenly into parts of at most kTileCap outputs; of
// those tiles the one that reads the fewest input cells, then the largest.
bool plan(long long n, Geometry& g) {
  int ohs[kTileCap], ows[kTileCap], nh = 0, nw = 0;
  long long rows[kTileCap], cols[kTileCap];
  for (int parts = ceil_div(g.ho, kTileCap); parts <= g.ho; ++parts) {
    const int oh = ceil_div(g.ho, parts);
    if (nh == 0 || oh != ohs[nh - 1]) {
      ohs[nh] = oh;
      rows[nh++] = axis_reads(g.h, g.kh, g.sh, g.ph, oh);
    }
  }
  for (int parts = ceil_div(g.wo, kTileCap); parts <= g.wo; ++parts) {
    const int ow = ceil_div(g.wo, parts);
    if (nw == 0 || ow != ows[nw - 1]) {
      ows[nw] = ow;
      cols[nw++] = axis_reads(g.w, g.kw, g.sw, g.pw, ow);
    }
  }
  long long best_reads = -1;
  for (int slab = g.cvs < kSlabCap ? g.cvs : kSlabCap; slab >= 1 && best_reads < 0; --slab) {
    if (g.cvs % slab) continue;
    for (int a = 0; a < nh; ++a) {
      for (int b = 0; b < nw; ++b) {
        const int oh = ohs[a], ow = ows[b];
        const int ih = (oh - 1) * g.sh + g.kh, iw = (ow - 1) * g.sw + g.kw;
        if (ih * iw * slab > kPlaneVecs || oh * ow * slab > kThreads * kItems) continue;
        const long long reads = rows[a] * cols[b];
        if (best_reads < 0 || reads < best_reads
            || (reads == best_reads && oh * ow > g.oh * g.ow)) {
          best_reads = reads;
          g.oh = oh;
          g.ow = ow;
          g.slab = slab;
        }
      }
    }
  }
  if (best_reads < 0) return false;
  g.ih = (g.oh - 1) * g.sh + g.kh;
  g.iw = (g.ow - 1) * g.sw + g.kw;
  g.slabs = g.cvs / g.slab;
  g.tiles_h = ceil_div(g.ho, g.oh);
  g.tiles_w = ceil_div(g.wo, g.ow);
  // t runs: about kTargetBlocks blocks, each run long enough that the t halo
  // it reads again (kt - st planes) adds at most a quarter
  const long long per_run = n * g.slabs * g.tiles_h * g.tiles_w;
  long long runs = (kTargetBlocks + per_run - 1) / per_run;
  if (runs > g.to) runs = g.to;
  g.chunk = ceil_div(g.to, static_cast<int>(runs));
  const int min_chunk = 4 * (g.kt > g.st ? g.kt - g.st : 0);
  if (g.chunk < min_chunk) g.chunk = min_chunk < g.to ? min_chunk : g.to;
  g.chunks = ceil_div(g.to, g.chunk);
  return true;
}

}  // namespace

// One launch of P1. args: 15 slots of 64 bits (kernels/_launch.py): x, y, n,
// t, h, w, c, kt, kh, kw, st, sh, sw, bf16, stream. x [n, t, h, w, c] and y
// [n, ceil(t / st), ceil(h / sh), ceil(w / sw), c] channels-last-3d, c * the
// element size a multiple of 16 bytes, both 16-byte aligned, kt <= 3.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int vq_max_pool3d(const int64_t* args) {
  int64_t a[15];
  memcpy(a, args, sizeof a);
  const uint4* x = reinterpret_cast<const uint4*>(a[0]);
  uint4* y = reinterpret_cast<uint4*>(a[1]);
  const long long n = a[2];
  const bool bf16 = a[13] != 0;
  Geometry g;
  g.t = static_cast<int>(a[3]);
  g.h = static_cast<int>(a[4]);
  g.w = static_cast<int>(a[5]);
  g.cvs = static_cast<int>(a[6] * (bf16 ? 2 : 4) / 16);
  g.kt = static_cast<int>(a[7]);
  g.kh = static_cast<int>(a[8]);
  g.kw = static_cast<int>(a[9]);
  g.st = static_cast<int>(a[10]);
  g.sh = static_cast<int>(a[11]);
  g.sw = static_cast<int>(a[12]);
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(a[14]);
  if (g.kt < 1 || g.kt > kMaxKt || g.kh < 1 || g.kw < 1 || g.st < 1 || g.st > g.kt ||
      g.sh < 1 || g.sw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  g.to = ceil_div(g.t, g.st);
  g.ho = ceil_div(g.h, g.sh);
  g.wo = ceil_div(g.w, g.sw);
  g.pt = same_before(g.t, g.kt, g.st);
  g.ph = same_before(g.h, g.kh, g.sh);
  g.pw = same_before(g.w, g.kw, g.sw);
  if (n == 0 || g.t == 0 || g.h == 0 || g.w == 0 || g.cvs == 0) return 0;
  if (!plan(n, g)) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = n * g.chunks * g.tiles_h * g.tiles_w * g.slabs;
  const size_t smem = kStages * sizeof(uint4) * g.ih * g.iw * g.slab;
  if (bf16)
    max_pool3d_kernel<true><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(x, y, g);
  else
    max_pool3d_kernel<false><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(x, y, g);
  return static_cast<int>(cudaGetLastError());
}
