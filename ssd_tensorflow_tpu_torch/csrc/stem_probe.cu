// Hopper (sm_90a) counterparts of the two stem probe tools' Pallas kernels.
//
// 1. probe_copy_kernel and probe_kernel<V> replace
//    tools/stem_kernel_probe.py's make_call and its bodies k_copy,
//    k_conv11, k_conv11_store, k_taps and k_taps_aligned: the stripped
//    variants that bisect the split stem's cost on the probe's own shapes.
//    Per tile (b, t) of a1 (B, T, 34, WP, 64) bf16, with w1 (64, 128) and
//    w2 (3, 3, 128, 128):
//      copy          out = a1[:16]
//      conv1_1       out = bf16(relu(a1[:16] @ w1))[..., :64]
//      conv1_1_store the same, through a shared-memory tile
//      taps n        y1 = bf16(relu(a1 @ w1)) (34 rows, zero column border),
//                    acc = the first n of the 9 packed 3x3 taps of y1 over
//                    128 channels, relu, max of row pairs, max of the
//                    channel halves: out (B, T, 16, WP, 64)
//      aligned       taps 9 with every tap read at column offset 0: wrong
//                    math on purpose, as in the TPU probe (which reads an
//                    unwritten scratch column there; here that column is
//                    the zero border, so the result is defined).
//    The 128 lanes are the TPU's width packing of two pixels; the port
//    keeps the probe's function, not the packing's purpose.
//
//    Bound: taps 9 is 2.6 TFLOP at full shape (operations, ~2.6 ms at the
//    bf16 peak); copy and conv1_1 move 1.07 GB (bytes, ~0.32 ms).
//
//    What is scarce: all nine taps' weights are 288 KB and do not fit a
//    block's 227 KB of shared memory beside a y1 halo at 272 B a pixel, so
//    they stream from L2 once per tile; and the shared-memory pipe (128
//    B/clock) carries 64 B/clock of B for wgmma at full rate, whatever N
//    is, before A and the weight stream are counted.
//
//    Design of probe_kernel<V>: one persistent block per SM, 384 threads,
//    roles split after set-up (setmaxnreg: 232 registers a consumer
//    thread, 40 a producer thread) and meeting only on mbarriers:
//      warps 8, 10, 11 stage the a1 pixels of the next tile with 16-byte
//               cp.async (zero-filled outside [0, WP), which makes the
//               zero border of y1, as conv1_1 has no bias), rows of 128 B
//               with 16-byte chunk c of pixel p at chunk c ^ (p & 7), so
//               that ldmatrix reads are free of bank conflicts without
//               padding. It is asked for the next tile as soon as the
//               consumers have read this tile's pixels, i.e. before the
//               first tap, so conv1_1's operand is there when the taps end.
//      warp 9   streams the weights: ops/stem_probe.py lays w1 and each
//               tap's two 64-channel K halves out once as 19 "slots" of
//               [128 cout][64 cin] bf16 rows of 128 B, already in the
//               128-byte swizzle the wgmma descriptor reads, so one lane
//               lands a slot with one 16 KB cp.async.bulk that completes
//               on the slot's "full" mbarrier. A ring of five slots keeps
//               two taps in flight under the MMAs; consumers hand a slot
//               back on its "empty" mbarrier once the wgmmas that read it
//               have completed. No block barrier stands around a copy.
//      warpgroups 0, 1 (consumers) run conv1_1 of the staged pixels on
//               wgmma (K = 64, A by ldmatrix from the stage, B the w1
//               slot, as groups of N = 64 with two in flight, so that the
//               wgmmas of one run under the epilogue of the other) and
//               write relu, rounded to bf16, with stmatrix into the y1
//               halo (10 x 34 pixels x 128 channels, pixel rows padded to
//               272 B for ldmatrix); then the taps as wgmma.m64n128k16
//               with A by ldmatrix from the halo (a tap is only another
//               start address) and B by descriptor from the slot,
//               fragments double buffered so that the loads of step s + 1
//               run under the wgmmas of step s. A tile is 8 conv rows x 32
//               columns; each warpgroup owns two M tiles of two conv rows
//               each (128 f32 accumulators a thread), a warp's 16 rows
//               being 8 columns of a row pair, so that both pools (row
//               pairs, channel halves c and c + 64) are maxima inside a
//               thread; a 4 x 4 transpose across each quad of lanes then
//               makes every store 16 bytes. Two consumer-only named
//               barriers a tile fence the halo.
//    Alternatives reckoned: a 16 x 32 tile would halve the weight stream
//    but needs 512 accumulators' worth of registers or a 166 KB halo; six
//    slots (three taps, which would let the dy taps share fragments as the
//    stems do) miss the budget by 2 KB with the padded halo; a cluster
//    with multicast halves L2 reads (9.9 TB in all at the probe's shape)
//    but not the shared-memory writes, and L2 serves the ~3 TB/s this takes.
//    The conv1_1 variants use the same staging (three 32 KB stages in
//    flight, as they are bound by bytes) and conv1_1 on wgmma with N = 64.
// 2. lane_unflatten_sum_kernel replaces tools/stem_uint8_probe.py's
//    probe_reshape kernel: (R, 6N) bf16 -> (R, N) bf16, each output the
//    float32 sum of its group of 6 in order, rounded once. At the probe's
//    (36, 1536) it moves 110 KB in and 18 KB out: 0.04 us at 3.35 TB/s,
//    far under what any launch takes, so what bounds it is the launch and
//    one round trip to device memory. The groups are consecutive in the
//    flat input whatever R is, so the kernel indexes flat: a thread reads
//    four groups (48 bytes) as three 16-byte ld.global.nc loads, all in
//    flight at once, and writes their four sums as one 8-byte store; the
//    grid is as few 128-thread blocks as one wave needs (18 at the probe's
//    shape), striding over the rest. The last R*N % 4 groups, and every
//    group of an input not 16-byte aligned, are summed one at a time.
//    launch_floor_kernel is the same launch with an empty body: the
//    practical bound of the row, timed beside it.

#include "stem_common.cuh"

namespace {

using stem::desc_sw128;
using stem::keep;
using stem::kMaxDevices;
using stem::ldmatrix_x4;
using stem::mbar_arrive;
using stem::mbar_init;
using stem::mbar_wait;
using stem::smem_u32;
using stem::wgmma_commit;
using stem::wgmma_fence;
using stem::wgmma_wait;

constexpr int kRowsIn = 34;
constexpr int kRowsOut = 16;
constexpr int kCin = 64;
constexpr int kCmid = 128;
constexpr int kTileR = 8;      // rows of a tile (conv rows for the taps, pixel rows for conv1_1)
constexpr int kTileC = 32;     // packed columns of a tile
constexpr int kTilePix = kTileR * kTileC;
constexpr int kHaloR = kTileR + 2;
constexpr int kHaloC = kTileC + 2;
constexpr int kHaloPix = kHaloR * kHaloC;  // 340
constexpr int kYStride = 136;  // bf16 per y1 pixel in shared memory (272 B)
constexpr int kConsumers = 256;
constexpr int kThreads = 384;
constexpr int kStagers = 96;    // threads that stage a1 pixels
constexpr int kSlotBytes = kCmid * kCin * 2;  // 16,384: [128 cout][64 cin]
constexpr int kCopyThreads = 256;
constexpr int kCopyC = 16;     // packed columns of a copy tile

enum Variant { kCopy = 0, kConv11 = 1, kConv11Store = 2, kTaps = 3, kTapsAligned = 4 };

// Dynamic shared memory of probe_kernel<V>, from a 1024-byte aligned base.
template <int V>
struct Layout {
  static constexpr bool kIsTaps = V == kTaps || V == kTapsAligned;
  static constexpr int kSlots = kIsTaps ? 5 : 1;
  static constexpr int kStages = kIsTaps ? 1 : 3;
  static constexpr int kStagePix = kIsTaps ? kHaloPix : kTilePix;
  static constexpr int kStageC = kIsTaps ? kHaloC : kTileC;  // pixels per stage row
  static constexpr int kStageBytes = kStagePix * kCin * 2;
  static constexpr int kMTiles = (kStagePix + 63) / 64;
  static constexpr int kOffStage = kSlots * kSlotBytes;
  static constexpr int kOffY = kOffStage + kStages * kStageBytes;
  static constexpr int kYBytes = V == kConv11 ? 0 : kMTiles * 64 * kYStride * 2;  // whole M tiles
  static constexpr int kOffBars = kOffY + kYBytes;  // full, empty per slot; full, empty per stage
  static constexpr int kBytes = kOffBars + 2 * (kSlots + kStages) * 8;
  static_assert(kOffBars % 8 == 0 && kOffY % 16 == 0 && kBytes <= 232448, "shared-memory layout");

  static __device__ __forceinline__ uint32_t bar(unsigned char* smem, int i) {
    return smem_u32(smem + kOffBars) + 8 * i;
  }
  static __device__ __forceinline__ uint32_t slot_full(unsigned char* s, int i) { return bar(s, i); }
  static __device__ __forceinline__ uint32_t slot_empty(unsigned char* s, int i) {
    return bar(s, kSlots + i);
  }
  static __device__ __forceinline__ uint32_t stage_full(unsigned char* s, int i) {
    return bar(s, 2 * kSlots + i);
  }
  static __device__ __forceinline__ uint32_t stage_empty(unsigned char* s, int i) {
    return bar(s, 2 * kSlots + kStages + i);
  }
};

// A position in a ring of N buffers: `round` is the parity its consumer
// waits for on "full"; its producer waits for round ^ 1 on "empty" (the
// first round passes at once).
template <int N>
struct Ring {
  int idx = 0;
  uint32_t round = 0;
  __device__ __forceinline__ void next() {
    if (++idx == N) {
      idx = 0;
      round ^= 1u;
    }
  }
};

struct Tile {
  int bt, r0, c0, x0;  // (b, t) tile; first a1 row and column staged; first output column
};

template <int V>
__host__ __device__ __forceinline__ int tile_count(int bts, int wp) {
  return bts * (Layout<V>::kIsTaps ? 4 : 2) * ((wp + kTileC - 1) / kTileC);
}

template <int V>
__device__ __forceinline__ Tile tile_at(int tile, int wp) {
  const int cts = (wp + kTileC - 1) / kTileC;
  const int per_bt = (Layout<V>::kIsTaps ? 4 : 2) * cts;
  const int bt = tile / per_bt, rem = tile - bt * per_bt;
  const int rt = rem / cts, x0 = (rem - rt * cts) * kTileC;
  return Tile{bt, rt * kTileR, Layout<V>::kIsTaps ? x0 - 1 : x0, x0};
}

__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void keep(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PROBE_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define PROBE_D16(i) PROBE_D4(i), PROBE_D4(i + 4), PROBE_D4(i + 8), PROBE_D4(i + 12)

// d += a (64 x 16, registers) x b (16 x 128, shared memory by descriptor);
// the fragment layouts are those of stem::wgmma_m64n64k16 with 16 N blocks.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : PROBE_D16(0), PROBE_D16(16), PROBE_D16(32), PROBE_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef PROBE_D16
#undef PROBE_D4

// relu of two floats, rounded to bf16 and packed (x in the low half)
__device__ __forceinline__ uint32_t relu_bf162(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(x, 0.0f), fmaxf(y, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// In an accumulator fragment the four lanes t of a quad hold channels
// 2t, 2t + 1 of each 8-channel N block. v[k] being this lane's pair of N
// block k of four, returns N block t whole (16 bytes: the pairs of lanes
// 0..3 in order), a 4 x 4 transpose across the quad in two butterfly steps.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int t) {
  const bool odd = t & 1, high = t & 2;
  const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  const uint32_t z0 = odd ? r0 : v[0], z1 = odd ? v[1] : r0;
  const uint32_t z2 = odd ? r1 : v[2], z3 = odd ? v[3] : r1;
  const uint32_t s0 = __shfl_xor_sync(0xffffffffu, high ? z0 : z2, 2);
  const uint32_t s1 = __shfl_xor_sync(0xffffffffu, high ? z1 : z3, 2);
  return high ? make_uint4(s0, s1, z2, z3) : make_uint4(z0, z1, s0, s1);
}

// ---- producers ----

// Warps 8, 10 and 11 (thread `lane` of their kStagers): the a1 pixels of
// each tile of this block into the stage ring.
template <int V>
__device__ __forceinline__ void stage_pixels(unsigned char* smem,
                                             const __nv_bfloat16* __restrict__ a1, int bts,
                                             int wp, int lane) {
  using L = Layout<V>;
  const int tiles = tile_count<V>(bts, wp);
  Ring<L::kStages> st;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, st.next()) {
    const Tile tl = tile_at<V>(tile, wp);
    const __nv_bfloat16* src =
        a1 + (static_cast<size_t>(tl.bt) * kRowsIn + tl.r0) * wp * kCin;
    const uint32_t dst = smem_u32(smem + L::kOffStage) + st.idx * L::kStageBytes;
    mbar_wait(L::stage_empty(smem, st.idx), st.round ^ 1u);
    for (int i = lane; i < L::kStagePix * 8; i += kStagers) {
      const int p = i >> 3, c = i & 7;
      const int r = p / L::kStageC, gc = tl.c0 + p - r * L::kStageC;
      const bool inside = gc >= 0 && gc < wp;
      const __nv_bfloat16* q = src + (static_cast<size_t>(r) * wp + (inside ? gc : 0)) * kCin + c * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       dst + p * 128 + ((c ^ (p & 7)) << 4)),
                   "l"(q), "r"(inside ? 16 : 0)
                   : "memory");
    }
    // arrives once this thread's copies have landed (the barrier counts kStagers)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     L::stage_full(smem, st.idx))
                 : "memory");
  }
}

__device__ __forceinline__ void load_slot(uint32_t dst, const unsigned char* src, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(kSlotBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(kSlotBytes), "r"(bar)
      : "memory");
}

// One lane of warp 9: the weight slots in the order the consumers read
// them. Taps: per tile w1 (slot 0), then the K halves of taps 0 .. n - 1
// (slots 1 .. 2n). The conv1_1 variants: w1 once.
template <int V>
__device__ __forceinline__ void stream_weights(unsigned char* smem,
                                               const unsigned char* __restrict__ wslots, int bts,
                                               int wp, int n_taps) {
  using L = Layout<V>;
  const uint32_t base = smem_u32(smem);
  if (!L::kIsTaps) {
    load_slot(base, wslots, L::slot_full(smem, 0));
    return;
  }
  const int tiles = tile_count<V>(bts, wp);
  Ring<L::kSlots> ring;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    for (int s = 0; s <= 2 * n_taps; ++s, ring.next()) {
      mbar_wait(L::slot_empty(smem, ring.idx), ring.round ^ 1u);
      load_slot(base + ring.idx * kSlotBytes, wslots + static_cast<size_t>(s) * kSlotBytes,
                L::slot_full(smem, ring.idx));
    }
  }
}

// ---- consumers ----

template <int V>
__device__ __forceinline__ void consume_tiles(unsigned char* smem, __nv_bfloat16* __restrict__ out,
                                              int bts, int wp, int n_taps) {
  using L = Layout<V>;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix: lane l gives the row address of matrix j = l >> 3, row r =
  // l & 7; matrices 0 / 1 are fragment rows 0..7 / 8..15 at k 0..7,
  // matrices 2 / 3 the same rows at k 8..15.
  const int j = lane >> 3, r = lane & 7;
  const int tiles = tile_count<V>(bts, wp);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L::kOffY);

  // conv1_1 is a plain GEMM over the staged pixels in their linear order:
  // row i of M tile mt is pixel 64 mt + i of the stage (and of the halo).
  const int p_lane = 16 * wi + 8 * (j & 1) + r;
  // taps: M tile m of this warpgroup is conv rows 4 wg + 2 m + {0, 1} of
  // the tile; this warp's 16 rows are columns 8 wi + [0, 8) of the two.
  const uint32_t y_lane = smem_u32(ys) +
      (((4 * wg + (j & 1)) * kHaloC + 8 * wi + r) * kYStride + 8 * (j >> 1)) * 2;
  constexpr uint32_t kRowPair = 2 * kHaloC * kYStride * 2;  // two halo rows down

  Ring<L::kStages> st;
  Ring<L::kSlots> ring;
  if (!L::kIsTaps) mbar_wait(L::slot_full(smem, 0), 0);  // w1, once

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, st.next()) {
    const Tile tl = tile_at<V>(tile, wp);
    __nv_bfloat16* o = out + static_cast<size_t>(tl.bt) * kRowsOut * wp * kCin;

    // ---- conv1_1 of the staged pixels ----
    const uint32_t a_base = smem_u32(smem + L::kOffStage) + st.idx * L::kStageBytes;
    const int w1_slot = ring.idx;
    mbar_wait(L::stage_full(smem, st.idx), st.round);
    if (L::kIsTaps) {
      mbar_wait(L::slot_full(smem, ring.idx), ring.round);
      ring.next();
    }
    const uint64_t desc_w1 = desc_sw128(smem_u32(smem) + w1_slot * kSlotBytes);
    // M tiles wg, wg + 2, ... of this warpgroup, each as kHalves wgmma
    // groups of N = 64 (the taps need all 128 channels of y1, the conv1_1
    // variants the first 64), two groups in flight: the wgmmas of the next
    // run under the epilogue of this one, at 64 accumulators a thread.
    constexpr int kHalves = L::kIsTaps ? 2 : 1;
    constexpr int kItems = (L::kMTiles / 2) * kHalves;
    float c[2][32];
    uint32_t a1f[2][4][4];  // the fragments of an M tile, shared by its halves
    auto issue = [&](int mt, int half, float(&cc)[32], uint32_t(&af)[4][4]) {
      if (half == 0) {
        const int p = min(64 * mt + p_lane, L::kStagePix - 1);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          ldmatrix_x4(af[kc], a_base + p * 128 + (((2 * kc + (j >> 1)) ^ (p & 7)) << 4));
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)  // couts 64 half + [0, 64) are 8192 B on, a k step 32 B
        stem::wgmma_m64n64k16(cc, af[kc], desc_w1 + ((half * 8192 + kc * 32) >> 4), kc > 0);
      wgmma_commit();
    };
    issue(wg, 0, c[0], a1f[0]);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int km = i / kHalves, half = i % kHalves, mt = wg + 2 * km;
      if (i + 1 < kItems) {
        issue(wg + 2 * ((i + 1) / kHalves), (i + 1) % kHalves, c[(i + 1) & 1],
              a1f[((i + 1) / kHalves) & 1]);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();  // this thread is done with the stage and w1
        mbar_arrive(L::stage_empty(smem, st.idx));
        if (L::kIsTaps) mbar_arrive(L::slot_empty(smem, w1_slot));
      }
      if (half == kHalves - 1) {
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) keep(a1f[km & 1][kc]);
      }
      keep(c[i & 1]);
      const float(&ck)[32] = c[i & 1];
      if (V == kConv11) {  // relu, rounded, straight to out
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          const int pp = 64 * mt + 16 * wi + g + 8 * row;
          const int pr = pp / kTileC, pc = pp - pr * kTileC;
          __nv_bfloat16* dst = o + (static_cast<size_t>(tl.r0 + pr) * wp + tl.x0 + pc) * kCin;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            uint32_t v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              v[k] = relu_bf162(ck[4 * (4 * q + k) + 2 * row], ck[4 * (4 * q + k) + 2 * row + 1]);
            const uint4 chunk = quad_transpose(v, t);
            if (tl.x0 + pc < wp) reinterpret_cast<uint4*>(dst)[4 * q + t] = chunk;
          }
        }
        continue;
      }
      // every consumer is done with the shared y1 tile of the tile before
      if (i == 0) consumer_barrier();
      // relu, rounded, into the y1 tile: one stmatrix.x4 stores rows g and
      // g + 8 of two N blocks, lane l giving the address of matrix l >> 3
      // (bit 0: the row half, bit 1: the N block), row l & 7
      const uint32_t y_row = smem_u32(ys) +
          ((64 * mt + 16 * wi + 8 * (j & 1) + r) * kYStride + 64 * half + 8 * (j >> 1)) * 2;
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = relu_bf162(ck[4 * (nb + (q >> 1)) + 2 * (q & 1)],
                            ck[4 * (nb + (q >> 1)) + 2 * (q & 1) + 1]);
        asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         y_row + nb * 16),
                     "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                     : "memory");
      }
    }
    if (V == kConv11) continue;
    consumer_barrier();  // the shared y1 tile is whole

    if (V == kConv11Store) {  // its 64 channels -> out, 16 bytes a thread
      for (int i = tid; i < kTilePix * 8; i += kConsumers) {
        const int pp = i >> 3, pr = pp / kTileC, pc = pp - pr * kTileC;
        if (tl.x0 + pc < wp)
          reinterpret_cast<uint4*>(
              o + (static_cast<size_t>(tl.r0 + pr) * wp + tl.x0 + pc) * kCin)[i & 7] =
              reinterpret_cast<const uint4*>(ys + pp * kYStride)[i & 7];
      }
      continue;
    }

    // ---- the taps ----
    // (zeroed here: a first wgmma that overwrites them instead makes ptxas
    // serialise the loop's wgmmas, warning C7512)
    float acc[2][64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.0f;
    uint32_t a[2][2][4] = {};  // [buffer][M tile][register]
    int prev_slot = -1;
#pragma unroll 1
    for (int tap = 0; tap < n_taps; ++tap) {
      const int dy = tap / 3, dx = V == kTapsAligned ? 0 : tap - 3 * dy;
      const uint32_t a_tap = y_lane + ((dy * kHaloC + dx) * kYStride) * 2;
#pragma unroll 1
      for (int kh = 0; kh < 2; ++kh, ring.next()) {
        mbar_wait(L::slot_full(smem, ring.idx), ring.round);
        const uint64_t desc = desc_sw128(smem_u32(smem) + ring.idx * kSlotBytes);
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
          const int buf = kc & 1;
#pragma unroll
          for (int m = 0; m < 2; ++m)
            ldmatrix_x4(a[buf][m], a_tap + m * kRowPair + (kh * 64 + kc * 16) * 2);
          wgmma_fence();
#pragma unroll
          for (int m = 0; m < 2; ++m) wgmma_m64n128k16(acc[m], a[buf][m], desc + ((kc * 32) >> 4));
          wgmma_commit();
          wgmma_wait<1>();  // the step before is done with its fragments
#pragma unroll
          for (int m = 0; m < 2; ++m) keep(a[buf ^ 1][m]);
          // ... and, at a slot's first step, with the slot before
          if (kc == 0 && prev_slot >= 0) mbar_arrive(L::slot_empty(smem, prev_slot));
        }
        prev_slot = ring.idx;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      keep(a[0][m]);
      keep(a[1][m]);
      keep(acc[m]);
    }
    if (prev_slot >= 0) mbar_arrive(L::slot_empty(smem, prev_slot));

    // relu, max of the row pair (fragment rows g and g + 8) and of the
    // channel halves (N blocks nb and nb + 8); 16 bytes a store
    const int pcol = tl.x0 + 8 * wi + g;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int prow = tl.r0 / 2 + 2 * wg + m;
      __nv_bfloat16* dst = o + (static_cast<size_t>(prow) * wp + pcol) * kCin;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int nb = 4 * q + k;
          v[k] = relu_bf162(fmaxf(fmaxf(acc[m][4 * nb], acc[m][4 * nb + 2]),
                                  fmaxf(acc[m][4 * (nb + 8)], acc[m][4 * (nb + 8) + 2])),
                            fmaxf(fmaxf(acc[m][4 * nb + 1], acc[m][4 * nb + 3]),
                                  fmaxf(acc[m][4 * (nb + 8) + 1], acc[m][4 * (nb + 8) + 3])));
        }
        const uint4 chunk = quad_transpose(v, t);
        if (pcol < wp) reinterpret_cast<uint4*>(dst)[4 * q + t] = chunk;
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
probe_kernel(const __nv_bfloat16* __restrict__ a1, const unsigned char* __restrict__ wslots,
             __nv_bfloat16* __restrict__ out, int bts, int wp, int n_taps) {
  using L = Layout<V>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = stem::aligned_smem(smem_raw);
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kSlots; ++s) {
      mbar_init(L::slot_full(smem, s), 1);  // the streaming lane's expect_tx arrival
      mbar_init(L::slot_empty(smem, s), kConsumers);
    }
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(L::stage_full(smem, s), kStagers);
      mbar_init(L::stage_empty(smem, s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < kConsumers) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume_tiles<V>(smem, out, bts, wp, n_taps);
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = (threadIdx.x - kConsumers) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp != 1)
      stage_pixels<V>(smem, a1, bts, wp, (warp == 0 ? 0 : warp - 1) * 32 + lane);
    else if (lane == 0)
      stream_weights<V>(smem, wslots, bts, wp, n_taps);
  }
}

// out rows half * 8 + [0, 8), columns x0 + [0, 16) of each (b, t) tile
__global__ void __launch_bounds__(kCopyThreads)
probe_copy_kernel(const __nv_bfloat16* __restrict__ a1, __nv_bfloat16* __restrict__ out, int bts,
                  int wp) {
  const int cbs = wp / kCopyC;
  const int tiles = bts * 2 * cbs;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bt = tile / (2 * cbs);
    const int rem = tile - bt * 2 * cbs;
    const int half = rem / cbs, x0 = (rem - half * cbs) * kCopyC;
    const __nv_bfloat16* a = a1 + static_cast<size_t>(bt) * kRowsIn * wp * kCin;
    __nv_bfloat16* o = out + static_cast<size_t>(bt) * kRowsOut * wp * kCin;
    for (int i = threadIdx.x; i < 8 * kCopyC * 8; i += kCopyThreads) {
      const int pix = i >> 3, r = half * 8 + pix / kCopyC, c = x0 + pix % kCopyC;
      reinterpret_cast<uint4*>(o + (static_cast<size_t>(r) * wp + c) * kCin)[i & 7] =
          reinterpret_cast<const uint4*>(a + (static_cast<size_t>(r) * wp + c) * kCin)[i & 7];
    }
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float sum6(const float* v) {
  float s = v[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) s = __fadd_rn(s, v[k]);
  return s;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

constexpr int kSumThreads = 128;

// groups: R * N. quads: how many groups of four the vector path takes (0
// when x is not 16-byte aligned); the rest, from 4 * quads on, go one at a
// time.
__global__ void __launch_bounds__(kSumThreads)
lane_unflatten_sum_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                          long long groups, long long quads) {
  const long long stride = static_cast<long long>(gridDim.x) * kSumThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (long long q = first; q < quads; q += stride) {
    const uint4 a = __ldg(xv + 3 * q), b = __ldg(xv + 3 * q + 1), c = __ldg(xv + 3 * q + 2);
    const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
    float s[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float v[6] = {bf16_lo(w[3 * g]), bf16_hi(w[3 * g]), bf16_lo(w[3 * g + 1]),
                          bf16_hi(w[3 * g + 1]), bf16_lo(w[3 * g + 2]), bf16_hi(w[3 * g + 2])};
      s[g] = sum6(v);
    }
    reinterpret_cast<uint2*>(out)[q] = make_uint2(pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]));
  }
  for (long long i = 4 * quads + first; i < groups; i += stride) {
    float v[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = __bfloat162float(x[6 * i + k]);
    out[i] = __float2bfloat16_rn(sum6(v));
  }
}

__global__ void __launch_bounds__(kSumThreads) launch_floor_kernel() {}

// As few blocks as one wave needs for one thread per four groups, at most
// max_blocks.
int sum_grid(long long groups, int max_blocks) {
  const long long blocks = ((groups + 3) / 4 + kSumThreads - 1) / kSumThreads;
  return static_cast<int>(blocks < max_blocks ? blocks : max_blocks);
}

bool g_smem_allowed[5][kMaxDevices] = {};

template <int V>
int launch(const void* a1, const void* wslots, void* out, int bts, int wp, int n_taps,
           int max_blocks, cudaStream_t stream) {
  const int grid = min(tile_count<V>(bts, wp), max_blocks);
  const cudaError_t err =
      stem::smem_opt_in(g_smem_allowed[V], probe_kernel<V>, Layout<V>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<V><<<grid, kThreads, Layout<V>::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a1), static_cast<const unsigned char*>(wslots),
      static_cast<__nv_bfloat16*>(out), bts, wp, n_taps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: 0 copy, 1 conv1_1, 2 conv1_1_store, 3 taps (n_taps of 9),
// 4 aligned (9 taps). a1: (B*T, 34, WP, 64) bf16; wslots: (19, 128, 64)
// bf16, slot 0 w1 and slot 1 + 2 tap + h the K half h of tap dy*3+dxp, each
// [cout][cin] with 16-byte chunk c of row r stored at chunk c ^ (r & 7)
// (ops/stem_probe.probe_weight_slots); out: (B*T, 16, WP, 64) bf16. All
// contiguous and 16-byte aligned, WP a multiple of 16. At most
// `max_blocks` persistent blocks, no more than there are tiles. Returns
// cudaGetLastError() after the launch.
extern "C" int stem_probe_launch(int variant, const void* a1, const void* wslots, void* out,
                                 int bts, int wp, int n_taps, int max_blocks, void* stream) {
  if (bts <= 0 || wp <= 0 || wp % kCopyC || max_blocks <= 0 || n_taps < 0 || n_taps > 9)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kCopy:
      probe_copy_kernel<<<min(bts * 2 * (wp / kCopyC), max_blocks), kCopyThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a1), static_cast<__nv_bfloat16*>(out), bts, wp);
      return static_cast<int>(cudaGetLastError());
    case kConv11: return launch<kConv11>(a1, wslots, out, bts, wp, 0, max_blocks, s);
    case kConv11Store: return launch<kConv11Store>(a1, wslots, out, bts, wp, 0, max_blocks, s);
    case kTaps: return launch<kTaps>(a1, wslots, out, bts, wp, n_taps, max_blocks, s);
    case kTapsAligned: return launch<kTapsAligned>(a1, wslots, out, bts, wp, 9, max_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (rows, 6n) bf16 contiguous, 2-byte aligned -> out: (rows, n) bf16,
// 8-byte aligned. At most max_blocks blocks.
extern "C" int lane_unflatten_sum_launch(const void* x, void* out, int rows, int n,
                                         int max_blocks, void* stream) {
  if (rows <= 0 || n <= 0 || max_blocks <= 0 || reinterpret_cast<uintptr_t>(out) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = static_cast<long long>(rows) * n;
  const long long quads = reinterpret_cast<uintptr_t>(x) % 16 ? 0 : groups / 4;
  lane_unflatten_sum_kernel<<<sum_grid(groups, max_blocks), kSumThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), groups, quads);
  return static_cast<int>(cudaGetLastError());
}

// The launch of lane_unflatten_sum_launch(rows, n, max_blocks) with an
// empty kernel: what launching that grid costs.
extern "C" int launch_floor_launch(int rows, int n, int max_blocks, void* stream) {
  if (rows <= 0 || n <= 0 || max_blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  launch_floor_kernel<<<sum_grid(static_cast<long long>(rows) * n, max_blocks), kSumThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
