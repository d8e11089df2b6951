// Shared pieces of the VGG conv1 stem kernels for Hopper (sm_90a):
// csrc/stem.cu (conv1_2 + pool1 over conv1_1's output) and
// csrc/stem_uint8.cu (the whole stem from the raw uint8 image).
//
// Both kernels are warp-specialised: one persistent 512-thread block per
// SM, whose warpgroups 0 and 1 are consumers and 2 and 3 producers, never
// meeting again after the split (setmaxnreg then moves 16 registers a
// thread from the producers to the consumers). Blocks walk output tiles
// of 8 conv rows x 32 conv columns (4 x 16 pooled pixels).
//
//   Producers stage a tile's conv1_1 activation y1 (bias, ReLU, the zero
//   border and the bf16 rounding already applied) as a 10 x 34 pixel halo
//   of 64 channels into one of two shared-memory buffers, pixel rows
//   padded to 72 bf16 so that ldmatrix reads are free of bank conflicts.
//   Each kernel file stages the halo its own way; that is all they differ
//   in. A pair of mbarriers per buffer ("full": every producer thread
//   arrives after its stores; "empty": every consumer thread arrives after
//   its last read) replaces block barriers, so the staging of tile n+1
//   runs under the MMAs of tile n. (A third buffer fits for stem.cu and
//   was measured: no faster.)
//
//   Consumers run conv1_2 as an implicit GEMM on wgmma.m64n64k16 bf16 ->
//   f32, K = 9 taps x 64 channels. B, conv1_2's weights, stays in shared
//   memory for the block's life as [tap][cout][cin] rows of exactly 128
//   bytes in the 128-byte swizzle (73,728 B) and is read by matrix
//   descriptor, once per warpgroup. A comes from registers: ldmatrix.x4
//   loads 16 x 16 fragments straight from the halo, a tap being only a
//   different start address. Register A leaves the mapping of M rows to
//   pixels free, so a warp's 16 rows are an 8-column patch of two conv
//   rows (rows i and i + 8 are vertical neighbours): the vertical half of
//   the 2x2 pool is one max inside a thread, the horizontal half one
//   shuffle with the lane 4 away. A descriptor-fed A would need the halo
//   in the swizzle with a tap's one-pixel shift inside the 1024-byte atom
//   and 8-row groups at one stride; the register feed has none of these
//   constraints and lets fragments be shared: at N = 64 a wgmma reads 2 KB
//   of B and 2 KB of A per 32 clocks of tensor-core time, which is all the
//   shared-memory pipe has (128 B/clock), so A traffic is what can give.
//   Each consumer warpgroup owns two M tiles (4 conv rows x 32 columns,
//   64 f32 accumulators a thread), and the three dy taps of both read
//   only six halo rows per (dx, k step): three ldmatrix.x4 feed six
//   wgmmas (1 KB of A per wgmma). The loop runs 12 such steps a tile with
//   the fragments double buffered, so that the loads of step s+1 run
//   under the wgmmas of step s. The epilogue pools in registers, adds b2,
//   applies ReLU (max commutes with both) and stores bf16 pool1.
//
// Why 8-row tiles and not 16 rows or a ring of halo rows: two padded
// halos of a 16 x 32 tile (2 x 88 KB) do not fit beside the weights in
// the 227 KB a block may take, and stem_uint8.cu needs 12 KB more. A
// 10 x 34 halo is 48 KB. The price is a read amplification of 1.33 (340
// halo pixels per 256 outputs, 1.20 for 16 rows), and for the uint8 stem
// 33 % more conv1_1 MMAs; both are paid by the producers, off the
// consumers' critical path. Independent tiles keep ragged shapes and
// small batches simple: a ring walking down a column strip would save
// the re-staging but tie a block to one strip of one image.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stem {

constexpr int kC = 64;                 // conv1_1 / conv1_2 channels out (conv1_2's in)
constexpr int kTileR = 8;              // conv rows per tile
constexpr int kTileC = 32;             // conv columns per tile
constexpr int kHaloR = kTileR + 2;
constexpr int kHaloC = kTileC + 2;
constexpr int kHaloPix = kHaloR * kHaloC;  // 340
constexpr int kPix = 72;               // padded bf16 stride of a halo pixel
constexpr int kConsumers = 256;        // warpgroups 0 and 1
constexpr int kProducers = 256;        // warpgroups 2 and 3
constexpr int kThreads = kConsumers + kProducers;
constexpr int kStages = 2;             // halo buffers
constexpr int kHaloBytes = kHaloPix * kPix * 2;   // 48,960
constexpr int kWeightBytes = 9 * kC * kC * 2;     // 73,728, unpadded: rows of 128 B
constexpr int kMaxDevices = 64;

// Dynamic shared memory, from a 1024-byte aligned base (the swizzle atom):
// the weights, the halo buffers, b1 and b2, the barriers, then whatever a
// kernel file adds from kCommonBytes on.
constexpr int kOffWeights = 0;
constexpr int kOffHalo = kOffWeights + kWeightBytes;
constexpr int kOffB1 = kOffHalo + kStages * kHaloBytes;
constexpr int kOffB2 = kOffB1 + kC * 4;
constexpr int kOffBars = kOffB2 + kC * 4;          // full[kStages], empty[kStages]
constexpr int kCommonBytes = kOffBars + 2 * kStages * 8;

static_assert(kHaloBytes % 16 == 0 && kOffBars % 8 == 0, "aligned shared-memory pieces");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory, declared __align__(1024): the swizzle
// atom's alignment, which the descriptors rely on.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  if (smem_u32(raw) & 1023u) __trap();
  return raw;
}

// ---- mma.sync pieces (conv1_1 of the uint8 stem, the stem probe) ----

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that
// outlasts ~2 s of clocks (a kernel takes milliseconds) traps, so that a
// broken hand-off surfaces as a launch error and not as a hung device.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 4000000000LL) __trap();
  }
}

// Register budgets after the roles split: the 64 K registers of an SM are
// 128 a thread at launch; the producers hand 16 each to the consumers.
// At 128 ptxas serialises the consumers' wgmmas for want of registers
// (64 accumulators and 40 fragment registers a thread are live).
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 144;\n");
}

__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 112;\n");
}

// Barrier 1 among the producer threads only.
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// ---- wgmma pieces ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps a fragment's registers live (and untouched) up to this point: an
// asynchronous wgmma reads them until its group has been waited for.
__device__ __forceinline__ void keep(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void keep(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a K-major operand in the 128-byte swizzle: rows of
// 128 B, 8-row groups 1024 B apart (SBO), the leading offset unused (1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// d (+)= a (64 x 16, registers) x b (16 x 64, shared memory by descriptor);
// with accumulate = 0, d = a x b whatever d held.
// a[0] / a[1]: rows g / g + 8 at k 2t, 2t + 1; a[2] / a[3]: the same rows at k + 8.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// ---- tiles ----

struct Tile {
  int b, y0, x0;  // image, first conv row, first conv column
};

__device__ __forceinline__ int tile_count(int batch, int h, int w) {
  return batch * ((h + kTileR - 1) / kTileR) * ((w + kTileC - 1) / kTileC);
}

__device__ __forceinline__ Tile tile_at(int tile, int h, int w) {
  const int tiles_y = (h + kTileR - 1) / kTileR;
  const int tiles_x = (w + kTileC - 1) / kTileC;
  const int b = tile / (tiles_y * tiles_x);
  const int rem = tile - b * tiles_y * tiles_x;
  return Tile{b, (rem / tiles_x) * kTileR, (rem % tiles_x) * kTileC};
}

// Block set-up, by every thread before the roles split: conv1_2's weights
// (9, 64, 64) bf16 [tap][cout][cin] into the swizzled rows (16-byte chunk
// c of row r lands at chunk c ^ (r & 7)), the biases, the barriers.
__device__ __forceinline__ void block_setup(unsigned char* smem,
                                            const __nv_bfloat16* __restrict__ w2t,
                                            const float* __restrict__ b1,
                                            const float* __restrict__ b2) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 9 * kC * 8; i += kThreads) {
    const int row = i >> 3, c = i & 7;
    *reinterpret_cast<uint4*>(smem + kOffWeights + row * 128 + ((c ^ (row & 7)) << 4)) =
        reinterpret_cast<const uint4*>(w2t + row * kC)[c];
  }
  if (tid < kC) {
    reinterpret_cast<float*>(smem + kOffB1)[tid] = b1[tid];
    reinterpret_cast<float*>(smem + kOffB2)[tid] = b2[tid];
  }
  if (tid == 0) {
    const uint32_t bars = smem_u32(smem + kOffBars);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, kProducers);
      mbar_init(bars + 8 * (kStages + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the weights were written through the generic proxy; wgmma reads them
  // through the asynchronous one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// The walk over this block's tiles, the same in both roles: iteration `it`
// uses buffer it % kStages in its round it / kStages.
struct Walk {
  int tile, stage;
  uint32_t round;
  __device__ __forceinline__ Walk() : tile(blockIdx.x), stage(0), round(0) {}
  __device__ __forceinline__ void next() {
    tile += gridDim.x;
    if (++stage == kStages) {
      stage = 0;
      round ^= 1u;
    }
  }
};

__device__ __forceinline__ uint32_t full_bar(unsigned char* smem, int stage) {
  return smem_u32(smem + kOffBars) + 8 * stage;
}

__device__ __forceinline__ uint32_t empty_bar(unsigned char* smem, int stage) {
  return smem_u32(smem + kOffBars) + 8 * (kStages + stage);
}

// A producer thread's turn-taking around its staging of one halo buffer.
__device__ __forceinline__ void producer_acquire(unsigned char* smem, const Walk& wk) {
  mbar_wait(empty_bar(smem, wk.stage), wk.round ^ 1u);  // the first round passes at once
}

__device__ __forceinline__ void producer_release(unsigned char* smem, const Walk& wk) {
  mbar_arrive(full_bar(smem, wk.stage));
}

// The consumer role, whole: conv1_2 + b2 + ReLU + 2x2/s2 max-pool of every
// tile of this block over the staged halos, stored as bf16 pool1
// (B, H/2, W/2, 64). Called by threads 0 .. kConsumers - 1.
__device__ __forceinline__ void consume_tiles(unsigned char* smem, __nv_bfloat16* __restrict__ out,
                                              int batch, int h, int w) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = tile_count(batch, h, w);
  const int ho = h / 2, wo = w / 2;
  const float* sb2 = reinterpret_cast<const float*>(smem + kOffB2);
  const uint64_t desc_w = desc_sw128(smem_u32(smem + kOffWeights));

  // M tile m of this warpgroup is the conv row pair 2 * wg + m of the tile;
  // this warp's 16 rows are columns 8 * wi + [0, 8) of its two rows. The
  // two M tiles and three dy taps of one (dx, k step) read the six halo
  // rows 4 * wg + [0, 6) of that column window: fragment q = 0..2 holds
  // rows 2q and 2q + 1, and tap dy of M tile m takes its upper row 2m + dy
  // and its lower row 2m + dy + 1 from them (register moves make the
  // fragments of the odd pairs), so three ldmatrix.x4 feed six wgmmas.
  // Lane l gives ldmatrix the row address of matrix j = l >> 3, row
  // r = l & 7: matrices 0 / 1 are the even / odd halo row at k 0..7,
  // matrices 2 / 3 at k 8..15.
  const int j = lane >> 3, r = lane & 7;
  const uint32_t lane_off =
      (((4 * wg + (j & 1)) * kHaloC + 8 * wi + r) * kPix + 8 * (j >> 1)) * 2;
  constexpr uint32_t kRowPairOff = 2 * kHaloC * kPix * 2;  // two halo rows down

  for (Walk wk; wk.tile < tiles; wk.next()) {
    const Tile tl = tile_at(wk.tile, h, w);
    const uint32_t a_base = smem_u32(smem + kOffHalo) + wk.stage * kHaloBytes + lane_off;
    mbar_wait(full_bar(smem, wk.stage), wk.round);

    float acc[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.0f;
    uint32_t a[2][5][4];  // [buffer][fragment: halo rows (f, f + 1) of the six][register]
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const int step = dx * 4 + kc, buf = step & 1;
        const uint32_t off = (dx * kPix + kc * 16) * 2;
#pragma unroll
        for (int q = 0; q < 3; ++q) ldmatrix_x4(a[buf][2 * q], a_base + q * kRowPairOff + off);
        // the fragments of the odd row pairs (1, 2) and (3, 4), from their neighbours
#pragma unroll
        for (int f = 1; f < 5; f += 2) {
          a[buf][f][0] = a[buf][f - 1][1];
          a[buf][f][1] = a[buf][f + 1][0];
          a[buf][f][2] = a[buf][f - 1][3];
          a[buf][f][3] = a[buf][f + 1][2];
        }
        wgmma_fence();
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          // tap's 64 x 64 block is 8192 B on, its k step 32 B inside the row
          const uint64_t desc = desc_w + (((dy * 3 + dx) * kC * 128 + kc * 32) >> 4);
#pragma unroll
          for (int m = 0; m < 2; ++m) wgmma_m64n64k16(acc[m], a[buf][2 * m + dy], desc);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's group is done with its fragments
        if (step > 0) {
#pragma unroll
          for (int f = 0; f < 5; ++f) keep(a[buf ^ 1][f]);
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int f = 0; f < 5; ++f) keep(a[1][f]);
    keep(acc[0]);
    keep(acc[1]);
    mbar_arrive(empty_bar(smem, wk.stage));

    // 2x2 pool: rows g and g + 8 of the fragment are vertical neighbours,
    // columns g and g ^ 1 sit in lanes 4 apart. Of each lane pair the even
    // one stores channel blocks 0..3 of the pooled pixel, the odd one 4..7.
    const int odd = g & 1;
    const int pcol = tl.x0 / 2 + 4 * wi + (g >> 1);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int prow = tl.y0 / 2 + 2 * wg + m;
      const bool inside = prow < ho && pcol < wo;
      __nv_bfloat16* dst = out + ((static_cast<size_t>(tl.b) * ho + prow) * wo + pcol) * kC;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float lo = fmaxf(acc[m][4 * i + k], acc[m][4 * i + 2 + k]);
          const float hi = fmaxf(acc[m][4 * (i + 4) + k], acc[m][4 * (i + 4) + 2 + k]);
          const float other = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 4);
          v[k] = fmaxf(odd ? hi : lo, other);
        }
        const int ch = (i + 4 * odd) * 8 + 2 * t;
        if (inside) {
          *reinterpret_cast<__nv_bfloat162*>(dst + ch) = __floats2bfloat162_rn(
              fmaxf(v[0] + sb2[ch], 0.0f), fmaxf(v[1] + sb2[ch + 1], 0.0f));
        }
      }
    }
  }
}

// Opts `kernel` into `bytes` of dynamic shared memory on the current
// device. The attribute belongs to the function on each device, so each
// kernel keeps its own `allowed` flags and sets it once per device.
template <typename Kernel>
cudaError_t smem_opt_in(bool (&allowed)[kMaxDevices], Kernel* kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = true;
  return err;
}

}  // namespace stem
