// The int8 (W8A8) convolution of every int8 forward, whole, for Hopper
// (sm_90a): quantize, integer convolution, requantize in one kernel.
//
// Replaces no TPU kernel: the JAX package computes this conv with
// lax.conv_general_dilated on int8 operands and leaves it to XLA
// (ssd_tensorflow_tpu/models/quantized.py, _qconv). Before this kernel
// the card ran it as four passes through device memory (a quantize, an
// im2col copy, torch._int_mm, an addcmul), which ops/int8_conv.py keeps as
// the card's bit-exact yardstick (int8_qconv_plain).
//
// Input x: bf16 NHWC (B, H, W, cin); the filter staged by
// ops/int8_conv.stage_int8_weight: wk (Np, Kp) int8, row n holding output
// channel n's taps in (dy, dx, c) order over cp = cin rounded up to 4
// channels; inv: (1,) or (cin,) float32; mult, bias: (cout,) float32.
// Output: bf16 NHWC (B, Ho, Wo, cout). Per element, bit for bit as the
// four passes compute it:
//   1. xq = clamp(rint(float32(x) * inv[c]), -127, 127), one float32
//      multiply (__fmul_rn: nothing is contracted into it), half to even;
//      SAME padding pixels are int8 zeros;
//   2. exact int32 sums (K * 127^2 < 2^31 for every conv of the models);
//   3. v = fma(float(sum), mult[n], bias[n]) in float32, the multiply-add
//      that torch.addcmul contracts on the card;
//   4. one rounding to bf16, then ReLU where asked.
//
// What bounds it on this card: for most layers operations (int8 tensor
// cores, 1,979 TOP/s dense); for conv1_1 and conv1_2 of vgg512 bytes
// (their bf16 input read once and bf16 output written once, 0.67 and
// 1.28 ms at b64 against 0.03 and 0.63 ms of operations). The four
// passes moved ~6x those bytes (the int8 copy, a 9x im2col, the int32
// sums written and read back); here only x is read and only the output
// written, so the memory-bound layers can approach their bound and the
// rest are left to the MMAs.
//
// Design. Two routes, chosen by cin.
//
// * Channel route (cin a multiple of 16: every conv but the RGB stems),
//   qconv_channels: an implicit GEMM on int8 wgmma (m64nNk32, N = 64 when
//   cout <= 64, else 128), warp-specialised and persistent (one block an
//   SM). An output tile is a 16 x 16 patch of one image (8 x 16 and two
//   consumer warpgroups on small maps or a halo too big for shared
//   memory) x N channels; K is walked in steps of kc channels (32 for
//   3x3 filters, 64 for 1x1), all taps of the step at once. For a step,
//   the producer warpgroup's copy lane asks the TMA for the tile's input
//   halo ((tr - 1) * stride + (kh - 1) * dil + 1 rows by the same in
//   columns) of those channels as raw bf16, one 4-d tensor copy whose
//   out-of-range pixels read as zeros, which is the SAME padding; and for
//   the step's filter slices, bulk copies of the pre-tiled filter
//   (Int8Weight.tiles) that land as the wgmma descriptor's core matrices.
//   The producer's other three warps quantize the raw halo ONCE into an
//   int8 halo (pixel rows padded to kc + 16 bytes, so that ldmatrix's 8
//   rows of 16 bytes meet no bank twice). Each consumer warpgroup owns 64
//   output pixels: for every tap it takes its A fragment by ldmatrix from
//   the halo rows that tap reads (a tap is only another start address;
//   strides and dilations are address arithmetic), so no im2col exists
//   anywhere, and issues one wgmma on it. Two slots of halo and filter,
//   and up to four raw buffers in flight, hand steps over on mbarriers;
//   a tile's epilogue runs while the producer fills the next slots.
// * Small-cin route (conv1_1's 3 channels, the families' RGB stems),
//   qconv_small, one 128-pixel tile a block on mma.sync.m16n8k32.s8: the
//   halo (cin rounded up to 4 channels a pixel) is gathered and quantized
//   once into shared memory, and each step's A tile, im2col rows in the
//   staged (dy, dx, c) order, is copied out of it 4 bytes at a time; its K
//   is 27 to 196, so the tensor cores are not what bounds it.
//
// The epilogue applies steps 3 and 4 to the accumulators in registers; the
// four threads of a quad trade words with three shuffles so that each
// writes 8 channels of a pixel in one 16-byte store (2- or 4-byte stores
// when cout is not a multiple of 8, as the heads' 100 and 150). Edges are
// masked: any Ho, Wo, batch, cout, cin.

#include <cuda.h>

#include "stem_common.cuh"

namespace {

using stem::ldmatrix_x4;
using stem::mbar_arrive;
using stem::mbar_init;
using stem::mbar_wait;
using stem::smem_u32;

constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may take

// Everything a launch needs, computed once on the host (see the launch
// function): the conv, its tiling and its shared-memory layout.
struct Geo {
  const __nv_bfloat16* x;
  const int8_t* wk;
  const int8_t* wt;   // the channel route's filter tiles (ops/int8_conv.Int8Weight.tiles)
  const float* inv;
  const float* mult;
  const float* bias;
  __nv_bfloat16* out;
  int batch, h, w, cin, cout, kh, kw, stride, dil, pad_top, pad_left, ho, wo;
  int kp, np, cp, inv_len, relu;
  int tr, tc, hr, hc;   // output tile rows x columns; halo rows x columns
  int kc;               // a stage's channels (channel route) or K bytes (small-cin route)
  int lg_kc;            // log2(kc)
  int ps;               // bytes of an A row in shared memory: kc + 16
  int stages;
  int tiles_y, tiles_x, tiles_n;
  int off_a, off_b, off_raw, off_bar;  // shared-memory offsets
  int a_stage, b_stage, raw_stage;     // bytes of one halo, B and raw buffer
  int raw_bytes, group_bytes;          // bytes of a raw halo; of 8 filter rows of a stage
  int raw_depth;                       // raw buffers (steps of copies in flight)
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// `bytes` from global `src` to shared `dst` by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The box of `map` at (c, x, y, b) (elements; negative or past the end
// reads zeros) to shared `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c, int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b), "r"(bar)
      : "memory");
}

// d += a (16 x 32 s8, row) x b (32 x 8 s8, col), exact int32
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Step 1 for one element, as its low byte: clamp(rint(x * inv), -127,
// 127). The clamp goes first (rint is monotone and the bounds are
// integers, so the order does not matter), then x + 1.5 * 2^23 rounds to
// the nearest integer, ties to even, in the float32 adder: exact for |x|
// <= 127, and cheaper than a float-to-int conversion.
__device__ __forceinline__ uint32_t quant1(float x, float inv) {
  const float v = fminf(fmaxf(__fmul_rn(x, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

// Four such values (low bytes) into one word, element 0 in the low byte.
__device__ __forceinline__ uint32_t pack4(uint32_t q0, uint32_t q1, uint32_t q2, uint32_t q3) {
  return __byte_perm(__byte_perm(q0, q1, 0x0040), __byte_perm(q2, q3, 0x0040), 0x5410);
}

// The inverse scale of channel c: `inv0` when one scale serves every
// channel, else the shared-memory table's.
__device__ __forceinline__ float inv_of(const float* s_inv, int inv_len, float inv0, int c) {
  return inv_len == 1 ? inv0 : s_inv[min(c, inv_len - 1)];
}

// Four bf16 (two words, element 0 in the low half) of channels c .. c + 3
// -> four int8 in a word.
__device__ __forceinline__ uint32_t quant4(uint32_t w0, uint32_t w1, const float* s_inv,
                                           int inv_len, float inv0, int c) {
  return pack4(quant1(__uint_as_float(w0 << 16), inv_of(s_inv, inv_len, inv0, c)),
               quant1(__uint_as_float(w0 & 0xffff0000u), inv_of(s_inv, inv_len, inv0, c + 1)),
               quant1(__uint_as_float(w1 << 16), inv_of(s_inv, inv_len, inv0, c + 2)),
               quant1(__uint_as_float(w1 & 0xffff0000u), inv_of(s_inv, inv_len, inv0, c + 3)));
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

// Keeps registers live and untouched up to this point: an asynchronous
// wgmma reads its A fragment and accumulators until its group is waited for.
__device__ __forceinline__ void keep(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

template <int kNT>
__device__ __forceinline__ void keep(int (&d)[kNT][4]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(d[j][i])::"memory");
}

// Matrix descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 bytes, `lbo` bytes apart along K, `sbo` bytes apart along N.
__device__ __forceinline__ uint64_t desc_interleave(uint32_t smem_addr, uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (+)= a (64 x 32 s8, registers: a warp's 16 rows as in mma.m16n8k32) x
// b (32 x 64 s8, shared memory by descriptor), exact int32; d[j] is the
// thread's n8 block j (rows g, g + 8; columns 8j + 2t, + 1).
__device__ __forceinline__ void wgmma_n64(int (&d)[8][4], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, 1;\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// d (+)= a (64 x 32 s8, registers: a warp's 16 rows as in mma.m16n8k32) x
// b (32 x 128 s8, shared memory by descriptor), exact int32; d[j] is the
// thread's n8 block j (rows g, g + 8; columns 8j + 2t, + 1).
__device__ __forceinline__ void wgmma_n128(int (&d)[16][4], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, 1;\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
        "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
        "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
        "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
        "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
        "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
        "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
        "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
        "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <int kNT>
__device__ __forceinline__ void wgmma_n(int (&d)[kNT][4], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (kNT == 16) {
    wgmma_n128(d, a, desc);
  } else {
    wgmma_n64(d, a, desc);
  }
}

// The wgmmas of one stage of the channel route, for this warpgroup's 64
// rows: each tap (dy, dx) and 32-byte K step, the warp's A fragment by
// ldmatrix from its rows at a_lane + the tap's offset, B from the tap's
// slice of the stage's buffer ([n / 8][tap][kc / 16][8 rows][16 B]: the
// tap's slice b_tap bytes on, 8-row groups sbo bytes apart).
// The next step's fragment loads while this step's wgmma runs.
template <int kNT>
__device__ __forceinline__ void wgmma_stage(int (&acc)[kNT][4], uint32_t a_lane, uint32_t b_stage,
                                            int kh, int kw, uint32_t dy_step, uint32_t dx_step,
                                            uint32_t b_tap, int k32, uint32_t sbo) {
  const int steps = kh * kw * k32;
  int dy = 0, dx = 0, kk = 0;
  uint32_t a_off = 0, b_off = 0;  // the step's A offset and B slice
  auto next = [&]() {
    if (++kk == k32) {
      kk = 0;
      if (++dx == kw) {
        dx = 0;
        ++dy;
      }
    }
    a_off = dy * dy_step + dx * dx_step + kk * 32;
    b_off = (dy * kw + dx) * b_tap + kk * 256;  // a K step is two 128-byte core matrices
  };
  uint32_t a0[4], a1[4] = {0, 0, 0, 0};
  ldmatrix_x4(a0, a_lane);
  for (int s = 0; s < steps; s += 2) {
    wgmma_fence();
    wgmma_n<kNT>(acc, a0, desc_interleave(b_stage + b_off, 128, sbo));
    wgmma_commit();
    if (s + 1 == steps) break;
    next();
    wgmma_wait<1>();  // the step before, which read a1, is done
    keep(a1);
    ldmatrix_x4(a1, a_lane + a_off);
    wgmma_fence();
    wgmma_n<kNT>(acc, a1, desc_interleave(b_stage + b_off, 128, sbo));
    wgmma_commit();
    if (s + 2 == steps) break;
    next();
    wgmma_wait<1>();  // step s, which read a0, is done
    keep(a0);
    ldmatrix_x4(a0, a_lane + a_off);
  }
  wgmma_wait<0>();
  keep(a0);
  keep(a1);
  keep(acc);
}

// The mma.syncs of one stage of the small-cin route: each 32-byte K step,
// the A fragments of the warp's m16 tiles (a_lane[mt]: this lane's
// ldmatrix row address in tile mt) and the B fragments of its n8 tiles, in
// pairs b_pair bytes apart from b_lane.
template <int kMT, int kNT>
__device__ __forceinline__ void mma_stage(int (&acc)[kMT][kNT][4], const uint32_t (&a_lane)[kMT],
                                          uint32_t b_lane, uint32_t b_pair, int k32) {
  for (int kk = 0; kk < k32; ++kk) {
    uint32_t a[kMT][4], b[kNT / 2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) ldmatrix_x4(a[mt], a_lane[mt] + kk * 32);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) ldmatrix_x4(b[np], b_lane + np * b_pair + kk * 32);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mma_s8(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
  }
}

// A tile of the output: image, first output row and column, first channel.
struct Tile {
  int b, y0, x0, n0;
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int t, int bn) {
  const int nt = t % g.tiles_n, mt = t / g.tiles_n;
  const int tx = mt % g.tiles_x, ty = (mt / g.tiles_x) % g.tiles_y;
  return Tile{mt / (g.tiles_x * g.tiles_y), ty * g.tr, tx * g.tc, nt * bn};
}

// Step 3 and 4 of one accumulator pair: a bf16 pair as a word.
__device__ __forceinline__ uint32_t requant2(const Geo& g, int s0, int s1, float m0, float b0,
                                             float m1, float b1) {
  __nv_bfloat16 v0 = __float2bfloat16_rn(__fmaf_rn(__int2float_rn(s0), m0, b0));
  __nv_bfloat16 v1 = __float2bfloat16_rn(__fmaf_rn(__int2float_rn(s1), m1, b1));
  if (g.relu) {
    if (!(__bfloat162float(v0) > 0.0f)) v0 = __float2bfloat16_rn(0.0f);
    if (!(__bfloat162float(v1) > 0.0f)) v1 = __float2bfloat16_rn(0.0f);
  }
  return static_cast<uint32_t>(__bfloat16_as_ushort(v0)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(v1)) << 16;
}

__device__ __forceinline__ uint32_t pick4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                          int i) {
  return i == 0 ? w0 : i == 1 ? w1 : i == 2 ? w2 : w3;
}

// Steps 3 and 4 on this warp's accumulators, stored to the output: m16
// tile mt holds rows row0 + 16 mt + [0, 16) of the tile, n8 tile nt the
// channels n0 + col0 + 8 nt + [0, 8); a thread owns rows g and g + 8 at
// channels 2t, 2t + 1 of each. When cout is a multiple of 8 the four
// threads of a quad trade words (three shuffles) so that each holds 8
// channels of one row and writes them in one 16-byte store, four n8
// tiles at a time; otherwise each writes its pairs.
template <int kMT, int kNT>
__device__ __forceinline__ void store_tile(const Geo& g, const Tile& tl, int (&acc)[kMT][kNT][4],
                                           int row0, int col0, int lane) {
  const int gq = lane >> 2, t = lane & 3;
  const int tpix = g.tr * g.tc;
  const bool wide = (g.cout & 7) == 0;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = row0 + mt * 16 + gq + 8 * half;
      bool inside = m < tpix;
      size_t pix = 0;
      if (inside) {
        const int r = m / g.tc, c = m - r * g.tc;
        const int y = tl.y0 + r, x = tl.x0 + c;
        inside = y < g.ho && x < g.wo;
        pix = (static_cast<size_t>(tl.b) * g.ho + y) * g.wo + x;
      }
      __nv_bfloat16* row = g.out + pix * g.cout + tl.n0 + col0;
      if (wide) {
#pragma unroll
        for (int q = 0; q < kNT / 4; ++q) {
          uint32_t w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = tl.n0 + col0 + (4 * q + j) * 8 + 2 * t;
            const bool ok = n < g.cout;
            w[j] = requant2(g, acc[mt][4 * q + j][2 * half], acc[mt][4 * q + j][2 * half + 1],
                            ok ? g.mult[n] : 0.0f, ok ? g.bias[n] : 0.0f,
                            ok ? g.mult[n + 1] : 0.0f, ok ? g.bias[n + 1] : 0.0f);
          }
          // thread t gathers n8 tile 4q + t of the row: word t' from lane t'
          const uint32_t own = pick4(w[0], w[1], w[2], w[3], t);
          uint32_t c0 = own, c1 = own, c2 = own, c3 = own;
#pragma unroll
          for (int i = 1; i < 4; ++i) {
            const uint32_t recv =
                __shfl_xor_sync(0xffffffffu, pick4(w[0], w[1], w[2], w[3], t ^ i), i);
            const int from = t ^ i;
            c0 = from == 0 ? recv : c0;
            c1 = from == 1 ? recv : c1;
            c2 = from == 2 ? recv : c2;
            c3 = from == 3 ? recv : c3;
          }
          const int n8 = (4 * q + t) * 8;
          if (inside && tl.n0 + col0 + n8 < g.cout) {
            *reinterpret_cast<uint4*>(row + n8) = make_uint4(c0, c1, c2, c3);
          }
        }
      } else if (inside) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int nl = nt * 8 + 2 * t, n = tl.n0 + col0 + nl;
          if (n >= g.cout) continue;
          const bool two = n + 1 < g.cout;
          const uint32_t w = requant2(g, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1],
                                      g.mult[n], g.bias[n], two ? g.mult[n + 1] : 0.0f,
                                      two ? g.bias[n + 1] : 0.0f);
          if (two && (g.cout & 1) == 0) {
            *reinterpret_cast<uint32_t*>(row + nl) = w;
          } else {
            reinterpret_cast<uint16_t*>(row + nl)[0] = static_cast<uint16_t>(w);
            if (two) reinterpret_cast<uint16_t*>(row + nl)[1] = static_cast<uint16_t>(w >> 16);
          }
        }
      }
    }
  }
}

// The channel route (cin a multiple of 16), warp-specialised and
// persistent: kBM / 64 consumer warpgroups (warpgroup w owns rows 64 w +
// [0, 64) of the tile, as wgmma's M) and one producer warpgroup, the last,
// meeting only on mbarriers. Block i walks tiles i, i + grid, ..., each in
// `stages` steps of kc channels; the steps of all its tiles form one
// pipeline over two slots (an int8 halo and a filter buffer each) and a
// ring of raw_depth raw bf16 halos.
//
// The producer warpgroup: its first warp's first lane asks the copy engine
// for each step's raw halo (one 4-d tensor copy of the NHWC input, whose
// out-of-range pixels and channels read as zeros: the padding), up to
// raw_depth steps ahead, and for its filter (one bulk copy per 8 output
// channels from the pre-tiled filter) once the consumers have left the
// slot; its other three warps quantize each step's raw halo into the
// slot's int8 halo and arrive on full. Consumers, step i: wait for the
// halo and the filter, run the stage's wgmmas, arrive on empty[i % 2],
// and after a tile's last stage store it while the producers fill the
// next slots.
template <int kBM, int BN>
__global__ void __launch_bounds__(2 * kBM + 128, 1)
    qconv_channels(const __grid_constant__ CUtensorMap xmap, const Geo g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kConsumers = 2 * kBM;   // threads: kBM / 64 warpgroups
  constexpr int kConverters = 96;       // the producer warpgroup's last three warps
  constexpr int kNT = BN / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tpix = g.tr * g.tc;
  const int hpix = g.hr * g.hc;
  const int ntiles = g.batch * g.tiles_y * g.tiles_x * g.tiles_n;
  if (static_cast<int>(blockIdx.x) >= ntiles) return;
  const int my_tiles = (ntiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int nsteps = my_tiles * g.stages;
  const int depth = g.raw_depth;

  float* s_inv = reinterpret_cast<float*>(smem);
  const uint32_t bars = smem_u32(smem + g.off_bar);
  // full[2], empty[2], filter_landed[2], raw_landed[depth], raw_free[depth]
  auto full = [&](int k) { return bars + 8 * k; };
  auto empty = [&](int k) { return bars + 8 * (2 + k); };
  auto filter_landed = [&](int k) { return bars + 8 * (4 + k); };
  auto raw_landed = [&](int k) { return bars + 8 * (6 + k); };
  auto raw_free = [&](int k) { return bars + 8 * (6 + depth + k); };
  for (int i = tid; i < g.inv_len; i += blockDim.x) s_inv[i] = g.inv[i];
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(full(k), kConverters);
      mbar_init(empty(k), kConsumers);
      mbar_init(filter_landed(k), 1);
    }
    for (int k = 0; k < depth; ++k) {
      mbar_init(raw_landed(k), 1);
      mbar_init(raw_free(k), kConverters);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer ----
    // 640 threads start at 96 registers; the producers hand 64 each to the
    // pool the consumers draw 16 each from (128 x 64 = 512 x 16)
    if (kBM == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    const int pt = tid - kConsumers;
    if (pt == 0) {
      for (int i = 0; i < nsteps; ++i) {
        const Tile tl = tile_at(g, blockIdx.x + (i / g.stages) * gridDim.x, BN);
        const int c0 = (i % g.stages) * g.kc;
        mbar_wait(raw_free(i % depth), ((i / depth) & 1) ^ 1);  // converted at i - depth
        expect_tx(raw_landed(i % depth), g.raw_bytes);
        tma_load_4d(smem_u32(smem + g.off_raw + (i % depth) * g.raw_stage), &xmap,
                    raw_landed(i % depth), c0, tl.x0 * g.stride - g.pad_left,
                    tl.y0 * g.stride - g.pad_top, tl.b);
        mbar_wait(empty(i & 1), ((i >> 1) & 1) ^ 1);  // the consumers left step i - 2
        const int groups = min(BN / 8, g.np / 8 - tl.n0 / 8);
        const uint32_t dst = smem_u32(smem + g.off_b + (i & 1) * g.b_stage);
        expect_tx(filter_landed(i & 1), groups * g.group_bytes);
        for (int j = 0; j < groups; ++j) {
          const size_t group = static_cast<size_t>(tl.n0 / 8 + j) * g.stages + i % g.stages;
          bulk_load(dst + j * g.group_bytes, g.wt + group * g.group_bytes, g.group_bytes,
                    filter_landed(i & 1));
        }
      }
    } else if (pt >= 32) {
      const int ct = pt - 32;
      const int lg_ap = g.lg_kc - 3;  // 8-channel pieces of a pixel
      const float inv0 = s_inv[0];
      for (int i = 0; i < nsteps; ++i) {
        const unsigned char* raw = smem + g.off_raw + (i % depth) * g.raw_stage;
        unsigned char* halo = smem + g.off_a + (i & 1) * g.a_stage;
        const int c0 = (i % g.stages) * g.kc;
        mbar_wait(raw_landed(i % depth), (i / depth) & 1);
        mbar_wait(empty(i & 1), ((i >> 1) & 1) ^ 1);  // the consumers left step i - 2
        for (int k = ct; k < hpix << lg_ap; k += kConverters) {
          const int hp = k >> lg_ap, j = k & ((1 << lg_ap) - 1);
          const uint4 v = *reinterpret_cast<const uint4*>(raw + k * 16);
          const int c = c0 + 8 * j;
          *reinterpret_cast<uint2*>(halo + hp * g.ps + 8 * j) =
              make_uint2(quant4(v.x, v.y, s_inv, g.inv_len, inv0, c),
                         quant4(v.z, v.w, s_inv, g.inv_len, inv0, c + 4));
        }
        mbar_arrive(raw_free(i % depth));
        mbar_arrive(full(i & 1));
      }
    }
    return;
  }

  // ---- consumers ----
  if (kBM == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n");
  // ldmatrix row address of lane l: row (l & 7) + 8 * ((l >> 3) & 1) of
  // the warp's 16, at byte (l >> 4) * 16; a row is its output pixel's
  // first halo pixel
  const int wg = warp >> 2, wi = warp & 3;
  const int m = 64 * wg + 16 * wi + (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t row = 0;
  if (m < tpix) {
    const int r = m / g.tc, c = m - r * g.tc;
    row = (r * g.hc + c) * g.stride;
  }
  const uint32_t a_lane = smem_u32(smem + g.off_a) + row * g.ps + (lane >> 4) * 16;
  const uint32_t b_base = smem_u32(smem + g.off_b);
  int acc[1][kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[0][nt][k] = 0;
  for (int i = 0; i < nsteps; ++i) {
    mbar_wait(full(i & 1), (i >> 1) & 1);
    mbar_wait(filter_landed(i & 1), (i >> 1) & 1);
    wgmma_stage<kNT>(acc[0], a_lane + (i & 1) * g.a_stage, b_base + (i & 1) * g.b_stage, g.kh,
                     g.kw, g.dil * g.hc * g.ps, g.dil * g.ps, g.kc * 8, g.kc / 32, g.group_bytes);
    mbar_arrive(empty(i & 1));
    if (i % g.stages == g.stages - 1) {
      const Tile tl = tile_at(g, blockIdx.x + (i / g.stages) * gridDim.x, BN);
      store_tile<1, kNT>(g, tl, acc, 64 * wg + 16 * wi, 0, lane);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[0][nt][k] = 0;
    }
  }
}

// The small-cin route (cin not a multiple of 16: the RGB stems), one tile a
// block of 8 warps on mma.sync: BN 128 as 2 x 4 warps of 64 x 32, BN 64 as
// 4 x 2 of 32 x 32. The input halo (cp channels a pixel, zero beyond cin
// and outside the image) is gathered and quantized once into shared
// memory; each stage's A tile, im2col rows of the staged (dy, dx, c) order,
// is then copied out of it 4 bytes at a time.
template <int BN>
__global__ void __launch_bounds__(256, BN == 64 ? 4 : 2) qconv_small(const Geo g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int kBM = 128, kThreads = 256;
  constexpr int kWM = (kThreads / 32) / (BN / 32);  // warps along M
  constexpr int kWN = (kThreads / 32) / kWM;        // warps along N
  constexpr int kMT = kBM / (kWM * 16);             // m16 tiles of a warp
  constexpr int kNT = BN / (kWN * 8);               // n8 tiles of a warp
  static_assert(kNT == 4 && kMT * kWM * 16 == kBM, "warp layout");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWM, wn = warp / kWM;
  const int tpix = g.tr * g.tc;
  const int taps = g.kh * g.kw;
  const int hpix = g.hr * g.hc;
  const int ntiles = g.batch * g.tiles_y * g.tiles_x * g.tiles_n;
  if (static_cast<int>(blockIdx.x) >= ntiles) return;

  float* s_inv = reinterpret_cast<float*>(smem);
  for (int i = tid; i < g.inv_len; i += kThreads) s_inv[i] = g.inv[i];
  const uint32_t a_base = smem_u32(smem + g.off_a);
  const uint32_t b_base = smem_u32(smem + g.off_b);
  // ldmatrix row addresses: lane l gives row (l & 7) + 8 * ((l >> 3) & 1)
  // of the m16 tile at byte (l >> 4) * 16 (A), and row n = (l & 7) +
  // 8 * (l >> 4) of an n16 pair at byte ((l >> 3) & 1) * 16 (B)
  uint32_t a_lane[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const int m = wm * kMT * 16 + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_lane[mt] = a_base + m * g.ps + (lane >> 4) * 16;
  }
  const uint32_t b_lane =
      b_base + (wn * kNT * 8 + (lane & 7) + (lane >> 4) * 8) * g.ps + ((lane >> 3) & 1) * 16;
  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  const Tile tl = tile_at(g, blockIdx.x, BN);
  unsigned char* halo = smem + g.off_raw;
  unsigned char* at = smem + g.off_a;
  unsigned char* bs = smem + g.off_b;
  const int groups = g.kc / 4, bpieces = g.kc / 16, cgroups = g.cp / 4;
  __syncthreads();  // s_inv
  const int iy0 = tl.y0 * g.stride - g.pad_top, ix0 = tl.x0 * g.stride - g.pad_left;
  for (int i = tid; i < hpix * cgroups; i += kThreads) {
    const int hp = i / cgroups, c = 4 * (i - hp * cgroups);
    const int hy = hp / g.hc, hx = hp - hy * g.hc;
    const int y = iy0 + hy, x = ix0 + hx;
    uint32_t q[4] = {0, 0, 0, 0};
    if (y >= 0 && y < g.h && x >= 0 && x < g.w) {
      const __nv_bfloat16* src =
          g.x + ((static_cast<size_t>(tl.b) * g.h + y) * g.w + x) * g.cin + c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c + e < g.cin) {
          q[e] = quant1(__bfloat162float(src[e]), inv_of(s_inv, g.inv_len, s_inv[0], c + e));
        }
      }
    }
    *reinterpret_cast<uint32_t*>(halo + hp * g.cp + c) = pack4(q[0], q[1], q[2], q[3]);
  }
  for (int s = 0; s < g.stages; ++s) {
    const int k0 = s * g.kc;
    __syncthreads();  // the halo is whole; the MMAs of s - 1 are done with A and B
    for (int i = tid; i < BN * bpieces; i += kThreads) {
      const int n = i / bpieces, p = i - n * bpieces;
      const int k = k0 + 16 * p;
      const bool ok = tl.n0 + n < g.np && k < g.kp;
      const int8_t* src = ok ? g.wk + static_cast<size_t>(tl.n0 + n) * g.kp + k : g.wk;
      cp_async16(smem_u32(bs + n * g.ps + p * 16), src, ok);
    }
    cp_async_commit();
    // a thread's K group is the same in every row it fills (kThreads is a
    // multiple of groups): its tap and channel, hence its halo offset, once
    {
      const int grp = tid % groups;
      const int k = k0 + 4 * grp;
      const int tap = k / g.cp, c = k - tap * g.cp;
      const int dy = tap / g.kw, dx = tap - dy * g.kw;
      const int tap_off = ((dy * g.hc + dx) * g.dil) * g.cp + c;
      for (int m = tid / groups; m < kBM; m += kThreads / groups) {
        uint32_t word = 0;
        if (m < tpix && tap < taps) {
          const int r = m / g.tc, cc = m - r * g.tc;
          word = *reinterpret_cast<const uint32_t*>(
              halo + (r * g.hc + cc) * g.stride * g.cp + tap_off);
        }
        *reinterpret_cast<uint32_t*>(at + m * g.ps + 4 * grp) = word;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // A and B of stage s are whole
    mma_stage<kMT, kNT>(acc, a_lane, b_lane, 16 * g.ps, g.kc / 32);
  }
  store_tile<kMT, kNT>(g, tl, acc, wm * kMT * 16, wn * kNT * 8, lane);
}

// Opts `kernel` into the most shared memory once per device and gives the
// grid: a block per tile, or (persistent) as many as fit on the card at once.
template <typename Kernel>
cudaError_t configure(Kernel* kernel, const Geo& g, int threads, size_t smem, bool persistent,
                      unsigned* grid_out) {
  static bool allowed[8][stem::kMaxDevices] = {};
  static Kernel* ids[8] = {};
  int slot = 0;
  while (slot < 7 && ids[slot] != nullptr && ids[slot] != kernel) ++slot;
  ids[slot] = kernel;
  cudaError_t err = stem::smem_opt_in(allowed[slot], kernel, kMaxSmem);
  if (err != cudaSuccess) return err;
  long long grid = static_cast<long long>(g.batch) * g.tiles_y * g.tiles_x * g.tiles_n;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    }
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long fit = static_cast<long long>(sms) * per_sm;
    grid = grid < fit ? grid : fit;
  }
  *grid_out = static_cast<unsigned>(grid);
  return cudaSuccess;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of the NHWC input whose box is one stage's raw halo:
// kc channels x hc columns x hr rows x 1 image, zeros outside.
cudaError_t input_map(const Geo& g, CUtensorMap* map) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return err != cudaSuccess ? err : cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.cin), static_cast<cuuint64_t>(g.w),
                              static_cast<cuuint64_t>(g.h), static_cast<cuuint64_t>(g.batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(g.cin) * 2,
                                 static_cast<cuuint64_t>(g.w) * g.cin * 2,
                                 static_cast<cuuint64_t>(g.h) * g.w * g.cin * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(g.kc), static_cast<cuuint32_t>(g.hc),
                             static_cast<cuuint32_t>(g.hr), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<__nv_bfloat16*>(g.x), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

int round_up(int n, int k) { return (n + k - 1) / k * k; }

int log2_of(int pow2) {
  int lg = 0;
  while ((1 << lg) < pow2) ++lg;
  return lg;
}

// The tiling and shared-memory layout of a conv for blocks of `bm` output
// pixels and `bn` channels, output tiles of at most `tr_max` rows and
// `raw_depth` raw buffers (channel route); the bytes of shared memory it takes.
size_t plan(Geo& g, int bm, int bn, bool small, int tr_max, int raw_depth) {
  g.tc = pow2_at_least(g.wo) < 16 ? pow2_at_least(g.wo) : 16;
  g.tr = pow2_at_least(g.ho) < bm / g.tc ? pow2_at_least(g.ho) : bm / g.tc;
  g.tr = g.tr < tr_max ? g.tr : tr_max;
  g.tiles_y = (g.ho + g.tr - 1) / g.tr;
  g.tiles_x = (g.wo + g.tc - 1) / g.tc;
  g.tiles_n = (g.cout + bn - 1) / bn;
  g.hr = (g.tr - 1) * g.stride + (g.kh - 1) * g.dil + 1;
  g.hc = (g.tc - 1) * g.stride + (g.kw - 1) * g.dil + 1;
  const int taps = g.kh * g.kw;
  const int hpix = g.hr * g.hc;
  const int inv_bytes = round_up(g.inv_len * 4, 128);
  if (!small) {
    g.ps = g.kc + 16;
    g.stages = (g.cin + g.kc - 1) / g.kc;
    g.raw_depth = raw_depth;
    g.a_stage = round_up(hpix * g.ps, 128);
    g.group_bytes = taps * g.kc * 8;
    g.b_stage = round_up(bn / 8 * g.group_bytes, 1024);
    g.raw_bytes = hpix * g.kc * 2;
    g.raw_stage = round_up(g.raw_bytes, 1024);
    g.off_a = inv_bytes;
    g.off_b = round_up(g.off_a + 2 * g.a_stage, 1024);
    g.off_raw = g.off_b + 2 * g.b_stage;
    g.off_bar = g.off_raw + raw_depth * g.raw_stage;
    g.lg_kc = log2_of(g.kc);
    return static_cast<size_t>(g.off_bar) + 8 * (6 + 2 * raw_depth);
  }
  g.kc = pow2_at_least(g.kp < 32 ? 32 : g.kp) < 128 ? pow2_at_least(g.kp < 32 ? 32 : g.kp) : 128;
  g.ps = g.kc + 16;
  g.stages = (g.kp + g.kc - 1) / g.kc;
  g.raw_depth = 0;
  g.off_a = inv_bytes;
  g.b_stage = bn * g.ps;
  g.off_b = g.off_a + bm * g.ps;
  g.off_raw = g.off_b + g.b_stage;  // the int8 halo, cp bytes a pixel
  g.off_bar = 0;
  g.lg_kc = log2_of(g.kc);
  return static_cast<size_t>(g.off_raw) + static_cast<size_t>(hpix) * g.cp;
}

}  // namespace

// x: (batch, h, w, cin) bf16 NHWC; wk: (np, kp) int8 (ops/int8_conv.Int8Weight);
// wt: for cin a multiple of 16, the filter tiles of kc channels a stage
// (Int8Weight.tiles: (np / 8, stages, kh * kw, kc / 16, 8, 16) int8), else unused;
// inv: (inv_len,) float32, inv_len 1 or cin; mult, bias: (cout,) float32;
// out: (batch, ho, wo, cout) bf16. All contiguous, x 16-byte aligned.
// pad_top / pad_left: the SAME padding before the first row / column (0
// for VALID); ho, wo: the output's size. Launches on `stream` and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the kernel does not take).
extern "C" int int8_qconv_launch(const void* x, const void* wk, const void* wt,
                                 const float* inv, const float* mult, const float* bias,
                                 void* out, int batch, int h, int w, int cin, int cout, int kh,
                                 int kw, int stride, int dil, int pad_top, int pad_left, int ho,
                                 int wo, int kp, int np, int kc, int inv_len, int relu,
                                 void* stream) {
  const int cp = round_up(cin, 4);
  if (batch <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || dil <= 0 || ho <= 0 || wo <= 0 || kp % 16 || kp < kh * kw * cp ||
      np < cout || np % 16 || (inv_len != 1 && inv_len != cin) ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(wk) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo g{};
  g.x = static_cast<const __nv_bfloat16*>(x);
  g.wk = static_cast<const int8_t*>(wk);
  g.wt = static_cast<const int8_t*>(wt);
  g.inv = inv;
  g.mult = mult;
  g.bias = bias;
  g.out = static_cast<__nv_bfloat16*>(out);
  g.batch = batch, g.h = h, g.w = w, g.cin = cin, g.cout = cout, g.kh = kh, g.kw = kw;
  g.stride = stride, g.dil = dil, g.pad_top = pad_top, g.pad_left = pad_left, g.ho = ho, g.wo = wo;
  g.kp = kp, g.np = np, g.cp = cp, g.inv_len = inv_len, g.relu = relu != 0;
  const int bn = cout <= 64 ? 64 : 128;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned grid = 0;
  cudaError_t err;
  if (cin % 16 != 0) {
    const size_t smem = plan(g, 128, bn, true, 128, 0);
    if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
    void (*kernel)(Geo) = bn == 64 ? qconv_small<64> : qconv_small<128>;
    err = configure(kernel, g, 256, smem, false, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, 256, smem, st>>>(g);
    return static_cast<int>(cudaGetLastError());
  }
  if ((kc != 32 && kc != 64) || wt == nullptr || (reinterpret_cast<uintptr_t>(wt) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  g.kc = kc;
  // Tiles of 256 pixels (16 x 16, four consumer warpgroups) on maps wider
  // and taller than 8, else of 128 (two); as many raw buffers as fit, up
  // to 4 and at least 2. A halo too big for that (strided, dilated) takes
  // the 128-pixel tile, then a shorter one.
  int bm = ho > 8 && wo > 8 ? 256 : 128;
  size_t smem = 0;
  for (int tr_max = bm;; tr_max /= 2) {
    if (bm == 256 && tr_max < 16) {
      bm = 128;
      tr_max = 8;
    }
    int depth = 4;
    for (; depth >= 2; --depth) {
      smem = plan(g, bm, bn, false, tr_max, depth);
      if (smem <= static_cast<size_t>(kMaxSmem)) break;
    }
    if (depth >= 2 || g.tr <= 1) break;
  }
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap;
  err = input_map(g, &xmap);
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*kernel)(CUtensorMap, Geo) =
      bm == 256 ? (bn == 64 ? qconv_channels<256, 64> : qconv_channels<256, 128>)
                : (bn == 64 ? qconv_channels<128, 64> : qconv_channels<128, 128>);
  const int threads = 2 * bm + 128;
  err = configure(kernel, g, threads, smem, true, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(xmap, g);
  err = cudaGetLastError();
  return static_cast<int>(err);
}
