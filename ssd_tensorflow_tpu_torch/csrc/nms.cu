// Fused pairwise IoU + greedy NMS for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_tensorflow_tpu/ops/nms_pallas.py
// (_nms_kernel, entry nms_keep_pallas). Per image: the +1-pixel IoU of
// the class-shifted canvas corners of the D score-sorted candidates,
// then the sequential greedy loop (a kept, valid i suppresses j > i when
// IoU > threshold). Output is the (B, D) keep mask.
//
// What bounds it on this card: neither bytes (D*18 bytes in and out per
// image) nor operations (~15 per candidate pair) but latency: the launch,
// one round trip to device memory for the corners, the mask phase of one
// block per image, and the greedy scan's chain of dependent steps. The
// design keeps that chain as short as the data allows and the rest wide.
//
// Design: one block per image, up to 1024 threads.
//   1. Load. Thread j stages candidate j's corners and area in shared
//      memory. Warp 0 meanwhile reads `valid` one byte per lane and
//      ballots it into words: lane l keeps word l of the "alive" set.
//   2. Mask, pairs across lanes. The IoU > threshold relation of the
//      upper triangle is stored as bitmask rows, ceil(D/32) words a row
//      (5.6 KB at D = 200). A warp takes row i and word w >= i/32; lane l
//      computes the one IoU of (i, 32w + l) and a ballot forms the word.
//      Words wholly under the diagonal are never scheduled or read, nor
//      are the rows of invalid candidates and the words without a valid
//      column (nothing there can be kept or suppressed). Rows are dealt
//      to the warps round-robin, so every warp gets the same mix of long
//      and short rows: at most 872 words over 32 warps at D = 200, 27 or
//      28 independent IoUs a lane. The IEEE division runs only for the
//      pairs whose approximate quotient is within 2^-18 of the threshold
//      (see iou_over); the others are decided by a reciprocal and a
//      multiply, with the same result.
//   3. Scan, by warp 0, over the ceil(D/32) diagonal blocks in order.
//      For block w, lane k holds row 32w + k's word w in a register
//      (loaded one block ahead), and `live` is the block's word of
//      undecided candidates. A round decides every candidate that no
//      live earlier candidate of the block aims at:
//          aimed = OR of the live rows;  sure = live & ~aimed;
//          gone  = OR of the sure rows;  keep sure;
//          live &= ~(sure | gone)
//      Such a candidate is kept by the greedy loop too (only a live
//      earlier row could still suppress it), so the result is the same,
//      and `sure` always holds live's lowest bit, so a block ends after
//      at most as many rounds as its longest suppression chain has
//      candidates it keeps: 1 to 3 rounds on detections, 16 at worst. A
//      round is two dependent warp OR-reductions and no shared-memory
//      access. Then lane k, if row 32w + k was kept, contributes that
//      row's later words (loads that depend on nothing in the rounds;
//      the next block's word is loaded before they start), and one warp
//      OR-reduction per later word clears them from the alive set.
//      Dependent steps at D = 200: 7 blocks x (rounds x 2 + 1)
//      reductions of ~30 clocks, instead of 200 steps of shuffle +
//      branch + shared-memory load.
//   4. Store, by warp 0: one byte per lane, 32 consecutive bytes a step.
// No padding of D is needed; D is capped at kMaxD (the mask then takes
// 128 KB of dynamic shared memory).
//
// Above kMaxD (RetinaNet's multi-label decode sends up to 5 levels x
// 1000 = 5,000 candidates an image) the D^2-bit mask does not fit in
// shared memory (3.1 MB an image at D = 5,000), so it lives in device
// memory, in a workspace the caller allocates, and the work is split
// over two kernels:
//   nms_mask_global: a grid of (rows / 8, B) blocks of 8 warps; each warp
//      takes one valid row i and writes its words w >= i/32 exactly as
//      phase 2 above computes them (the same IoU arithmetic), reading the
//      columns' corners from device memory (the image's corners, 80 KB
//      at D = 5,000, stay in L1/L2). All the images' rows run at once:
//      D(D-1)/2 IoUs an image are ~15 operations each, ~0.2 ms of the
//      card's float32 rate for a batch of 64.
//   nms_scan_global: one warp per image, phase 3 above over ceil(D/32)
//      blocks, with the alive set in shared memory (a word a block, up
//      to kMaxWordsGlobal) instead of one register a lane, and each
//      kept row's later words read from device memory (a row a lane, so
//      consecutive words of one row share cache lines); a block that
//      keeps nothing skips them. Keep bytes are written block by block.
// The scan is the same greedy decision procedure, so the keep mask is the
// plain version's bit for bit at any D up to kMaxDGlobal, as below kMaxD.
// Class segments (class-shifted boxes of two classes never overlap) would
// skip most pairs of a 264-class batch, but the kernel sees shifted
// corners alone and must equal greedy_keep on any input; the plain
// per-pair mask keeps that contract.
//
// Bit-exactness with the plain version (ops/nms.py): every operation is
// an explicitly rounded intrinsic in the JAX package's order, so nvcc
// cannot contract a multiply and an add into an FMA, and the division is
// IEEE round-to-nearest (__fdiv_rn; the library is built without fast
// math) wherever its rounding could decide the comparison. min/max
// propagate NaN as jnp.minimum / torch.minimum do. The comparison is
// float32 against the float32 threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 1024;
constexpr int kMaxDGlobal = 8192;
constexpr int kMaxWordsGlobal = kMaxDGlobal / 32;
constexpr int kRowsPerBlock = 8;  // warps of nms_mask_global's blocks
constexpr int kMaxThreads = 1024;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory allowed without opt-in
constexpr int kMaxDevices = 64;
constexpr uint32_t kFull = 0xffffffffu;

// min / max that return NaN when either operand is NaN, as jnp.minimum and
// torch.minimum do (fminf / fmaxf would return the other operand).
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Whether __fdiv_rn(inter, uni) > threshold, for every lane of the warp.
// The IEEE division is ~70 instructions where a numerator is zero, as it
// is for most pairs, so it is kept for the pairs that need it: with all
// of inter, uni and the approximate quotient qa = inter * rcp(uni) in the
// normal range, qa is within 2^-21 of the exact quotient and the rounded
// one within 2^-24, so a qa further than 2^-18 of the threshold from it
// decides as the rounded quotient would; inter = 0 gives exactly 0. Any
// lane that is nearer, or holds a NaN, an infinity or a denormal, sends
// the warp through the division.
__device__ __forceinline__ bool iou_over(float inter, float uni, float threshold, float hi,
                                         float lo) {
  float rcp;
  asm("rcp.approx.f32 %0, %1;" : "=f"(rcp) : "f"(uni));
  const float qa = __fmul_rn(inter, rcp);
  const bool sure = uni > 0x1p-60f && uni < 0x1p60f && inter < 0x1p60f &&
                    (inter == 0.0f || qa > 0x1p-60f) && (qa > hi || qa < lo);
  bool over = qa > hi;
  if (__any_sync(kFull, !sure)) {
    if (!sure) over = __fdiv_rn(inter, uni) > threshold;
  }
  return over;
}

// +1-pixel area of corners (x0, x1, y0, y1).
__device__ __forceinline__ float box_area(const float4 v) {
  return __fmul_rn(__fadd_rn(__fsub_rn(v.y, v.x), 1.0f), __fadd_rn(__fsub_rn(v.w, v.z), 1.0f));
}

// Whether IoU(a, q) > threshold, for every lane of the warp (iou_over).
__device__ __forceinline__ bool pair_over(const float4 a, float aa, const float4 q, float qa,
                                          float threshold, float hi, float lo) {
  const float iw = nan_max(
      0.0f, __fadd_rn(__fsub_rn(nan_min(a.y, q.y), nan_max(a.x, q.x)), 1.0f));
  const float ih = nan_max(
      0.0f, __fadd_rn(__fsub_rn(nan_min(a.w, q.w), nan_max(a.z, q.z)), 1.0f));
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(aa, qa), inter);
  return iou_over(inter, uni, threshold, hi, lo);
}

// threshold -+ margin: outside it the approximate quotient decides
__device__ __forceinline__ float threshold_margin(float threshold) {
  return __fmul_rn(fmaxf(fabsf(threshold), 0x1p-40f), 0x1p-18f);
}

__global__ void __launch_bounds__(kMaxThreads)
nms_kernel(const float* __restrict__ corners, const uint8_t* __restrict__ valid,
           uint8_t* __restrict__ keep, int d, float threshold) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int words = (d + 31) / 32;
  float4* box = reinterpret_cast<float4*>(smem);            // d corners (x0, x1, y0, y1)
  float* area = reinterpret_cast<float*>(box + d);          // d
  uint32_t* valid_words = reinterpret_cast<uint32_t*>(area + d);  // 32
  uint32_t* mask = valid_words + 32;                              // d * words

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;

  // 1. load
  const float4* c = reinterpret_cast<const float4*>(corners) + static_cast<size_t>(b) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float4 v = c[i];
    box[i] = v;
    area[i] = box_area(v);
  }
  uint32_t alive = 0;  // warp 0, lane l: word l of valid-and-not-suppressed
  if (warp == 0) {
    const uint8_t* v = valid + static_cast<size_t>(b) * d;
    for (int w = 0; w < words; ++w) {
      const int j = 32 * w + lane;
      const uint32_t word = __ballot_sync(kFull, j < d && v[j] != 0);
      if (lane == w) alive = word;
    }
    if (lane < words) valid_words[lane] = alive;
  }
  __syncthreads();

  // 2. mask. Only a valid row can be kept and only a valid column be
  // suppressed, so the words of other rows, and words without a valid
  // column, are neither computed nor used (the scan reads them, but only
  // under a select on a bit that is then 0).
  const float margin = threshold_margin(threshold);
  const float hi = __fadd_rn(threshold, margin), lo = __fsub_rn(threshold, margin);
  for (int i = warp; i < d; i += warps) {
    if (!((valid_words[i >> 5] >> (i & 31)) & 1u)) continue;
    const float4 a = box[i];
    const float aa = area[i];
    for (int w = i >> 5; w < words; ++w) {
      if (valid_words[w] == 0u) continue;
      const int j = 32 * w + lane;
      const int jc = min(j, d - 1);
      const bool over = pair_over(a, aa, box[jc], area[jc], threshold, hi, lo);
      const uint32_t word = __ballot_sync(kFull, j > i && j < d && over);
      if (lane == 0) mask[i * words + w] = word;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 3. scan. Lane k stands for row 32w + k of block w; a row past d reads
  // row d - 1 and is never live (its alive bit is 0).
  uint32_t diag = mask[min(lane, d - 1) * words];
  for (int w = 0; w < words; ++w) {
    const uint32_t* row = mask + min(32 * w + lane, d - 1) * words;
    const bool more = w + 1 < words;
    const uint32_t next_word = more ? row[w + 1] : 0u;
    const uint32_t next_diag = more ? mask[min(32 * (w + 1) + lane, d - 1) * words + w + 1] : 0u;
    uint32_t live = __shfl_sync(kFull, alive, w);  // undecided candidates of the block
    uint32_t kept = 0;
    while (live) {  // uniform across the warp
      // whom a live earlier candidate of the block could still suppress
      const uint32_t aimed = __reduce_or_sync(kFull, ((live >> lane) & 1u) ? diag : 0u);
      const uint32_t sure = live & ~aimed;  // never empty: it holds live's lowest bit
      const uint32_t gone = __reduce_or_sync(kFull, ((sure >> lane) & 1u) ? diag : 0u);
      kept |= sure;
      live &= ~(sure | gone);
    }
    if (lane == w) alive = kept;
    const bool mine = (kept >> lane) & 1u;
    if (more) {
      const uint32_t gone = __reduce_or_sync(kFull, mine ? next_word : 0u);
      if (lane == w + 1) alive &= ~gone;
    }
#pragma unroll 4
    for (int w2 = w + 2; w2 < words; ++w2) {
      const uint32_t later = row[w2];
      const uint32_t gone = __reduce_or_sync(kFull, mine ? later : 0u);
      if (lane == w2) alive &= ~gone;
    }
    diag = next_diag;
  }

  // 4. store
  uint8_t* out = keep + static_cast<size_t>(b) * d;
  for (int w = 0; w < words; ++w) {
    const uint32_t word = __shfl_sync(kFull, alive, w);
    const int j = 32 * w + lane;
    if (j < d) out[j] = (word >> lane) & 1u;
  }
}

// The mask of the D > kMaxD path (see the note at the top): row i's words
// w >= i/32 of image blockIdx.y, one warp a row, into `mask` (B x D x
// words). Rows of invalid candidates and words without a valid column are
// left unwritten: the scan reads them only under a bit that is then 0.
__global__ void __launch_bounds__(kRowsPerBlock * 32)
nms_mask_global(const float* __restrict__ corners, const uint8_t* __restrict__ valid,
                uint32_t* __restrict__ mask, int d, float threshold) {
  const int words = (d + 31) / 32;
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const uint8_t* v = valid + static_cast<size_t>(b) * d;
  if (i >= d || v[i] == 0) return;  // uniform across the warp
  const float4* c = reinterpret_cast<const float4*>(corners) + static_cast<size_t>(b) * d;
  uint32_t* row = mask + (static_cast<size_t>(b) * d + i) * words;
  const float margin = threshold_margin(threshold);
  const float hi = __fadd_rn(threshold, margin), lo = __fsub_rn(threshold, margin);
  const float4 a = c[i];
  const float aa = box_area(a);
  for (int w = i >> 5; w < words; ++w) {
    const int j = 32 * w + lane;
    const int jc = min(j, d - 1);
    if (__ballot_sync(kFull, j < d && v[jc] != 0) == 0u) continue;
    const float4 q = c[jc];
    const bool over = pair_over(a, aa, q, box_area(q), threshold, hi, lo);
    const uint32_t word = __ballot_sync(kFull, j > i && j < d && over);
    if (lane == 0) row[w] = word;
  }
}

// The scan of the D > kMaxD path: one warp per image over the mask that
// nms_mask_global wrote, the greedy rounds of nms_kernel's phase 3.
__global__ void __launch_bounds__(32)
nms_scan_global(const uint32_t* __restrict__ mask, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int d) {
  __shared__ uint32_t alive[kMaxWordsGlobal];  // word w: valid and not suppressed
  const int words = (d + 31) / 32;
  const int b = blockIdx.x, lane = threadIdx.x;
  const uint32_t* m = mask + static_cast<size_t>(b) * d * words;
  const uint8_t* v = valid + static_cast<size_t>(b) * d;
  uint8_t* out = keep + static_cast<size_t>(b) * d;
#pragma unroll 8
  for (int w = 0; w < words; ++w) {
    const int j = 32 * w + lane;
    const uint32_t word = __ballot_sync(kFull, j < d && v[min(j, d - 1)] != 0);
    if (lane == 0) alive[w] = word;
  }
  __syncwarp();
  uint32_t diag = m[static_cast<size_t>(min(lane, d - 1)) * words];
  for (int w = 0; w < words; ++w) {
    const uint32_t* row = m + static_cast<size_t>(min(32 * w + lane, d - 1)) * words;
    const bool more = w + 1 < words;
    const uint32_t next_diag =
        more ? m[static_cast<size_t>(min(32 * (w + 1) + lane, d - 1)) * words + w + 1] : 0u;
    uint32_t live = alive[w];  // undecided candidates of the block
    uint32_t kept = 0;
    while (live) {  // uniform across the warp
      const uint32_t aimed = __reduce_or_sync(kFull, ((live >> lane) & 1u) ? diag : 0u);
      const uint32_t sure = live & ~aimed;  // never empty: it holds live's lowest bit
      const uint32_t gone = __reduce_or_sync(kFull, ((sure >> lane) & 1u) ? diag : 0u);
      kept |= sure;
      live &= ~(sure | gone);
    }
    const int j = 32 * w + lane;
    if (j < d) out[j] = (kept >> lane) & 1u;
    if (kept) {  // uniform: clear what the kept rows suppress later on
      const bool mine = (kept >> lane) & 1u;
#pragma unroll 4
      for (int w2 = w + 1; w2 < words; ++w2) {
        const uint32_t gone = __reduce_or_sync(kFull, mine ? row[w2] : 0u);
        if (lane == 0) alive[w2] &= ~gone;
      }
      __syncwarp();
    }
    diag = next_diag;
  }
}

// Opts nms_kernel into `smem` bytes of dynamic shared memory on the
// current device. The attribute belongs to the function on each device,
// so it is set once per device and size, not on every launch. Up to the
// default 48 KB (D <= 544, the detection path's D = 200 included) no
// opt-in is needed at all.
cudaError_t allow_smem(size_t smem) {
  static size_t allowed[kMaxDevices] = {};
  if (smem <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

}  // namespace

extern "C" int nms_max_candidates() { return kMaxD; }

extern "C" int nms_max_candidates_global() { return kMaxDGlobal; }

// corners: (B, D, 4) float32 contiguous, 16-byte aligned; valid, keep:
// (B, D) bytes 0/1. Launches on `stream` and returns cudaGetLastError()
// after the launch.
extern "C" int nms_keep_launch(const float* corners, const uint8_t* valid, uint8_t* keep,
                               int batch, int d, float threshold, void* stream) {
  if (batch <= 0 || d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (d + 31) / 32;
  const size_t smem = (static_cast<size_t>(d) * (5 + words) + 32) * 4;
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one warp per row of the mask, as far as a block goes
  const int threads = d < kMaxThreads / 32 ? 32 * d : kMaxThreads;
  nms_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      corners, valid, keep, d, threshold);
  return static_cast<int>(cudaGetLastError());
}

// The D > kMaxD path (kMaxD < d <= kMaxDGlobal): as nms_keep_launch, with
// `mask` a workspace of B x D x ceil(D/32) 32-bit words in device memory.
extern "C" int nms_keep_launch_global(const float* corners, const uint8_t* valid, uint8_t* keep,
                                      uint32_t* mask, int batch, int d, float threshold,
                                      void* stream) {
  if (batch <= 0 || d <= kMaxD || d > kMaxDGlobal || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  nms_mask_global<<<grid, kRowsPerBlock * 32, 0, s>>>(corners, valid, mask, d, threshold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_global<<<batch, 32, 0, s>>>(mask, valid, keep, d);
  return static_cast<int>(cudaGetLastError());
}
