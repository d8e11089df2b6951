// GroupNorm of the ResNet-34 and MobileNetV1 families, with the activation
// that follows it, in one kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's GroupNorm is XLA's
// (ssd_tensorflow_tpu/models/resnet.py, group_norm). Before this kernel
// the card ran models/resnet.group_norm as 19 ATen launches a call
// (casts, two float64 sums, subtracts, squares, multiplies, adds), each a
// full pass through device memory, and the activation as one more.
//
// Input x: NHWC (B, H, W, C) bf16 or float32, contiguous; scale and bias:
// (C,) float32; groups dividing C (group width gw = C / groups); an
// optional skip of x's shape and dtype (any pixel strides, channels
// contiguous). Output: x's shape and dtype. Per (image, group) of n = H *
// W * gw elements, bit for bit as group_norm computes it:
//   1. mean = float32(S1 / n), S1 the float64 sum of the float32 values;
//   2. d = x - mean (one float32 subtract), var = float32(S2 / n), S2 the
//      float64 sum of the float32 squares d * d;
//   3. r = float32(1 / sqrt(double(var + eps))), var + eps a float32 add,
//      the square root and the divide IEEE double (correctly rounded);
//   4. y = ((d * r) * scale[c]) + bias[c], three float32 operations
//      (__fmul_rn / __fadd_rn: nothing is contracted into an FMA), one
//      rounding to the input dtype;
//   5. the epilogue: with a skip, dtype(float32(y) + float32(skip)); then
//      ReLU or ReLU6 on the rounded value (exact in either dtype).
// The float64 partial sums meet in a fixed order (threads, then channels,
// then the blocks of a cluster by rank), never by atomics: the bits are
// the same on every run. A float64 sum of float32 values may differ from
// the CPU's in its last bits where the order differs; rounded to float32
// after the divide that never showed at the families' shapes.
//
// What bounds it on this card: bytes. It does ~10 float and float64
// operations an element against 4 bytes (bf16 in and out), far below the
// ridge. At batch 64 the 27 GroupNorms of mobilenet320 normalise 658.6 M
// elements (1.317 GB of bf16 a pass): one read and one write is 2.63 GB,
// 0.79 ms at 3.35 TB/s; resnet320's 36 normalise 488 M, 1.95 GB, 0.58 ms.
// The 19 launches moved ~12 passes of float32 and float64 copies.
//
// Design: one launch a GroupNorm, x read from device memory once and y
// written once. A thread-block cluster of CS blocks (1 to 16, the launch
// picks) owns one image; block `rank` owns its pixels [rank * chunk,
// (rank + 1) * chunk). Where that slice fits in shared memory (chunk * C
// elements; 200 KB for mobilenet's pw1 at 160x160x64 bf16 with CS = 16;
// at most ~100 KB where a CS of 16 or less lets two blocks share an SM)
// one thread asks the copy engine for it in up to 8 bulk copies, each
// completing on its own mbarrier, and the first pass starts on the pieces
// that have landed; the second and third passes read shared memory. Else
// each pass reads device memory, the second and third partly from L2.
// Each thread owns V channels (16 bytes: 8 bf16 or 4 float32) of every
// `rows`-th pixel, so its float64 accumulators always hold the same
// channels; a block reduces them to one float64 partial a group, and
// every block of the cluster sums the CS partials of each group through
// distributed shared memory, in rank order, after a cluster barrier. Pass
// 1 gives the means, pass 2 the variances, pass 3 writes y with its
// epilogue. The cluster's last barrier is split: a block arrives as soon
// as it has read the others' partials and waits only before it exits, so
// the blocks' third passes run unsynchronised.
//
// The three passes issue ~20 instructions an element (a float64
// conversion and add in each of the first two), so the kernel is bound by
// issue as much as by bytes: the epilogue is a template parameter (no
// branch an element), ReLU / ReLU6 clamp the float32 value before its one
// rounding (rounding is monotone and keeps 0 and 6, so the result is the
// one of clamping the rounded value; NaN passes), and bf16 is rounded and
// packed two at a time. Measured on an H100 80GB HBM3 at b64: 0.299 ms at
// 160x160x64 bf16 (bound 0.125), 0.075 at 80x80x64 (0.031); a version with
// the epilogue chosen at run time took 0.65 / 0.18, and one that read
// device memory in every pass (no slice in shared memory, every image in
// flight) 0.37 / 0.087. What is left is issue and the two cluster
// reductions an image, which leave the memory idle while a block with a
// whole SM's shared memory computes.

#include <cooperative_groups.h>
#include <limits.h>

#include "stem_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may take
constexpr int kSmemPerSm = 233472; // 228 KB an SM
constexpr int kSmemReserved = 1024;  // an SM keeps this much of it for each block
constexpr int kMaxCluster = 16;    // blocks an image at most (a non-portable cluster)
constexpr int kPieces = 8;         // bulk copies (and mbarriers) of a cached slice
constexpr int kRowAlign = 8;       // a block's and a piece's first pixel: a multiple of this

enum Act { kNone = 0, kRelu = 1, kRelu6 = 2 };

struct Params {
  const void* x;
  const float* scale;
  const float* bias;
  const void* skip;        // nullptr: no skip
  void* out;
  long long skip_b, skip_h, skip_w;   // the skip's strides, elements
  double n;                // elements of a group of an image
  float eps;
  int hw, w, c, groups, gw, act;   // gw: a group's channels
  int chunk;               // pixels a block (a multiple of kRowAlign)
  int lanes, rows;         // vectors a pixel (C / V); pixels a pass walks at once
  int cached, pieces, piece_rows;
  int off_red, off_part, off_stats, off_cache;   // shared-memory offsets
};

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// V values at p (generic address: shared or device memory), as float32.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "a vector is 16 bytes");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
      }
    } else {
      f[0] = __uint_as_float(u.x);
      f[1] = __uint_as_float(u.y);
      f[2] = __uint_as_float(u.z);
      f[3] = __uint_as_float(u.w);
    }
  }
}

// y rounded to T and back (nothing for float32); bf16 two at a time.
template <typename T, int V>
__device__ __forceinline__ void round_to(float (&y)[V]) {
  if constexpr (sizeof(T) == 2) {
    if constexpr (V == 1) {
      y[0] = __bfloat162float(__float2bfloat16_rn(y[0]));
    } else {
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        const float2 t = __bfloat1622float2(__floats2bfloat162_rn(y[2 * i], y[2 * i + 1]));
        y[2 * i] = t.x;
        y[2 * i + 1] = t.y;
      }
    }
  }
}

// y rounded to T, stored at p.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&y)[V]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V == 1) {
      *reinterpret_cast<float*>(p) = y[0];
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
    }
  } else if constexpr (V == 1) {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(y[0]);
  } else {
    uint4 u;
    uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The block's float64 partial of each group from every thread's V
// per-channel sums, in a fixed order: each channel's rows in runs of
// `run` (a run a thread, every run starting inside the rows), the runs in
// order, then a group's channels in order. Ends with the partials in
// part[groups].
template <int V>
__device__ __forceinline__ void group_partials(const double (&acc)[V], double* red, double* part,
                                               const Params& p, bool active, int row, int c0) {
  if (active) {
#pragma unroll
    for (int j = 0; j < V; ++j) red[row * p.c + c0 + j] = acc[j];
  }
  __syncthreads();
  const int most = max(1, min(p.rows, static_cast<int>(blockDim.x) / p.c));
  const int run = (p.rows + most - 1) / most;
  const int parts = (p.rows + run - 1) / run;
  for (int i = threadIdx.x; i < parts * p.c; i += blockDim.x) {
    const int ch = i % p.c, r0 = i / p.c * run, r1 = min(p.rows, r0 + run);
    double s = red[r0 * p.c + ch];
    for (int r = r0 + 1; r < r1; ++r) s = __dadd_rn(s, red[r * p.c + ch]);
    red[r0 * p.c + ch] = s;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < p.c; ch += blockDim.x) {
    double s = red[ch];
    for (int r0 = run; r0 < p.rows; r0 += run) s = __dadd_rn(s, red[r0 * p.c + ch]);
    red[ch] = s;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < p.groups; g += blockDim.x) {
    double s = red[g * p.gw];
    for (int k = 1; k < p.gw; ++k) s = __dadd_rn(s, red[g * p.gw + k]);
    part[g] = s;
  }
}

// Group g's sum over the cluster's blocks, in rank order (after a cluster
// barrier); the remote loads all issued before the first add.
__device__ __forceinline__ double cluster_total(cg::cluster_group cluster, double* part, int g,
                                                int cs) {
  double v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    v[r] = r < cs ? *cluster.map_shared_rank(part + g, r) : 0.0;
  }
  double s = 0.0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < cs) s = __dadd_rn(s, v[r]);
  }
  return s;
}

template <typename T, int V, int kAct, bool kSkip>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256) group_norm_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int image = blockIdx.x / cs;
  const int first = static_cast<int>(cluster.block_rank()) * p.chunk;
  const int np = max(0, min(p.hw, first + p.chunk) - first);
  const size_t base = (static_cast<size_t>(image) * p.hw + first) * p.c;
  const T* __restrict__ x = static_cast<const T*>(p.x) + base;
  T* __restrict__ out = static_cast<T*>(p.out) + base;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  double* red = reinterpret_cast<double*>(smem + p.off_red);
  double* sums = reinterpret_cast<double*>(smem + p.off_part);
  double* squares = sums + p.groups;
  float* mean = reinterpret_cast<float*>(smem + p.off_stats);
  float* rstd = mean + p.groups;

  const int tid = threadIdx.x;
  const int row = tid / p.lanes;
  const int c0 = (tid % p.lanes) * V;
  const bool active = row < p.rows;
  // a thread's rows: element offset of the first, and between two
  const size_t start = static_cast<size_t>(row) * p.c + c0;
  const size_t step = static_cast<size_t>(p.rows) * p.c;
  float sc[V], bi[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sc[j] = p.scale[c0 + j];
    bi[j] = p.bias[c0 + j];
  }
  const T* __restrict__ src = x;
  if (p.cached) {
    T* cache = reinterpret_cast<T*>(smem + p.off_cache);
    src = cache;
    if (tid == 0) {
      for (int k = 0; k < p.pieces; ++k) stem::mbar_init(stem::smem_u32(bars + k), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int k = 0; k < p.pieces; ++k) {
        const int r0 = k * p.piece_rows, r1 = min(np, r0 + p.piece_rows);
        if (r1 <= r0) break;
        const uint32_t bar = stem::smem_u32(bars + k);
        const uint32_t bytes = static_cast<uint32_t>((r1 - r0) * p.c * sizeof(T));
        expect_tx(bar, bytes);
        bulk_load(stem::smem_u32(cache + static_cast<size_t>(r0) * p.c),
                  x + static_cast<size_t>(r0) * p.c, bytes, bar);
      }
    }
    __syncthreads();
  }

  // pass 1: the means (a cached slice is read piece by piece as it lands)
  double acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0;
  if (active) {
    int piece_end = p.cached ? 0 : INT_MAX;
    const T* ptr = src + start;
    for (int q = row; q < np; q += p.rows, ptr += step) {
      if (q >= piece_end) {
        const int piece = q / p.piece_rows;
        piece_end = (piece + 1) * p.piece_rows;
        stem::mbar_wait(stem::smem_u32(bars + piece), 0);
      }
      float f[V];
      load_vec<T, V>(ptr, f);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = __dadd_rn(acc[j], static_cast<double>(f[j]));
    }
  }
  group_partials<V>(acc, red, sums, p, active, row, c0);
  cluster_arrive();
  cluster_wait();
  for (int g = tid; g < p.groups; g += blockDim.x) {
    mean[g] = __double2float_rn(__ddiv_rn(cluster_total(cluster, sums, g, cs), p.n));
  }
  __syncthreads();

  // pass 2: the variances of d = x - mean
  float m[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    m[j] = mean[(c0 + j) / p.gw];
    acc[j] = 0.0;
  }
  if (active) {
    const T* ptr = src + start;
    for (int q = row; q < np; q += p.rows, ptr += step) {
      float f[V];
      load_vec<T, V>(ptr, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(f[j], m[j]);
        acc[j] = __dadd_rn(acc[j], static_cast<double>(__fmul_rn(d, d)));
      }
    }
  }
  group_partials<V>(acc, red, squares, p, active, row, c0);
  cluster_arrive();
  cluster_wait();
  for (int g = tid; g < p.groups; g += blockDim.x) {
    const float var = __double2float_rn(__ddiv_rn(cluster_total(cluster, squares, g, cs), p.n));
    rstd[g] = __double2float_rn(
        __ddiv_rn(1.0, __dsqrt_rn(static_cast<double>(__fadd_rn(var, p.eps)))));
  }
  __syncthreads();
  cluster_arrive();   // done with the other blocks' partials

  // pass 3: normalise, scale, shift, the epilogue, one rounding
  float r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) r[j] = rstd[(c0 + j) / p.gw];
  if (active) {
    const T* ptr = src + start;
    T* dst = out + start;
    // the skip's pixel of a thread's row, and how far a step moves it
    const int pix = first + row;
    int hh = pix / p.w, ww = pix % p.w;
    const int dh = p.rows / p.w, dw = p.rows % p.w;
    for (int q = row; q < np; q += p.rows, ptr += step, dst += step) {
      float y[V];
      load_vec<T, V>(ptr, y);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        y[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y[j], m[j]), r[j]), sc[j]), bi[j]);
      }
      if constexpr (kSkip) {
        float s[V];
        load_vec<T, V>(static_cast<const T*>(p.skip) + image * p.skip_b + hh * p.skip_h +
                           ww * p.skip_w + c0,
                       s);
        round_to<T, V>(y);
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = __fadd_rn(y[j], s[j]);
        ww += dw, hh += dh;
        if (ww >= p.w) ww -= p.w, ++hh;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if constexpr (kAct != kNone) y[j] = y[j] < 0.f ? 0.f : y[j];
        if constexpr (kAct == kRelu6) y[j] = y[j] > 6.f ? 6.f : y[j];
      }
      store_vec<T, V>(dst, y);
    }
  }
  cluster_wait();   // no block leaves while another may still read its partials
}

int ceil_div(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }
int round_up(long long a, long long b) { return static_cast<int>((a + b - 1) / b * b); }
bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// Once per kernel, device and block size: opts the kernel into the most
// shared memory and into clusters of 16, and gives the largest cluster,
// 16 or the portable 8, that the card can hold at the most shared memory.
template <typename T, int V, int kAct, bool kSkip>
cudaError_t largest_cluster(int threads, int* out) {
  static int known[stem::kMaxDevices][3] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= stem::kMaxDevices) return cudaErrorInvalidDevice;
  const int t = threads <= 256 ? 0 : threads <= 512 ? 1 : 2;
  if (known[dev][t] != 0) {
    *out = known[dev][t];
    return cudaSuccess;
  }
  void (*kernel)(Params) = group_norm_kernel<T, V, kAct, kSkip>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kMaxCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = kMaxSmem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();   // clear it: 16 is then simply not offered
    clusters = 0;
  }
  known[dev][t] = clusters > 0 ? kMaxCluster : 8;
  *out = known[dev][t];
  return cudaSuccess;
}

int sm_count() {
  static int known[stem::kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= stem::kMaxDevices) return 0;
  if (known[dev] == 0) cudaDeviceGetAttribute(&known[dev], cudaDevAttrMultiProcessorCount, dev);
  return known[dev];
}

// The cluster size, the chunks and the shared memory of one call: the
// fewest blocks an image that cache their slice and give the card two
// blocks an SM, as far as clusters go (none of fewer than kRowAlign
// pixels); then, if that leaves one block an SM, more blocks an image
// where smaller slices let two share an SM (and one block's passes run
// under the other's copies). Uncached where no cluster size makes the
// slice fit. (On an H100 at b64, 80x80x64 bf16 takes 0.075 ms at 16
// blocks an image against 0.095 at 8; 160x160x32 0.150 at 8 against 0.19
// at 16, one block an SM either way.)
cudaError_t plan(Params& p, int batch, int bytes, int cs_max, int* cs_out, size_t* smem_out) {
  const long long c = p.c, hw = p.hw;
  const long long budget = kMaxSmem - p.off_cache;
  auto chunk_of = [&](int k) { return round_up(ceil_div(hw, k), kRowAlign); };
  auto fits = [&](int k) { return static_cast<long long>(chunk_of(k)) * c * bytes <= budget; };
  auto two_an_sm = [&](int k) {
    return fits(k) && 2 * (p.off_cache + static_cast<long long>(chunk_of(k)) * c * bytes +
                           kSmemReserved) <= kSmemPerSm;
  };
  const long long want = 2LL * sm_count();
  int cs = 1;
  while (cs < cs_max && chunk_of(cs) > kRowAlign && (!fits(cs) || batch * cs < want)) cs *= 2;
  if (fits(cs) && !two_an_sm(cs)) {
    for (int k = 2 * cs; k <= cs_max && chunk_of(k / 2) > kRowAlign; k *= 2) {
      if (two_an_sm(k)) {
        cs = k;
        break;
      }
    }
  }
  if (static_cast<long long>(batch) * cs > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.chunk = chunk_of(cs);
  p.cached = budget > 0 && fits(cs) && aligned16(p.x) && hw * c * bytes % 16 == 0;
  if (p.cached) {
    p.piece_rows = round_up(ceil_div(p.chunk, kPieces), kRowAlign);
    p.pieces = ceil_div(p.chunk, p.piece_rows);
  }
  *cs_out = cs;
  *smem_out = p.off_cache + (p.cached ? static_cast<size_t>(p.chunk) * c * bytes : 0);
  return cudaSuccess;
}

template <typename T, int V, int kAct, bool kSkip>
int launch(Params p, int batch, int threads, cudaStream_t stream) {
  int cs_max = 8, cs = 1;
  size_t smem = 0;
  cudaError_t err = largest_cluster<T, V, kAct, kSkip>(threads, &cs_max);
  if (err == cudaSuccess) err = plan(p, batch, sizeof(T), cs_max, &cs, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(batch * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, group_norm_kernel<T, V, kAct, kSkip>, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of the call's epilogue.
template <typename T, int V>
int launch_epilogue(const Params& p, int batch, int threads, cudaStream_t st) {
  const bool skip = p.skip != nullptr;
  if (p.act == kRelu) {
    return skip ? launch<T, V, kRelu, true>(p, batch, threads, st)
                : launch<T, V, kRelu, false>(p, batch, threads, st);
  }
  if (p.act == kRelu6) {
    return skip ? launch<T, V, kRelu6, true>(p, batch, threads, st)
                : launch<T, V, kRelu6, false>(p, batch, threads, st);
  }
  return skip ? launch<T, V, kNone, true>(p, batch, threads, st)
              : launch<T, V, kNone, false>(p, batch, threads, st);
}

}  // namespace

// GroupNorm of x (B, H, W, C) into out with `groups` groups, then the
// epilogue (act 0 none, 1 ReLU, 2 ReLU6; skip, when not null, added
// first). is_f32: float32 x, skip and out, else bf16. Takes up to 256
// vectors of 16 bytes a pixel (C a multiple of 8 bf16 or 4 float32, the
// pointers and the skip's strides aligned to them), else up to 1024
// channels one at a time. Returns a cudaError_t; the launch does not
// synchronise.
extern "C" int group_norm_launch(const void* x, const float* scale, const float* bias,
                                 const void* skip, void* out, int batch, int h, int w, int c,
                                 int groups, int is_f32, int act, float eps, long long skip_b,
                                 long long skip_h, long long skip_w, void* stream) {
  const long long hw = static_cast<long long>(h) * w;
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0 || groups <= 0 || c % groups != 0 ||
      act < kNone || act > kRelu6 || hw * c > 0x7fffffffLL || x == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = is_f32 ? 4 : 8;
  const bool wide = c % vec == 0 && aligned16(x) && aligned16(out) &&
                    (skip == nullptr || (aligned16(skip) && skip_b % vec == 0 &&
                                         skip_h % vec == 0 && skip_w % vec == 0));
  const int v = wide ? vec : 1;
  Params p{};
  p.x = x, p.scale = scale, p.bias = bias, p.skip = skip, p.out = out;
  p.skip_b = skip_b, p.skip_h = skip_h, p.skip_w = skip_w;
  p.hw = static_cast<int>(hw), p.w = w, p.c = c, p.groups = groups, p.gw = c / groups;
  p.act = act, p.eps = eps;
  p.n = static_cast<double>(hw) * p.gw;
  p.lanes = c / v;
  // a block of 256 threads, or for a scalar route with more channels 512 or 1024
  if (p.lanes > (v == 1 ? 1024 : 256)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = p.lanes <= 256 ? 256 : p.lanes <= 512 ? 512 : 1024;
  p.rows = threads / p.lanes;
  p.off_red = kPieces * 8;
  p.off_part = p.off_red + p.rows * c * 8;
  p.off_stats = p.off_part + 2 * groups * 8;
  p.off_cache = round_up(p.off_stats + 2LL * groups * 4, 128);
  if (p.off_cache > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) {
    return wide ? launch_epilogue<float, 4>(p, batch, threads, st)
                : launch_epilogue<float, 1>(p, batch, threads, st);
  }
  return wide ? launch_epilogue<__nv_bfloat16, 8>(p, batch, threads, st)
              : launch_epilogue<__nv_bfloat16, 1>(p, batch, threads, st);
}
