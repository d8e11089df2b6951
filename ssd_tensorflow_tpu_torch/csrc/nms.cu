// Fused pairwise IoU + greedy NMS for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssd_tensorflow_tpu/ops/nms_pallas.py
// (_nms_kernel, entry nms_keep_pallas). Per image: the +1-pixel IoU of
// the class-shifted canvas corners of the D score-sorted candidates,
// then the sequential greedy loop (a kept, valid i suppresses j > i when
// IoU > threshold). Output is the (B, D) keep mask.
//
// What bounds it on this card: neither bytes (D*21 bytes in and out per
// image) nor operations (~15 per candidate pair) but the latency of the
// D-step dependent scan, one step per candidate.
//
// Design: one block per image. Its threads compute the IoU > threshold
// relation of the upper triangle as bitmask rows in shared memory,
// ceil(D/32) words per row (5.6 KB at D=200). One warp then runs the
// greedy scan: lane l holds word l of the "alive" set (valid and not yet
// suppressed), step i reads bit i with one shuffle and, when i is alive,
// clears row i's bits from every word in one instruction per lane. No
// padding of D is needed; D is capped at kMaxD (the mask then takes
// 128 KB of dynamic shared memory).
//
// Bit-exactness with the plain version (ops/nms.py): every operation is
// an explicitly rounded intrinsic in the JAX package's order, so nvcc
// cannot contract a multiply and an add into an FMA, and the division is
// IEEE round-to-nearest (__fdiv_rn; the library is built without fast
// math). min/max propagate NaN as jnp.minimum / torch.minimum do. The
// comparison is float32 against the float32 threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 1024;
constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory allowed without opt-in
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ corners, const uint8_t* __restrict__ valid,
           uint8_t* __restrict__ keep, int d, float threshold) {
  extern __shared__ uint32_t smem[];
  const int words = (d + 31) / 32;
  uint32_t* mask = smem;                                  // d * words
  float* x0 = reinterpret_cast<float*>(mask + d * words);  // 5 arrays of d
  float* x1 = x0 + d;
  float* y0 = x1 + d;
  float* y1 = y0 + d;
  float* area = y1 + d;

  const int b = blockIdx.x;
  const float* c = corners + static_cast<size_t>(b) * d * 4;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(c)[i];
    x0[i] = v.x;
    x1[i] = v.y;
    y0[i] = v.z;
    y1[i] = v.w;
    area[i] = __fmul_rn(__fadd_rn(__fsub_rn(v.y, v.x), 1.0f),
                        __fadd_rn(__fsub_rn(v.w, v.z), 1.0f));
  }
  __syncthreads();

  for (int task = threadIdx.x; task < d * words; task += blockDim.x) {
    const int i = task / words;
    const int w = task - i * words;
    const float ax0 = x0[i], ax1 = x1[i], ay0 = y0[i], ay1 = y1[i], aa = area[i];
    uint32_t bits = 0;
    const int j_end = min(d, (w + 1) * 32);
    for (int j = max(i + 1, w * 32); j < j_end; ++j) {
      const float iw = nan_max(
          0.0f, __fadd_rn(__fsub_rn(nan_min(ax1, x1[j]), nan_max(ax0, x0[j])), 1.0f));
      const float ih = nan_max(
          0.0f, __fadd_rn(__fsub_rn(nan_min(ay1, y1[j]), nan_max(ay0, y0[j])), 1.0f));
      const float inter = __fmul_rn(iw, ih);
      const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(aa, area[j]), inter));
      if (iou > threshold) bits |= 1u << (j - w * 32);
    }
    mask[task] = bits;
  }
  __syncthreads();

  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const uint8_t* v = valid + static_cast<size_t>(b) * d;
  uint32_t alive = 0;
  for (int k = 0; k < 32; ++k) {
    const int j = lane * 32 + k;
    if (j < d && v[j]) alive |= 1u << k;
  }
  for (int i = 0; i < d; ++i) {
    const uint32_t wi = __shfl_sync(0xffffffffu, alive, i >> 5);
    if ((wi >> (i & 31)) & 1u) {
      if (lane < words) alive &= ~mask[i * words + lane];
    }
  }
  uint8_t* out = keep + static_cast<size_t>(b) * d;
  for (int k = 0; k < 32; ++k) {
    const int j = lane * 32 + k;
    if (j < d) out[j] = (alive >> k) & 1u;
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

// corners: (B, D, 4) float32 contiguous; valid, keep: (B, D) bytes 0/1.
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int nms_keep_launch(const float* corners, const uint8_t* valid, uint8_t* keep,
                               int batch, int d, float threshold, void* stream) {
  if (batch <= 0 || d <= 0 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const int words = (d + 31) / 32;
  const size_t smem = static_cast<size_t>(d) * words * 4 + static_cast<size_t>(d) * 5 * 4;
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      corners, valid, keep, d, threshold);
  return static_cast<int>(cudaGetLastError());
}
