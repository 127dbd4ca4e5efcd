// Fused sorted segment reduce for Hopper (sm_90a), bound to Python with ctypes
// (event_representation_study_tpu_torch/ops/fused_scatter.py).
//
// Replaces the TPU kernels of event_representation_study_tpu/ops/pallas_scatter.py:
//   K1 `_kernel` (sum and max columns)  -> fused_segment_reduce_kernel<true>
//   K2 `_kernel_sum_only`               -> fused_segment_reduce_kernel<false>
//
// What it computes. Events arrive sorted by segment (pixel) id, stable in event
// position; CSR offsets give pixel s of batch row b the sorted range
// [offs[b, s], offs[b, s + 1]). For every (b, s):
//   sums[b, s, k]  = sum of vs[b, k, i] over the pixel's events  (k < ks)
//   maxes[b, s, k] = max of vm[b, k, i], NEG_INF when empty       (k < km)
//
// Bound. The kernel reads the CSR offsets and every value once, writes every
// output once, and does one add or max per value read. At the Gen1 ERGO-12
// serve shape (B=8, N=50,000, ks=18, km=3, S=240*304) that is 2.3 MB of
// offsets + 33.6 MB of values + 49.0 MB of outputs = ~85 MB of device-memory
// traffic against ~8.4 M flops, so the kernel is bound by bytes: ~25.4 us at
// 3.35 TB/s.
//
// Design. The TPU kernel accumulated a one-hot matmul on the MXU only because
// XLA serialises scatters. Here one thread owns one (b, pixel) and walks its
// events in sorted order, so every sum is taken in one fixed order and a run is
// bit-identical to the one before it (no float atomics). Neighbouring threads
// own neighbouring pixels, whose ranges are adjacent in the sorted stream, so
// a warp's reads of one column are close to contiguous. Each thread stages its
// output row in shared memory and the block stores its (256 x k) tile with
// contiguous, coalesced writes. A pixel holding many events serialises on its
// one thread; Gen1 windows average under one event per pixel.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKs = 32;  // shared tile <= 256 * (32 + 8) * 4 B = 40 KB
constexpr int kMaxKm = 8;
constexpr float kNegInf = -3.4e38f;

template <bool kHasMax>
__global__ void __launch_bounds__(kThreads)
fused_segment_reduce_kernel(const int* __restrict__ offs,  // (B, S + 1)
                            const float* __restrict__ vs,  // (B, ks, n)
                            const float* __restrict__ vm,  // (B, km, n)
                            float* __restrict__ out_sum,   // (B, S, ks)
                            float* __restrict__ out_max,   // (B, S, km)
                            int n, int num_segments, int ks, int km) {
  extern __shared__ float tile[];  // (kThreads, ks + km)
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kThreads;
  const int s = s0 + threadIdx.x;
  const int width = kHasMax ? ks + km : ks;
  const int rows = min(kThreads, num_segments - s0);

  if (s < num_segments) {
    const int* o = offs + static_cast<size_t>(b) * (num_segments + 1);
    const int start = o[s];
    const int end = o[s + 1];
    float* row = tile + threadIdx.x * width;
    const float* v = vs + static_cast<size_t>(b) * ks * n;
    for (int k = 0; k < ks; ++k) {
      const float* col = v + static_cast<size_t>(k) * n;
      float acc = 0.f;
      for (int i = start; i < end; ++i) acc += col[i];
      row[k] = acc;
    }
    if constexpr (kHasMax) {
      const float* w = vm + static_cast<size_t>(b) * km * n;
      for (int k = 0; k < km; ++k) {
        const float* col = w + static_cast<size_t>(k) * n;
        float acc = kNegInf;
        for (int i = start; i < end; ++i) acc = fmaxf(acc, col[i]);
        row[ks + k] = acc;
      }
    }
  }
  __syncthreads();

  float* dst_sum = out_sum + (static_cast<size_t>(b) * num_segments + s0) * ks;
  for (int j = threadIdx.x; j < rows * ks; j += kThreads) {
    dst_sum[j] = tile[(j / ks) * width + j % ks];
  }
  if constexpr (kHasMax) {
    float* dst_max = out_max + (static_cast<size_t>(b) * num_segments + s0) * km;
    for (int j = threadIdx.x; j < rows * km; j += kThreads) {
      dst_max[j] = tile[(j / km) * width + ks + j % km];
    }
  }
}

}  // namespace

// Launches K1 (km > 0) or K2 (km == 0) on `stream` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int fused_segment_reduce(const int* offs, const float* vs,
                                    const float* vm, float* out_sum,
                                    float* out_max, int batch, int n,
                                    int num_segments, int ks, int km,
                                    void* stream) {
  if (batch < 1 || batch > 65535 || n < 0 || num_segments < 1 || ks < 1 ||
      ks > kMaxKs || km < 0 || km > kMaxKm || (km > 0 && (!vm || !out_max))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((num_segments + kThreads - 1) / kThreads, batch);
  const size_t smem = static_cast<size_t>(kThreads) * (ks + km) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (km > 0) {
    fused_segment_reduce_kernel<true><<<grid, kThreads, smem, st>>>(
        offs, vs, vm, out_sum, out_max, n, num_segments, ks, km);
  } else {
    fused_segment_reduce_kernel<false><<<grid, kThreads, smem, st>>>(
        offs, vs, nullptr, out_sum, nullptr, n, num_segments, ks, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_segment_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
