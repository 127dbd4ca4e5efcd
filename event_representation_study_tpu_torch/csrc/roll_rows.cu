// Per-row dynamic slice ("roll") for Hopper (sm_90a), bound to Python with
// ctypes (event_representation_study_tpu_torch/ops/roll.py).
//
// Replaces the TPU kernel K3 of event_representation_study_tpu/ops/pallas_roll.py
// (`_roll_kernel`, launched by `roll_rows`), with the semantics of its XLA twin
// `roll_rows_xla`:
//   out[b, r, :, :] = x[b, r, s : s + w_out, :],  s = clamp(starts[b, r], 0, w_in - w_out)
// x is (B, R, w_in, C) and out (B, R, w_out, C), both contiguous, of 4-byte
// (float32) or 2-byte (bfloat16) elements.
//
// Bound. Pure data movement: each output row is one contiguous run of
// w_out * C elements that starts at element s * C of a contiguous input row.
// The kernel must read that window and write it once, so it is bound by
// bytes: 2 * B * R * w_out * C * elem_bytes over the memory rate. At the
// separable warp's pass V (B=8, R=1280, w_in=1668, w_out=1283, C=12, f32)
// that is 2 * 630.6 MB, ~0.38 ms at 3.35 TB/s; pass H (R=640) half of it.
//
// Design. The Pallas kernel's Mosaic workarounds (a 32-bit sublane rotate,
// bf16 lane pairs packed into int32, W padded to 8 and R to the block, starts
// staged in SMEM) have no counterpart here. One block owns one output row: it
// reads its start itself, clamps it, and streams the row with vector
// accesses, consecutive threads on consecutive vectors, so loads and stores
// coalesce. The vector is the widest of 16, 8, 4 or 2 bytes that divides the
// pixel (C * elem_bytes) and both base addresses; every row offset is then a
// multiple of it (f32 with C = 12: 48-byte pixels, 16-byte vectors; bf16 with
// C = 12: 24-byte pixels, 8-byte vectors). Each thread keeps kUnroll vectors
// in flight before it stores them. No shared memory, no tensor cores, no
// arithmetic on the data: the output is bit-identical to the input window.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename Vec>
__global__ void __launch_bounds__(kThreads)
roll_rows_kernel(const Vec* __restrict__ x,      // (rows, w_in * px_vecs)
                 const int* __restrict__ starts,  // (rows,)
                 Vec* __restrict__ out,           // (rows, w_out * px_vecs)
                 int w_in, int w_out, int px_vecs) {
  const size_t row = blockIdx.x;
  int s = starts[row];
  s = s < 0 ? 0 : (s > w_in - w_out ? w_in - w_out : s);
  const int n = w_out * px_vecs;
  const Vec* src = x + row * static_cast<size_t>(w_in) * px_vecs +
                   static_cast<size_t>(s) * px_vecs;
  Vec* dst = out + row * static_cast<size_t>(n);
  for (int i = threadIdx.x; i < n; i += kThreads * kUnroll) {
    Vec v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kThreads;
      if (j < n) v[u] = src[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kThreads;
      if (j < n) dst[j] = v[u];
    }
  }
}

template <typename Vec>
void launch(const void* x, const int* starts, void* out, int rows, int w_in,
            int w_out, int px_bytes, cudaStream_t stream) {
  roll_rows_kernel<Vec><<<rows, kThreads, 0, stream>>>(
      static_cast<const Vec*>(x), starts, static_cast<Vec*>(out), w_in, w_out,
      px_bytes / static_cast<int>(sizeof(Vec)));
}

}  // namespace

// Launches K3 on `stream` for `rows` = B * R rows of `channels` elements of
// `elem_bytes` (4 or 2) per pixel, and returns cudaGetLastError() as an int:
// 0 when the launch was accepted.
extern "C" int roll_rows(const void* x, const int* starts, void* out, int rows,
                         int w_in, int w_out, int channels, int elem_bytes,
                         void* stream) {
  if (rows < 1 || w_out < 1 || w_out > w_in || channels < 1 ||
      (elem_bytes != 4 && elem_bytes != 2) || !x || !starts || !out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int px_bytes = channels * elem_bytes;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(px_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) {
    launch<uint4>(x, starts, out, rows, w_in, w_out, px_bytes, st);
  } else if (align % 8 == 0) {
    launch<uint2>(x, starts, out, rows, w_in, w_out, px_bytes, st);
  } else if (align % 4 == 0) {
    launch<uint32_t>(x, starts, out, rows, w_in, w_out, px_bytes, st);
  } else {
    launch<uint16_t>(x, starts, out, rows, w_in, w_out, px_bytes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* roll_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
