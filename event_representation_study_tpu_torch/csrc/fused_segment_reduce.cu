// Fused sorted segment reduce for Hopper (sm_90a), bound to Python with ctypes
// (event_representation_study_tpu_torch/ops/fused_scatter.py).
//
// Replaces the TPU kernels of event_representation_study_tpu/ops/pallas_scatter.py:
//   K1 `_kernel` (:99, sum and max columns)  -> fused_segment_reduce_kernel<true, *>
//   K2 `_kernel_sum_only` (:63)              -> fused_segment_reduce_kernel<false, *>
//
// What it computes. Events arrive sorted by segment (pixel) id, stable in event
// position; ids >= num_segments are padding and sort to the end of a row. For
// every (b, s):
//   sums[b, s, k]  = sum of vs[b, k, i] over the pixel's events  (k < ks)
//   maxes[b, s, k] = max of vm[b, k, i], NEG_INF when empty       (k < km)
// Each sum is taken in event order, starting from 0, with no atomics on the
// values: reruns are bit-identical and equal the plain version on the CPU
// (index_add_).
//
// Bound. Any implementation reads each valid event's id and its ks + km values
// once and writes the (B, S, ks + km) outputs once; it does one add or max per
// value. At the Gen1 ERGO-12 serve shape (B=8, N=50,000, S=240*304, ks=18,
// km=3) that is 35.2 MB read + 49.0 MB written = 84.2 MB against 8.4 M flops,
// so the kernel is bound by bytes: 25.1 us at 3.35 TB/s (K2, km=0: 72.4 MB).
//
// Design. The pixels of a row are cut into tiles of kTile; persistent blocks
// (as many as fit on the card) take tiles in turn. A block is one producer
// warp and kTile consumer threads, joined by a ring of kStages shared-memory
// stages with a full and an empty mbarrier each.
// - Producer. For each of its tiles the warp finds the event range [lo, hi)
//   in the sorted ids itself (a 16-way search for each end at once, ~4
//   rounds for N=50k, in L2: each block first prefetches its share of the
//   ids), so no per-pixel or per-tile offsets table exists. It
//   then streams the range in chunks of up to kChunk events into the ring:
//   the ids and every value column, one 1-D TMA bulk copy (cp.async.bulk)
//   each, one lane per column, completing on the stage's full barrier. It
//   runs up to kStages chunks ahead of the consumers, so the next tile's
//   search and copies overlap this tile's reduce and stores. Bulk copies need 16-byte
//   addresses and sizes: the range is widened to multiples of 4 events, and
//   the strays this lets in (neighbouring tiles' events) drop out by the id
//   compare, as the Pallas kernel's aligned chunks do. When N % 4 != 0 or a
//   base address is not 16-byte aligned, the warp copies single 4-byte
//   elements with cp.async instead, completing on the same barrier (no
//   padded copy of the event axis is made).
// - Consumers. For each chunk they list the runs of the tile's pixels (one
//   pass, a thread per event), then split the work into (run, column) items,
//   consecutive threads on consecutive columns of a run: each item adds (or
//   maxes) its column over the run in event order into the pixel's output,
//   kept in shared memory across chunks. Work follows the events, not the
//   pixels: an empty pixel costs nothing, and a pixel with many events keeps
//   ks + km threads busy, not one.
// - Epilogue. The tile's (kTile x ks) and (kTile x km) outputs are contiguous
//   in the (B, S, k) layouts and sit in shared memory at their output offset
//   modulo 4, so the consumers write each with 16-byte vector stores; only a
//   partial first and last vector use scalar stores. No division per element.
// The previous design (one thread per pixel reading a (B, S+1) CSR table, 21
// column loops of single dependent loads, scalar stores with a runtime / and %)
// reached 31% of the bound.
//
// Sizes. kTile = 256: a Gen1 tile then holds ~175 events, one chunk; 128-pixel
// tiles double the per-tile work (search, zero fill, stores) per event and
// 512-pixel ones halve the blocks that fit. kChunk = 256: smaller chunks split
// a typical tile in two. kStages = 2: a third stage costs a block per SM,
// which costs more than it hides. Shared memory per block is kStages * (1 +
// ks + km) * (kChunk + 4) * 4 B of ring, (kTile * (ks + km) + 8) * 4 B of
// outputs and 3 KB of run lists: 70 KB for ERGO-12 (ks=18, km=3) and 61 KB
// for K2 at ks=18, 3 blocks per SM each (27 warps); 154 KB at the compiled
// maximum ks=32, km=16 (1 block). The consumers hold no per-column state in
// registers (one (run, column) item at a time), so the widths cost shared
// memory only.
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 256;            // pixels per tile, one consumer thread each
constexpr int kThreads = kTile + 32;  // the consumers, then the producer warp
constexpr int kChunk = 256;           // events per chunk (multiple of 4)
constexpr int kStages = 2;            // chunks in flight
constexpr int kPitch = kChunk + 4;    // floats between columns in shared memory
// Blocks that fit an SM at ERGO-12's widths (shared memory, see above). As a
// launch bound it caps registers at 65,536 / (3 * kThreads) = 75 a thread;
// without it the compiler keeps fewer and spills the producer's tile setup
// to the stack.
constexpr int kBlocksPerSm = 3;
constexpr int kMaxKs = 32;
constexpr int kMaxKm = 16;
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -3.4e38f;
static_assert(kTile % 32 == 0 && kChunk % 4 == 0 && kStages >= 2,
              "whole warps, 16-byte chunks, at least double buffered");

// Floats of staging for `count` outputs that start up to 3 floats past a
// 16-byte boundary: whole float4s, as the 16-byte fills write them.
__host__ __device__ constexpr int staged_floats(int count) { return (count + 6) & ~3; }

// Dynamic shared memory of one block: the ring, then the staged sums and maxes.
constexpr int smem_bytes(int ks, int km) {
  return (kStages * (1 + ks + km) * kPitch + staged_floats(kTile * ks) +
          staged_floats(kTile * km)) * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` to complete; traps (a launch error
// instead of a hung card) if it never does.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void copy4_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// a barrier of the consumer threads only (the producer warp runs ahead)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kTile) : "memory");
}

// [first index with id >= key_lo, first index with id >= key_hi) in the
// sorted row ids[0, n): one warp, lanes 0-15 on key_lo and 16-31 on key_hi,
// 16 probes a round each.
__device__ __forceinline__ int2 warp_range(const int* __restrict__ ids, int n, int key_lo, int key_hi) {
  const int lane = threadIdx.x & 31, half = lane >> 4, sub = lane & 15;
  const int key = half ? key_hi : key_lo;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int stride = (hi - lo + 15) >> 4;
    const int at = lo + sub * stride;
    const bool below = at < hi && __ldg(ids + at) < key;
    // the probes below the key are a prefix of the half's lanes
    const int count = __popc((__ballot_sync(0xffffffffu, below) >> (16 * half)) & 0xffffu);
    if (lo < hi) {
      if (count == 0) {
        hi = lo;  // ids[lo] >= key
      } else {
        const int next_lo = lo + (count - 1) * stride + 1;
        hi = min(hi, lo + count * stride);
        lo = next_lo;
      }
    }
  }
  return make_int2(__shfl_sync(0xffffffffu, lo, 0), __shfl_sync(0xffffffffu, lo, 16));
}

// dst[j] = src[j] for j in [pad, pad + count), by the consumer threads;
// dst and src 16-byte aligned
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src,
                                           int pad, int count) {
  const int end = pad + count;
  for (int j = threadIdx.x * 4; j < end; j += kTile * 4) {
    if (j >= pad && j + 4 <= end) {
      *reinterpret_cast<float4*>(dst + j) = *reinterpret_cast<const float4*>(src + j);
    } else {
      for (int e = max(j, pad); e < min(j + 4, end); ++e) dst[e] = src[e];
    }
  }
}

template <bool kHasMax, bool kBulk>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fused_segment_reduce_kernel(const int* __restrict__ seg,   // (B, n), sorted
                            const float* __restrict__ vs,  // (B, ks, n)
                            const float* __restrict__ vm,  // (B, km, n)
                            float* __restrict__ out_sum,   // (B, S, ks)
                            float* __restrict__ out_max,   // (B, S, km)
                            int batch, int n, int num_segments, int ks, int km) {
  // dynamic: the ring (kStages, 1 + ks + km, kPitch), then the tile's outputs,
  // sums then maxes, each at its output offset modulo 4
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int2 chunk_info[kStages];  // (events, last chunk of its tile)
  __shared__ int num_runs[2];
  __shared__ int2 runs[kChunk];         // (first event, pixel in the tile) of each run
  __shared__ int run_end[kTile];        // one past each pixel's last event in the chunk

  const int width = ks + (kHasMax ? km : 0);  // output columns
  const int cols = 1 + width;                 // streamed columns: ids, then values
  const int tiles = (num_segments + kTile - 1) / kTile;
  const int total = batch * tiles;
  float* ring = smem;
  float* staging = smem + static_cast<size_t>(kStages) * cols * kPitch;
  const int max_offset = staged_floats(kTile * ks);  // of the maxes in the staging

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the 4-byte path: 32 lanes' copies and the producer's own arrival
      mbar_init(&full[s], kBulk ? 1 : 33);
      mbar_init(&empty[s], 1);
    }
    num_runs[0] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTile) {  // the producer warp
    const int lane = threadIdx.x & 31;
    {
      // every block pulls its share of the sorted ids into L2, so that the
      // range searches probe L2 rather than device memory
      const size_t bytes = static_cast<size_t>(batch) * n * sizeof(int);
      const size_t share = (bytes + gridDim.x - 1) / gridDim.x;
      const char* base = reinterpret_cast<const char*>(seg);
      for (size_t at = blockIdx.x * share + lane * 128; at < min(bytes, (blockIdx.x + 1) * share);
           at += 32 * 128) {
        asm volatile("prefetch.global.L2 [%0];" ::"l"(base + at));
      }
    }
    int s = 0;
    uint32_t phase = 0;
    for (int w = blockIdx.x; w < total; w += gridDim.x) {
      const int b = w / tiles;
      const int pix = (w - b * tiles) * kTile;
      const int* seg_b = seg + static_cast<size_t>(b) * n;
      const float* vs_b = vs + static_cast<size_t>(b) * ks * n;
      const float* vm_b = kHasMax ? vm + static_cast<size_t>(b) * km * n : nullptr;
      const int2 range = warp_range(seg_b, n, pix, pix + min(kTile, num_segments - pix));
      int lo = range.x, hi = range.y;
      if (kBulk && lo < hi) {
        lo &= ~3;
        hi = min((hi + 3) & ~3, n);
      }
      const int num_chunks = max(1, (hi - lo + kChunk - 1) / kChunk);  // an empty tile: one empty chunk
      for (int c = 0; c < num_chunks; ++c) {
        mbar_wait(&empty[s], phase ^ 1);  // the consumers are done with the stage
        const int start = lo + c * kChunk;
        const int len = max(0, min(kChunk, hi - start));
        float* stage = ring + static_cast<size_t>(s) * cols * kPitch;
        if (lane == 0) chunk_info[s] = make_int2(len, c == num_chunks - 1);
        if constexpr (kBulk) {
          if (len == 0) {
            if (lane == 0) mbar_arrive(&full[s]);
          } else {
            // one lane per column issues its copy
            const uint32_t bytes = static_cast<uint32_t>(len) * 4;
            if (lane == 0) mbar_expect_tx(&full[s], bytes * cols);
            __syncwarp();
            for (int col = lane; col < cols; col += 32) {
              const void* src = col == 0 ? static_cast<const void*>(seg_b + start)
                              : col <= ks ? vs_b + static_cast<size_t>(col - 1) * n + start
                                          : vm_b + static_cast<size_t>(col - 1 - ks) * n + start;
              bulk_copy(stage + col * kPitch, src, bytes, &full[s]);
            }
          }
        } else {
          for (int i = lane; i < len; i += 32) {
            copy4_async(stage + i, seg_b + start + i);
            for (int k = 0; k < ks; ++k) {
              copy4_async(stage + (1 + k) * kPitch + i,
                          vs_b + static_cast<size_t>(k) * n + start + i);
            }
            if constexpr (kHasMax) {
              for (int k = 0; k < km; ++k) {
                copy4_async(stage + (1 + ks + k) * kPitch + i,
                            vm_b + static_cast<size_t>(k) * n + start + i);
              }
            }
          }
          copy4_arrive(&full[s]);
          if (lane == 0) mbar_arrive(&full[s]);  // after chunk_info: releases it
        }
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers. A thread's first (run, column) item and its stride over
  // the items r * width + k: the division is done once.
  const int r0 = threadIdx.x / width, k0 = threadIdx.x % width;
  const int dr = kTile / width, dk = kTile % width;
  int s = 0, chunk = 0;
  uint32_t phase = 0;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    const int b = w / tiles;
    const int pix = (w - b * tiles) * kTile;
    const int npix = min(kTile, num_segments - pix);
    const size_t first_s = (static_cast<size_t>(b) * num_segments + pix) * ks;
    const size_t first_m = (static_cast<size_t>(b) * num_segments + pix) * km;
    const int pad_s = static_cast<int>(first_s & 3), pad_m = static_cast<int>(first_m & 3);
    float* out_s = staging + pad_s;
    float* out_m = staging + max_offset + pad_m;
    // (16-byte stores; the pads and the tail are never stored)
    for (int q = threadIdx.x; q < (pad_s + npix * ks + 3) >> 2; q += kTile) {
      reinterpret_cast<float4*>(staging)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if constexpr (kHasMax) {
      for (int q = threadIdx.x; q < (pad_m + npix * km + 3) >> 2; q += kTile) {
        reinterpret_cast<float4*>(staging + max_offset)[q] =
            make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
      }
    }
    for (bool last = false; !last; ++chunk) {
      mbar_wait(&full[s], phase);
      const int len = chunk_info[s].x;
      last = chunk_info[s].y;
      const float* stage = ring + static_cast<size_t>(s) * cols * kPitch;
      const int* ids = reinterpret_cast<const int*>(stage);
      // list the runs of the tile's pixels in this chunk (in any order; one
      // shared atomic a warp)
      for (int base = 0; base < len; base += kTile) {
        const int i = base + threadIdx.x;
        const int id = i < len ? ids[i] : -1;
        const unsigned local = static_cast<unsigned>(id - pix);
        const bool mine = i < len && local < static_cast<unsigned>(npix);
        const bool starts = mine && (i == 0 || ids[i - 1] != id);
        const bool ends = mine && (i == len - 1 || ids[i + 1] != id);
        const unsigned mask = __ballot_sync(0xffffffffu, starts);
        int slot = 0;
        if ((threadIdx.x & 31) == 0 && mask) slot = atomicAdd(&num_runs[chunk & 1], __popc(mask));
        slot = __shfl_sync(0xffffffffu, slot, 0) + __popc(mask & ((1u << (threadIdx.x & 31)) - 1));
        // (first event | pixel << 16, one past the last event, or -1: see run_end)
        if (starts) runs[slot] = make_int2(i | static_cast<int>(local << 16), ends ? i + 1 : -1);
        if (ends && !starts) run_end[local] = i + 1;
      }
      consumers_sync();
      const int nr = num_runs[chunk & 1];
      if (threadIdx.x == 0) num_runs[(chunk + 1) & 1] = 0;
      // each (run, column) item adds or maxes its column over the run in
      // event order into the pixel's output; one thread owns it in this chunk
      int r = r0, k = k0;
      for (int j = threadIdx.x; j < nr * width; j += kTile) {
        const int2 run = runs[r];
        const int i0 = run.x & 0xffff, p = run.x >> 16;
        const int i1 = run.y >= 0 ? run.y : run_end[p];
        const float* col = stage + (1 + k) * kPitch;
        // a run that does not open the chunk opens its pixel: the output
        // still holds its initial value
        if (!kHasMax || k < ks) {
          float acc = i0 > 0 ? 0.f : out_s[p * ks + k];
          for (int i = i0; i < i1; ++i) acc += col[i];
          out_s[p * ks + k] = acc;
        } else {
          float acc = i0 > 0 ? kNegInf : out_m[p * km + (k - ks)];
          for (int i = i0; i < i1; ++i) acc = fmaxf(acc, col[i]);
          out_m[p * km + (k - ks)] = acc;
        }
        r += dr;
        k += dk;
        if (k >= width) {
          k -= width;
          ++r;
        }
      }
      consumers_sync();  // the stage, the run list and the run ends are free again
      if (threadIdx.x == 0) mbar_arrive(&empty[s]);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    store_tile(out_sum + (first_s - pad_s), staging, pad_s, npix * ks);
    if constexpr (kHasMax) {
      store_tile(out_max + (first_m - pad_m), staging + max_offset, pad_m, npix * km);
    }
    consumers_sync();  // the staging is free for the next tile
  }
}

template <bool kHasMax, bool kBulk>
cudaError_t launch(const int* seg, const float* vs, const float* vm, float* out_sum,
                   float* out_max, int batch, int n, int num_segments, int ks, int km,
                   cudaStream_t stream) {
  auto kernel = fused_segment_reduce_kernel<kHasMax, kBulk>;
  const int smem = smem_bytes(ks, km);
  // resident blocks (blocks per SM x SMs) for each device and width, found on
  // the first launch there: 0 until then
  static std::atomic<int> resident[kMaxDevices][kMaxKs + 1][kMaxKm + 1];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& slot = resident[device][ks][km];
  int blocks = slot.load(std::memory_order_acquire);
  if (blocks == 0) {
    // the limit the widest launch needs, so that it holds for every width
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(kMaxKs, kHasMax ? kMaxKm : 0));
    int sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    }
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = per_sm * sms;
    slot.store(blocks, std::memory_order_release);
  }
  const int tiles = batch * ((num_segments + kTile - 1) / kTile);
  const int grid = min(tiles, blocks);  // persistent: every block stays resident
  kernel<<<grid, kThreads, smem, stream>>>(seg, vs, vm, out_sum, out_max, batch, n,
                                           num_segments, ks, km);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Launches K1 (km > 0) or K2 (km == 0) on `stream` and returns
// cudaGetLastError() as an int: 0 when the launch was accepted.
extern "C" int fused_segment_reduce(const int* seg, const float* vs, const float* vm,
                                    float* out_sum, float* out_max, int batch, int n,
                                    int num_segments, int ks, int km, void* stream) {
  if (batch < 1 || n < 0 || num_segments < 1 || ks < 1 || ks > kMaxKs || km < 0 ||
      km > kMaxKm || (km > 0 && (!vm || !out_max)) || !aligned16(out_sum) ||
      (km > 0 && !aligned16(out_max)) ||
      static_cast<long long>(batch) * ((num_segments + kTile - 1) / kTile) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bulk = n % 4 == 0 && aligned16(seg) && aligned16(vs) && (km == 0 || aligned16(vm));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (km > 0) {
    err = bulk ? launch<true, true>(seg, vs, vm, out_sum, out_max, batch, n, num_segments, ks, km, st)
               : launch<true, false>(seg, vs, vm, out_sum, out_max, batch, n, num_segments, ks, km, st);
  } else {
    err = bulk ? launch<false, true>(seg, vs, nullptr, out_sum, nullptr, batch, n, num_segments, ks, 0, st)
               : launch<false, false>(seg, vs, nullptr, out_sum, nullptr, batch, n, num_segments, ks, 0, st);
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_segment_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
