// Bitwise segment reduce for Hopper (sm_90a).
//
// Replaces the XLA-lowered loop bitplane_reduce of
// spark_tpu/ops/grouping.py:159 (bit_and, bit_or and bit_xor per segment):
//   spark_segment_bits_i64
//       int64 vals[n] + int32 seg[n] + bool mask[n] + int32 count[nseg]
//       -> int64 out[nseg]
//
// What it computes: out[s] is the AND, OR or XOR of vals[r] over the rows r
// with mask[r] != 0 and seg[r] == s. Rows whose segment id lies outside
// [0, nseg) add nothing, as the reference's segment_sum drops them. An
// empty segment ends as 0 for every kind: count[s] is the caller's count of
// the weighted rows of segment s (the histogram kernel's), and the AND of a
// segment whose count is 0 is cleared last, as the reference's AND plane is
// (sums == count) & (count > 0).
//
// The reference has no bitwise segment reduce: it splits each value into 64
// bit planes and sums a [n, 64] int32 matrix by segment, 64x the bytes of
// the values. Here the reduce is the hardware's own 64-bit atomicAnd,
// atomicOr and atomicXor on unsigned long long, which are exact and
// order-free, so the result repeats bit for bit:
//
// (a) A fill kernel writes the identity (all ones for AND, 0 for OR and
//     XOR) into every output.
// (b) nseg <= kSmemSegments: each block of a persistent grid keeps a private
//     copy of the outputs in shared memory (32 KB at most), reduces its
//     rows into it with shared-memory atomics, and merges every slot that
//     left the identity into the output with one global atomic.
// (c) Larger nseg: every live row does one global atomic; the output stays
//     in the 50 MB L2 while the rows stream past it.
// (d) AND only: a last kernel clears the segments whose count is 0.
//
// Rows stream in a grid-stride loop, one row per thread per pass: the mask
// is read for every row and the value and segment id only for live rows.
// The entry point launches on the caller's stream, allocates nothing,
// reads nothing on the host, does not synchronize, and returns
// cudaGetLastError() after its launches: it can run inside a CUDA graph
// capture.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemSegments = 4096;   // 32 KB of uint64 slots a block
constexpr int kBlocksPerSm = 4;

enum Kind { kAnd = 0, kOr = 1, kXor = 2 };

using u64 = unsigned long long;

template <int K>
__device__ __forceinline__ u64 identity() {
  return K == kAnd ? ~0ull : 0ull;
}

template <int K>
__device__ __forceinline__ void reduce_into(u64* p, u64 v) {
  if (K == kAnd) {
    atomicAnd(p, v);
  } else if (K == kOr) {
    atomicOr(p, v);
  } else {
    atomicXor(p, v);
  }
}

__global__ void __launch_bounds__(kThreads)
fill(u64* __restrict__ out, int nseg, u64 v) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nseg;
       i += gridDim.x * blockDim.x) {
    out[i] = v;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
bits_shared(const long long* __restrict__ vals,
            const int32_t* __restrict__ seg,
            const uint8_t* __restrict__ mask, int64_t n, int nseg,
            u64* __restrict__ out) {
  extern __shared__ u64 acc[];
  for (int i = threadIdx.x; i < nseg; i += blockDim.x) acc[i] = identity<K>();
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n; r += stride) {
    if (__ldcs(mask + r)) {
      const int s = __ldcs(seg + r);
      if (static_cast<unsigned>(s) < static_cast<unsigned>(nseg)) {
        reduce_into<K>(&acc[s], static_cast<u64>(__ldcs(vals + r)));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nseg; i += blockDim.x) {
    const u64 v = acc[i];
    if (v != identity<K>()) reduce_into<K>(&out[i], v);
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
bits_global(const long long* __restrict__ vals,
            const int32_t* __restrict__ seg,
            const uint8_t* __restrict__ mask, int64_t n, int nseg,
            u64* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n; r += stride) {
    if (__ldcs(mask + r)) {
      const int s = __ldcs(seg + r);
      if (static_cast<unsigned>(s) < static_cast<unsigned>(nseg)) {
        reduce_into<K>(&out[s], static_cast<u64>(__ldcs(vals + r)));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
clear_empty(u64* __restrict__ out, const int32_t* __restrict__ count,
            int nseg) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nseg;
       i += gridDim.x * blockDim.x) {
    if (count[i] <= 0) out[i] = 0ull;
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  return count;
}

unsigned blocks_for(int64_t items) {
  const int64_t resident = static_cast<int64_t>(kBlocksPerSm) * sm_count();
  const int64_t want = ceil_div(items < 1 ? 1 : items, kThreads);
  return static_cast<unsigned>(want < resident ? want : resident);
}

template <int K>
void launch_reduce(const long long* vals, const int32_t* seg,
                   const uint8_t* mask, int64_t n, int nseg, u64* out,
                   cudaStream_t s) {
  const unsigned grid = blocks_for(n);
  if (nseg <= kSmemSegments) {
    bits_shared<K><<<grid, kThreads, sizeof(u64) * nseg, s>>>(
        vals, seg, mask, n, nseg, out);
  } else {
    bits_global<K><<<grid, kThreads, 0, s>>>(vals, seg, mask, n, nseg, out);
  }
}

}  // namespace

// Prepares the launch path (the SM count) outside any graph capture.
extern "C" int spark_segment_bits_prepare() {
  return sm_count();
}

extern "C" int spark_segment_bits_i64(const void* vals, const void* seg,
                                      const void* mask, int64_t n, int nseg,
                                      int kind, const void* count, void* out,
                                      void* stream) {
  if (nseg < 1 || kind < kAnd || kind > kXor || count == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* o = static_cast<u64*>(out);
  const auto* v = static_cast<const long long*>(vals);
  const auto* g = static_cast<const int32_t*>(seg);
  const auto* m = static_cast<const uint8_t*>(mask);
  fill<<<blocks_for(nseg), kThreads, 0, s>>>(o, nseg,
                                             kind == kAnd ? ~0ull : 0ull);
  if (n > 0) {
    if (kind == kAnd) {
      launch_reduce<kAnd>(v, g, m, n, nseg, o, s);
    } else if (kind == kOr) {
      launch_reduce<kOr>(v, g, m, n, nseg, o, s);
    } else {
      launch_reduce<kXor>(v, g, m, n, nseg, o, s);
    }
  }
  if (kind == kAnd) {
    clear_empty<<<blocks_for(nseg), kThreads, 0, s>>>(
        o, static_cast<const int32_t*>(count), nseg);
  }
  return static_cast<int>(cudaGetLastError());
}
