// Bloom runtime join filter for Hopper (sm_90a): build and probe.
//
// Replaces the XLA-lowered loop of the reference's runtime bloom join
// filter, spark_tpu/physical/operators.py:1486-1570 (_bloom_filter_probe:
// kb scatters, kp gathers), k = 2 probe positions a row:
//   spark_bloom_build
//       int64 h[n] + bool mask[n] -> uint8 bits[nbits]
//   spark_bloom_probe
//       uint8 bits[nbits] + int64 h[n] + bool mask[n]
//       -> bool out[n] + int64 live[1]
//
// What they compute: position j of hash h is mix64(h + off_j) & (nbits - 1)
// (nbits a power of two; mix64 is the port's splitmix64 finalizer,
// spark_tpu_torch/ops/hashing.py, with the 64-bit sum wrapping as the
// reference's int64 lanes do). The build zeroes the bitset, then sets both
// positions of every row whose mask is set; the probe keeps a row only
// where its mask is set and both of its positions are set, and counts the
// rows it keeps into live[0].
//
// A byte stands for a bit (the reference's bool bitset): a set is a plain
// store of 1, so rows that meet at one position race benignly (every store
// writes the same byte), and no atomic is needed. One thread a row.
//
// What bounds it on an H100: bytes. The build reads 9 B a row (hash and
// mask) and writes nbits bytes; the probe reads 9 B a row and writes 1 B a
// row plus the count. The bitset (at most 16 MiB) stays in the 50 MB L2
// while the rows stream past it, so its scattered stores and gathers are
// left out of the bound. This first version is the simple one: packing the
// bitset into words and holding it in shared memory are later work.
//
// Both entry points launch on the caller's stream (a memset node and one
// kernel), allocate nothing, read nothing on the host and do not
// synchronize; each returns cudaGetLastError() after its launches. They can
// run inside a CUDA graph capture.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kM1 = 0xBF58476D1CE4E5B9ull;
constexpr uint64_t kM2 = 0x94D049BB133111EBull;

__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= kM1;
  x ^= x >> 27;
  x *= kM2;
  return x ^ (x >> 31);
}

__global__ void bloom_build(const int64_t* __restrict__ h,
                            const uint8_t* __restrict__ mask, int64_t n,
                            uint64_t pos_mask, uint64_t off0, uint64_t off1,
                            uint8_t* __restrict__ bits) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || !mask[i]) return;
  uint64_t v = static_cast<uint64_t>(h[i]);
  bits[mix64(v + off0) & pos_mask] = 1;
  bits[mix64(v + off1) & pos_mask] = 1;
}

__global__ void bloom_probe(const uint8_t* __restrict__ bits,
                            const int64_t* __restrict__ h,
                            const uint8_t* __restrict__ mask, int64_t n,
                            uint64_t pos_mask, uint64_t off0, uint64_t off1,
                            uint8_t* __restrict__ out,
                            unsigned long long* __restrict__ live) {
  __shared__ unsigned warp_sums[kThreads / 32];
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned keep = 0;
  if (i < n) {
    if (mask[i]) {
      uint64_t v = static_cast<uint64_t>(h[i]);
      keep = bits[mix64(v + off0) & pos_mask] &&
             bits[mix64(v + off1) & pos_mask];
    }
    out[i] = static_cast<uint8_t>(keep);
  }
  // the block's kept rows: a warp sum, then one atomic a block
  unsigned w = __reduce_add_sync(0xffffffffu, keep);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = w;
  __syncthreads();
  if (warp == 0) {
    unsigned s = lane < kThreads / 32 ? warp_sums[lane] : 0;
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0 && s) atomicAdd(live, static_cast<unsigned long long>(s));
  }
}

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int spark_bloom_build(const int64_t* h, const uint8_t* mask,
                                 int64_t n, int64_t nbits, int64_t off0,
                                 int64_t off1, uint8_t* bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(bits, 0, static_cast<size_t>(nbits), s);
  if (n > 0) {
    bloom_build<<<grid_for(n), kThreads, 0, s>>>(
        h, mask, n, static_cast<uint64_t>(nbits - 1),
        static_cast<uint64_t>(off0), static_cast<uint64_t>(off1), bits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spark_bloom_probe(const uint8_t* bits, const int64_t* h,
                                 const uint8_t* mask, int64_t n,
                                 int64_t nbits, int64_t off0, int64_t off1,
                                 uint8_t* out, int64_t* live, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(live, 0, sizeof(int64_t), s);
  if (n > 0) {
    bloom_probe<<<grid_for(n), kThreads, 0, s>>>(
        bits, h, mask, n, static_cast<uint64_t>(nbits - 1),
        static_cast<uint64_t>(off0), static_cast<uint64_t>(off1), out,
        reinterpret_cast<unsigned long long*>(live));
  }
  return static_cast<int>(cudaGetLastError());
}
