// Weighted scatter-accumulate kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of spark_tpu/ops/pallas_kernels.py:
//   spark_scatter_count_i32  <- partition_histogram (:84, pallas_call :67)
//       int32 keys[n] + bool mask[n] -> int32 counts[n_out]
//   spark_scatter_sum_f32    <- dense_group_sum_f32 (:145, pallas_call :128)
//       int32 keys[n] + float32 vals[n] + bool mask[n] -> float32 sums[n_out]
//
// Both compute what the TPU kernels compute: each live row (mask != 0) adds
// its weight (1, or its value) to bucket clip(key, 0, clip_hi), where
// clip_hi = round_up(n_out, 128) - 1 is the TPU kernel's padded last bucket;
// buckets at or past n_out are dropped, as the TPU kernel truncates its
// padded output to n_out. Masked rows add nothing.
//
// The TPU kernel recasts the scatter as a one-hot MXU product per row block
// accumulated across a sequential grid. Hopper has no sequential grid and
// scatters cheaply with atomics, so nothing of that is carried over:
//   * every block walks its rows with a grid-stride loop, skipping masked
//     rows;
//   * when the buckets fit in 48 KB of shared memory (n_out <= 12288), each
//     block keeps private histograms there -- one per warp when they fit,
//     so few warps collide on a small bucket count -- and merges them into
//     global memory once at the end;
//   * above that (the 2^21-bucket dense `present` count) every live row
//     does one global atomicAdd.
//
// Bound: the kernel reads each mask byte once (1 B), the key (4 B) and, for
// the sum, the value (4 B) of each live row, and writes n_out outputs (4 B
// each), so on an H100 (3.35 TB/s) the least time is those bytes /
// 3.35 TB/s; it is bound by bytes, not operations (one add per live row).
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronize, and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ int clip_key(int32_t k, int clip_hi) {
  return k < 0 ? 0 : (k > clip_hi ? clip_hi : k);
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
scatter_shared(const int32_t* __restrict__ keys, const T* __restrict__ vals,
               const uint8_t* __restrict__ mask, int64_t n, int n_out,
               int clip_hi, int copies, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);
  const int total = n_out * copies;
  for (int i = threadIdx.x; i < total; i += blockDim.x) hist[i] = T(0);
  __syncthreads();

  T* mine = hist + ((threadIdx.x >> 5) % copies) * n_out;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!mask[i]) continue;
    const int k = clip_key(keys[i], clip_hi);
    if (k >= n_out) continue;
    if constexpr (kWeighted) {
      atomicAdd(&mine[k], vals[i]);
    } else {
      atomicAdd(&mine[k], T(1));
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < n_out; b += blockDim.x) {
    T s = T(0);
    for (int c = 0; c < copies; ++c) s += hist[c * n_out + b];
    if (s != T(0)) atomicAdd(&out[b], s);
  }
}

template <typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
scatter_global(const int32_t* __restrict__ keys, const T* __restrict__ vals,
               const uint8_t* __restrict__ mask, int64_t n, int n_out,
               int clip_hi, T* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (!mask[i]) continue;
    const int k = clip_key(keys[i], clip_hi);
    if (k >= n_out) continue;
    if constexpr (kWeighted) {
      atomicAdd(&out[k], vals[i]);
    } else {
      atomicAdd(&out[k], T(1));
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T, bool kWeighted>
int launch(const void* keys, const void* vals, const void* mask, int64_t n,
           int n_out, int clip_hi, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* v = static_cast<const T*>(vals);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<T*>(out);
  const int64_t bytes_one = static_cast<int64_t>(n_out) * sizeof(T);
  if (bytes_one <= kSmemBytes) {
    int copies = static_cast<int>(kSmemBytes / bytes_one);
    copies = copies > kWarps ? kWarps : copies;
    // enough rows per block that the per-block zero + merge of n_out
    // buckets stays small beside the rows it covers
    const int64_t rows_per_block =
        4 * static_cast<int64_t>(n_out) > 4096 ? 4 * static_cast<int64_t>(n_out) : 4096;
    int64_t blocks = ceil_div(n, rows_per_block);
    const int64_t cap = static_cast<int64_t>(sm_count()) * 4;
    blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
    const size_t smem = static_cast<size_t>(bytes_one) * copies;
    scatter_shared<T, kWeighted><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
        k, v, m, n, n_out, clip_hi, copies, o);
  } else {
    int64_t blocks = ceil_div(n, kThreads);
    const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
    blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
    scatter_global<T, kWeighted><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        k, v, m, n, n_out, clip_hi, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int spark_scatter_count_i32(const void* keys, const void* mask,
                                       int64_t n, int n_out, int clip_hi,
                                       void* out, void* stream) {
  return launch<int, false>(keys, nullptr, mask, n, n_out, clip_hi, out, stream);
}

extern "C" int spark_scatter_sum_f32(const void* keys, const void* vals,
                                     const void* mask, int64_t n, int n_out,
                                     int clip_hi, void* out, void* stream) {
  return launch<float, true>(keys, vals, mask, n, n_out, clip_hi, out, stream);
}
