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
// scatters with atomics, so nothing of that is carried over. What bounds
// each part on an H100 (3.35 TB/s HBM, 50 MB L2, 227 KB of shared memory a
// block) and what the design does about it:
//
// (a) Row stream, every path. Bound: the bytes of the mask and of the live
//     rows' keys (and values), read once. A persistent grid (occupancy x SM
//     count, at most kBlocksPerSm blocks an SM) walks chunks of kChunk rows;
//     per pass each thread loads four 32-bit words of mask (16 rows) and,
//     only where a word has a live row, four int4 of keys (four float4 of
//     values), every load coalesced across the warp and marked evict-first
//     so the rows do not push the output out of L2. The vector loop needs
//     the key and value pointers 16-byte aligned and the mask pointer 4-byte
//     aligned at row 0; a view such as keys[1:] is not, and then the whole
//     launch takes the scalar loop (one row per thread per pass). The
//     ragged end past the last whole chunk is scalar too.
// (b) Float32 sums of n_out <= kRegBuckets groups. Bound: bytes; float
//     atomicAdd on a few shared-memory addresses serialises on collisions
//     (on an H100 at 2^22 rows it took 1.5x the register path's time at 8
//     groups, 3.7x at 1). No atomic in the row loop: each thread keeps a
//     float sum per bucket, padded to 8 or 16, in registers; warps reduce
//     with shuffles at the end, in a fixed order, so the sums repeat bit for
//     bit. Each row costs a compare and add per padded bucket, so the path
//     stops at 16. Counts take (c) at every n_out: integer shared-memory
//     atomics were faster than register counters from 1 to 16 buckets.
// (c) Counts of n_out <= kSmemBuckets, sums of kRegBuckets < n_out <=
//     kSmemBuckets (224 KB of int32/float32 buckets). Bound: bytes, with
//     shared-memory atomics close behind. Each block keeps private
//     histograms in dynamic shared memory (up to 227 KB after
//     cudaFuncSetAttribute), one per warp while they stay within 32 KB, so
//     few lanes collide on small bucket counts.
// (d) Merge of (b) and (c): each block writes its partial histogram to a
//     scratch [blocks, n_out] buffer the caller allocates; a second kernel
//     sums the blocks bucket by bucket in a fixed order and writes every
//     output. It is a programmatic dependent launch: its blocks start while
//     the scatter kernel drains and wait (griddepcontrol.wait) for its
//     writes, which hides the launch gap. No memset, no contended
//     cross-block atomics; the float32 sums of path (b) come out the same
//     from run to run. The caller's scratch row count is the grid, so the
//     wrapper sizes the launch once (spark_scatter_scratch_rows) and the
//     launch does not recompute it.
// (e) n_out > kSmemBuckets (the dense aggregate's 2^21-bucket counts).
//     Bound: L2 atomic throughput, about one 32-byte sector operation per
//     live row's random 4-byte add; the HBM bytes are a fraction of that.
//     A zeroing kernel clears the output; the scatter kernel follows as a
//     programmatic dependent launch, loads its first rows while the zeroing
//     runs and waits for it before its first add. Every live row does one
//     global reduction (atomicAdd whose result is unused compiles to RED);
//     the 8 MB output stays resident in the 50 MB L2 while the rows stream
//     past it. It is too large for a thread-block cluster's distributed
//     shared memory (16 blocks hold about 3.6 MB).
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronize, and returns cudaGetLastError() after its launches
// (or cudaErrorInvalidValue when a path that needs scratch gets none).

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads * 16;            // rows per block pass (a)
constexpr int kBlocksPerSm = 2;
constexpr int kRegBuckets = 16;                  // path (b), sums only
constexpr int kSmemBuckets = 57344;              // path (c) up to here
constexpr int kSmemBytes = kSmemBuckets * 4;     // 224 KB
constexpr int kReplicaWords = 8192;              // replicas stay within 32 KB
constexpr int kMergeThreads = 1024;

enum Path { kRegisters, kShared, kGlobal };

template <bool kWeighted>
Path path_for(int n_out) {
  if (kWeighted && n_out <= kRegBuckets) return kRegisters;
  return n_out <= kSmemBuckets ? kShared : kGlobal;
}

template <typename T>
struct Inputs {
  const int32_t* keys;
  const T* vals;             // null for counts
  const uint8_t* mask;
  int64_t n;
  int n_out;
  int clip_hi;
};

// Programmatic dependent launch: let the kernel queued behind this one
// start its blocks now; they wait in griddepcontrol.wait until this grid
// has finished and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The row stream (a): acc.add(bucket, weight) for every live row of this
// block's share whose clipped key lies below n_out; acc.ready() once a
// pass's loads are issued and before its first add.
template <bool kVec, bool kWeighted, typename T, typename Acc>
__device__ __forceinline__ void stream_rows(const Inputs<T>& in, Acc& acc) {
  auto visit = [&](bool live, int32_t key, T w) {
    if (!live) return;
    const int k = key < 0 ? 0 : (key > in.clip_hi ? in.clip_hi : key);
    if (k < in.n_out) acc.add(k, w);
  };
  int64_t first = 0;
  if constexpr (kVec) {
    const int64_t chunks = in.n / kChunk;
    const auto* m4 = reinterpret_cast<const unsigned int*>(in.mask);
    const auto* k4 = reinterpret_cast<const int4*>(in.keys);
    const auto* v4 = reinterpret_cast<const float4*>(in.vals);
    for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
      // quad q holds rows 4q .. 4q+3; thread t takes quads t, t+kThreads, ..
      const int64_t q0 = c * (kChunk / 4) + threadIdx.x;
      unsigned int mw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) mw[j] = __ldcs(m4 + q0 + j * kThreads);
      int4 kv[4];
      float4 vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = make_int4(0, 0, 0, 0);
        vv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (mw[j] != 0u) {
          kv[j] = __ldcs(k4 + q0 + j * kThreads);
          if constexpr (kWeighted) vv[j] = __ldcs(v4 + q0 + j * kThreads);
        }
      }
      acc.ready();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned int m = mw[j];
        if constexpr (kWeighted) {
          visit(m & 0xffu, kv[j].x, T(vv[j].x));
          visit(m & 0xff00u, kv[j].y, T(vv[j].y));
          visit(m & 0xff0000u, kv[j].z, T(vv[j].z));
          visit(m & 0xff000000u, kv[j].w, T(vv[j].w));
        } else {
          visit(m & 0xffu, kv[j].x, T(1));
          visit(m & 0xff00u, kv[j].y, T(1));
          visit(m & 0xff0000u, kv[j].z, T(1));
          visit(m & 0xff000000u, kv[j].w, T(1));
        }
      }
    }
    first = chunks * kChunk;
  }
  acc.ready();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = first + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < in.n; i += stride) {
    if (in.mask[i]) {
      if constexpr (kWeighted) {
        visit(true, in.keys[i], in.vals[i]);
      } else {
        visit(true, in.keys[i], T(1));
      }
    }
  }
}

// --- path (b): registers ---------------------------------------------------

// Float sums of PP buckets in registers.
template <int PP>
struct RegSums {
  float s[PP] = {};

  __device__ __forceinline__ void add(int k, float v) {
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      if (j == k) s[j] += v;
    }
  }
  __device__ __forceinline__ void ready() {}
};

// Sum each of PP per-thread values over the block, in a fixed order
// (shuffle butterfly within each warp, then warps in index order), and
// write the first n_out sums to part[0 .. n_out).
template <int PP>
__device__ __forceinline__ void block_sums(float (&v)[PP], int n_out,
                                           float* part) {
  __shared__ float warp_sums[kWarps][PP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < PP; ++j) {
    float x = v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) warp_sums[warp][j] = x;
  }
  __syncthreads();
  if (threadIdx.x < n_out) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    part[threadIdx.x] = s;
  }
}

template <bool kVec, int PP>
__global__ void __launch_bounds__(kThreads)
sum_registers(Inputs<float> in, float* __restrict__ part) {
  RegSums<PP> acc;
  stream_rows<kVec, true>(in, acc);
  launch_dependents();
  block_sums(acc.s, in.n_out,
             part + static_cast<int64_t>(blockIdx.x) * in.n_out);
}

// --- path (c): shared memory -------------------------------------------------

template <typename T>
struct SharedAcc {
  T* hist;
  __device__ __forceinline__ void add(int k, T w) { atomicAdd(hist + k, w); }
  __device__ __forceinline__ void ready() {}
};

template <bool kVec, typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
scatter_shared(Inputs<T> in, int copies, T* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);
  const int n_out = in.n_out;
  const int total = n_out * copies;
  for (int i = threadIdx.x; i < total; i += kThreads) hist[i] = T(0);
  __syncthreads();
  SharedAcc<T> acc{hist + ((threadIdx.x >> 5) % copies) * n_out};
  stream_rows<kVec, kWeighted>(in, acc);
  launch_dependents();
  __syncthreads();
  T* out = part + static_cast<int64_t>(blockIdx.x) * n_out;
  for (int b = threadIdx.x; b < n_out; b += kThreads) {
    T s = T(0);
    for (int c = 0; c < copies; ++c) s += hist[c * n_out + b];
    out[b] = s;
  }
}

// --- path (d): merge of the block partials ------------------------------------

// Block x sums buckets 32x .. 32x+31 over the `blocks` rows of part: warp w
// takes rows w, w+32, .., lane l bucket 32x+l, then warp 0 adds the 32
// warps' sums in index order.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_partials(const T* __restrict__ part, int blocks, int n_out,
               T* __restrict__ out) {
  __shared__ T sums[kMergeThreads / 32][33];
  wait_for_prerequisite();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  T s = T(0);
  if (b < n_out) {
    for (int r = warp; r < blocks; r += kMergeThreads / 32) {
      s += part[static_cast<int64_t>(r) * n_out + b];
    }
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && b < n_out) {
    T t = T(0);
    for (int w = 0; w < kMergeThreads / 32; ++w) t += sums[w][lane];
    out[b] = t;
  }
}

// --- path (e): global reductions ---------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
zero_output(T* __restrict__ out, int n_out) {
  launch_dependents();
  const int stride = gridDim.x * kThreads;
  const int n4 = reinterpret_cast<uintptr_t>(out) % 16 == 0 ? n_out / 4 : 0;
  int4* o4 = reinterpret_cast<int4*>(out);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    o4[i] = make_int4(0, 0, 0, 0);
  }
  for (int i = n4 * 4 + blockIdx.x * kThreads + threadIdx.x; i < n_out;
       i += stride) {
    out[i] = T(0);
  }
}

template <typename T>
struct GlobalAcc {
  T* out;
  __device__ __forceinline__ void add(int k, T w) { atomicAdd(out + k, w); }
  // the zeroing kernel ahead of this one must have finished
  __device__ __forceinline__ void ready() { wait_for_prerequisite(); }
};

template <bool kVec, typename T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
scatter_global(Inputs<T> in, T* __restrict__ out) {
  GlobalAcc<T> acc{out};
  stream_rows<kVec, kWeighted>(in, acc);
}

// --- host side ---------------------------------------------------------------

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

int copies_for(int n_out) {
  const int c = kReplicaWords / n_out;
  return c < 1 ? 1 : (c > kWarps ? kWarps : c);
}

// Blocks of `kernel` with `smem` bytes of dynamic shared memory that stay
// resident on the card (occupancy x SMs, at most kBlocksPerSm an SM),
// asked of the CUDA runtime once per kernel and size.
int64_t resident_blocks(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, size_t>, int64_t> known;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(kernel, smem);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  per_sm = per_sm < 1 ? 1 : (per_sm > kBlocksPerSm ? kBlocksPerSm : per_sm);
  return known[key] = static_cast<int64_t>(per_sm) * sm_count();
}

// Blocks of a launch: as many as stay resident, fewer when the rows need
// fewer.
int grid_for(const void* kernel, size_t smem, int64_t n) {
  const int64_t blocks = ceil_div(n, kChunk);
  const int64_t resident = resident_blocks(kernel, smem);
  return static_cast<int>(blocks < 1 ? 1 : (blocks < resident ? blocks
                                                              : resident));
}

template <typename T, bool kWeighted>
const void* shared_kernel(bool vec) {
  return vec ? reinterpret_cast<const void*>(scatter_shared<true, T, kWeighted>)
             : reinterpret_cast<const void*>(scatter_shared<false, T, kWeighted>);
}

template <int PP>
const void* register_kernel(bool vec) {
  return vec ? reinterpret_cast<const void*>(sum_registers<true, PP>)
             : reinterpret_cast<const void*>(sum_registers<false, PP>);
}

const void* register_kernel_for(int n_out, bool vec) {
  return n_out <= 8 ? register_kernel<8>(vec) : register_kernel<16>(vec);
}

template <typename T, bool kWeighted>
const void* global_kernel(bool vec) {
  return vec ? reinterpret_cast<const void*>(scatter_global<true, T, kWeighted>)
             : reinterpret_cast<const void*>(scatter_global<false, T, kWeighted>);
}

template <typename T, bool kWeighted>
void allow_large_smem() {
  static const bool done = [] {
    for (bool vec : {false, true}) {
      cudaFuncSetAttribute(shared_kernel<T, kWeighted>(vec),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
    }
    return true;
  }();
  (void)done;
}

// Blocks of partial histograms a launch writes (paths b and c), 0 for the
// global path (e). The occupancy is that of the vector kernel.
template <typename T, bool kWeighted>
int partial_blocks(int64_t n, int n_out) {
  switch (path_for<kWeighted>(n_out)) {
    case kRegisters:
      return grid_for(register_kernel_for(n_out, true), 0, n);
    case kShared: {
      allow_large_smem<T, kWeighted>();
      const size_t smem = sizeof(T) * static_cast<size_t>(n_out) *
                          copies_for(n_out);
      return grid_for(shared_kernel<T, kWeighted>(true), smem, n);
    }
    default:
      return 0;
  }
}

// Launch `kernel` as a programmatic dependent of the kernel before it on
// stream s.
cudaError_t launch_dependent(const void* kernel, int blocks, int threads,
                             void** args, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

template <typename T, bool kWeighted>
int launch(const void* keys, const void* vals, const void* mask, int64_t n,
           int n_out, int clip_hi, void* out, void* scratch,
           int64_t scratch_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Inputs<T> in{static_cast<const int32_t*>(keys), static_cast<const T*>(vals),
               static_cast<const uint8_t*>(mask), n, n_out, clip_hi};
  const bool vec = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  T* o = static_cast<T*>(out);
  const Path path = path_for<kWeighted>(n_out);
  if (path == kGlobal) {
    const void* kernel = global_kernel<T, kWeighted>(vec);
    zero_output<T><<<static_cast<unsigned>(kBlocksPerSm * sm_count()),
                     kThreads, 0, s>>>(o, n_out);
    void* args[] = {&in, &o};
    launch_dependent(kernel, grid_for(kernel, 0, n), kThreads, args, s);
    return static_cast<int>(cudaGetLastError());
  }
  // one block per scratch row: any count of blocks covers every row
  if (scratch == nullptr || scratch_blocks < 1 ||
      scratch_blocks > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>(scratch_blocks);
  T* part = static_cast<T*>(scratch);
  if (path == kRegisters) {
    void* args[] = {&in, &part};
    cudaLaunchKernel(register_kernel_for(n_out, vec), dim3(blocks),
                     dim3(kThreads), args, 0, s);
  } else {
    allow_large_smem<T, kWeighted>();
    int copies = copies_for(n_out);
    const size_t smem = sizeof(T) * static_cast<size_t>(n_out) * copies;
    void* args[] = {&in, &copies, &part};
    cudaLaunchKernel(shared_kernel<T, kWeighted>(vec), dim3(blocks),
                     dim3(kThreads), args, smem, s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* cpart = part;
  int nb = blocks;
  void* args[] = {&cpart, &nb, &n_out, &o};
  launch_dependent(reinterpret_cast<const void*>(merge_partials<T>),
                   static_cast<int>(ceil_div(n_out, 32)), kMergeThreads,
                   args, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows of the [rows, n_out] scratch buffer a launch with these sizes
// needs (0: none); the launch runs one block per row it is given.
extern "C" int spark_scatter_scratch_rows(int weighted, int64_t n,
                                          int n_out) {
  return weighted ? partial_blocks<float, true>(n, n_out)
                  : partial_blocks<int, false>(n, n_out);
}

extern "C" int spark_scatter_count_i32(const void* keys, const void* mask,
                                       int64_t n, int n_out, int clip_hi,
                                       void* out, void* scratch,
                                       int64_t scratch_rows, void* stream) {
  return launch<int, false>(keys, nullptr, mask, n, n_out, clip_hi, out,
                            scratch, scratch_rows, stream);
}

extern "C" int spark_scatter_sum_f32(const void* keys, const void* vals,
                                     const void* mask, int64_t n, int n_out,
                                     int clip_hi, void* out, void* scratch,
                                     int64_t scratch_rows, void* stream) {
  return launch<float, true>(keys, vals, mask, n, n_out, clip_hi, out,
                             scratch, scratch_rows, stream);
}
