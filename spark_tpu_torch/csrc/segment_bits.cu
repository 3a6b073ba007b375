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
// segment whose count is 0 is 0, as the reference's AND plane is
// (sums == count) & (count > 0).
//
// The reference has no bitwise segment reduce: it splits each value into 64
// bit planes and sums a [n, 64] int32 matrix by segment, 64x the bytes of
// the values. Here the reduce is exact and order-free (AND, OR and XOR are
// associative and commutative, and split by 32-bit half), so the result
// repeats bit for bit whatever order the atomics land in.
//
// What bounds it on an H100: the bytes (13 a row: the mask byte, the id and
// the value; 8 a segment written, 4 more read for AND) at 3.35 TB/s, as
// long as the atomics stay off the critical path; uniform ids over many
// segments leave one atomic a live row, and then L2's atomics bound it.
// A first version issued one atomic per live row whatever the order: a
// whole program's sorted-segment flow (equal ids side by side)
// queued them on a few addresses, and the ungrouped reduce (nseg == 1)
// sent every row to one word. This version combines in registers and
// warps first:
//
// (a) fill writes each output's start: the identity (0) for OR and XOR;
//     for AND all ones where count > 0 and 0 in an empty segment (which no
//     weighted row reaches, so it ends 0 without a clearing pass).
// (b) bits_reduce: each warp takes tiles of 512 consecutive rows from a
//     grid-stride loop, each lane 16 consecutive rows of a tile: one
//     16-byte load of mask bytes and four of ids (none where all 16 rows
//     are masked), and the values by eight 16-byte loads, which on the
//     global path the warp makes coalesced into shared memory (see
//     `staged`). Where a pointer is not 16-byte aligned (a view such as
//     values[1:]), and at the ragged last chunk, the lane loads row by
//     row instead.
//     Run pre-reduce: a lane folds consecutive live rows of equal id in a
//     register. It keeps its first run (which may continue the previous
//     lane's last) and its last open run (which the next lane's first may
//     continue), and emits the runs in between as they close.
//     Warp combine, where some lane's first run continues the previous
//     lane's last (a ballot; ids that change from row to row skip it and
//     each lane emits its two runs): a lane's first run is handed to the
//     lane before it (__shfl_down_sync) when that lane's last run has the
//     same id, so a run spanning lanes becomes one; the lanes' last runs
//     and remaining first runs are then grouped by id (__match_any_sync),
//     reduced by 32-bit half (__reduce_and/or/xor_sync) and one lane of
//     each group emits. Sorted input leaves about one atomic per run a
//     warp tile meets, and nseg == 1 one per warp tile.
// (c) Where each emission goes: nseg <= kSmemSegments, a block-private copy
//     in shared memory as two 32-bit halves (64-bit shared atomics compile
//     to a compare-and-swap loop; 32-bit ones are native), merged at the
//     end into the output with one 64-bit global atomic per slot that left
//     the identity; larger nseg, a 64-bit global atomic straight into the
//     output, which stays in the 50 MB L2 while the rows stream past it
//     (the loads are evict-first). An emission of the identity is skipped.
//
// The path (shared or global, 16-byte or row-by-row loads) is chosen on the
// host from nseg and the pointers' alignment: no input is read there. The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronize, and returns cudaGetLastError() after its launches: it can
// run inside a CUDA graph capture.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                  // consecutive rows a lane takes
constexpr int kTileRows = 32 * kRows;      // a warp's tile: 512 rows
constexpr int kSmemSegments = 4096;        // 32 KB of 32-bit halves a block
// resident blocks an SM: more warps hide the shared atomics' latency; the
// global path's L2 atomics run faster with fewer
constexpr int kSharedBlocksPerSm = 4;
constexpr int kGlobalBlocksPerSm = 2;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kAnd = 0, kOr = 1, kXor = 2 };

using u64 = unsigned long long;
using u32 = unsigned int;

template <int K>
__device__ __forceinline__ u64 identity64() {
  return K == kAnd ? ~0ull : 0ull;
}

template <int K>
__device__ __forceinline__ u32 identity32() {
  return K == kAnd ? ~0u : 0u;
}

template <int K>
__device__ __forceinline__ u64 combine(u64 a, u64 b) {
  return K == kAnd ? (a & b) : K == kOr ? (a | b) : (a ^ b);
}

template <int K, typename T>
__device__ __forceinline__ void atomic_into(T* p, T v) {
  if (K == kAnd) {
    atomicAnd(p, v);
  } else if (K == kOr) {
    atomicOr(p, v);
  } else {
    atomicXor(p, v);
  }
}

template <int K>
__device__ __forceinline__ u32 group_reduce(u32 peers, u32 x) {
  if (K == kAnd) return __reduce_and_sync(peers, x);
  if (K == kOr) return __reduce_or_sync(peers, x);
  return __reduce_xor_sync(peers, x);
}

// One run's value into segment s: two 32-bit atomics into the shared
// copy, or one 64-bit atomic into the output; none of the identity.
template <int K, bool Shared>
__device__ __forceinline__ void emit_one(int s, u64 v, u32* acc, int nseg,
                                         u64* out) {
  if (Shared) {
    const u32 lo = static_cast<u32>(v), hi = static_cast<u32>(v >> 32);
    if (lo != identity32<K>()) atomic_into<K>(&acc[s], lo);
    if (hi != identity32<K>()) atomic_into<K>(&acc[nseg + s], hi);
  } else if (v != identity64<K>()) {
    atomic_into<K>(&out[s], v);
  }
}

// The lanes of `peers` hold runs of segment s: their values reduce by
// 32-bit half and the group's lowest lane emits the result.
template <int K, bool Shared>
__device__ __forceinline__ void emit_group(u32 peers, int s, u64 v, u32* acc,
                                           int nseg, u64* out) {
  const u32 lo = group_reduce<K>(peers, static_cast<u32>(v));
  const u32 hi = group_reduce<K>(peers, static_cast<u32>(v >> 32));
  if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) {
    emit_one<K, Shared>(s, (static_cast<u64>(hi) << 32) | lo, acc, nseg,
                        out);
  }
}

__global__ void __launch_bounds__(kThreads)
fill(u64* __restrict__ out, const int32_t* __restrict__ count, int nseg,
     int is_and) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nseg;
       i += gridDim.x * blockDim.x) {
    out[i] = (is_and && count[i] > 0) ? ~0ull : 0ull;
  }
}

template <int K, bool Shared, bool Vec>
__global__ void __launch_bounds__(kThreads, Shared ? kSharedBlocksPerSm
                                                   : kGlobalBlocksPerSm)
bits_reduce(const long long* __restrict__ vals,
            const int32_t* __restrict__ seg,
            const uint8_t* __restrict__ mask, int64_t n, int nseg,
            u64* __restrict__ out) {
  // Shared only: acc[s] is the low half of segment s, acc[nseg + s] its high
  extern __shared__ u32 acc[];
  if (Shared) {
    for (int i = threadIdx.x; i < 2 * nseg; i += blockDim.x) {
      acc[i] = identity32<K>();
    }
    __syncthreads();
  }
  // Global only: a warp's tile of values, staged by coalesced loads (lane l
  // takes 16-byte chunks l, l + 32, ...) and read back as each lane's 16
  // consecutive values; the chunk index is swizzled so that neither side
  // meets a bank conflict. A lane's own 16-byte loads of its values would
  // touch 32 cache lines an instruction, in the L1's path the scattered
  // atomics take too.
  __shared__ uint4 staged[Shared ? 1 : kWarps * kTileRows / 2];
  uint4* const st = staged + (Shared ? 0 : (threadIdx.x >> 5) * kTileRows / 2);
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
       tile * kTileRows < n; tile += warps) {
    const int64_t base = tile * kTileRows + lane * kRows;
    int head = -1, cur = -1;   // segment of the first closed / open run
    u64 head_v = 0, run = 0;
    auto step = [&](int s, long long x) {
      if (static_cast<unsigned>(s) >= static_cast<unsigned>(nseg)) return;
      const u64 y = static_cast<u64>(x);
      if (s == cur) {
        run = combine<K>(run, y);
        return;
      }
      if (cur >= 0) {
        if (head < 0) {
          head = cur;
          head_v = run;
        } else {
          emit_one<K, Shared>(cur, run, acc, nseg, out);
        }
      }
      cur = s;
      run = y;
    };
    const bool stage = Vec && !Shared && (tile + 1) * kTileRows <= n;
    if (stage) {
      const auto* src = reinterpret_cast<const uint4*>(vals + tile * kTileRows);
#pragma unroll
      for (int i = 0; i < kTileRows / 64; ++i) {
        const int c = 32 * i + lane;
        st[c ^ ((c >> 3) & 7)] = __ldcs(src + c);
      }
      __syncwarp();
    }
    if (Vec && base + kRows <= n) {
      const uint4 mw = __ldcs(reinterpret_cast<const uint4*>(mask + base));
      if ((mw.x | mw.y | mw.z | mw.w) != 0) {
        const u32 words[4] = {mw.x, mw.y, mw.z, mw.w};
        int g[kRows];
        long long v[kRows];
#pragma unroll
        for (int q = 0; q < kRows / 4; ++q) {
          const int4 w =
              __ldcs(reinterpret_cast<const int4*>(seg + base) + q);
          g[4 * q] = w.x;
          g[4 * q + 1] = w.y;
          g[4 * q + 2] = w.z;
          g[4 * q + 3] = w.w;
        }
#pragma unroll
        for (int q = 0; q < kRows / 2; ++q) {
          if (stage) {
            const int c = kRows / 2 * lane + q;
            const uint4 w = st[c ^ ((c >> 3) & 7)];
            v[2 * q] = static_cast<long long>(
                (static_cast<u64>(w.y) << 32) | w.x);
            v[2 * q + 1] = static_cast<long long>(
                (static_cast<u64>(w.w) << 32) | w.z);
          } else {
            const longlong2 w =
                __ldcs(reinterpret_cast<const longlong2*>(vals + base) + q);
            v[2 * q] = w.x;
            v[2 * q + 1] = w.y;
          }
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if ((words[j >> 2] >> (8 * (j & 3))) & 0xffu) step(g[j], v[j]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int64_t r = base + j;
        if (r < n && __ldcs(mask + r)) {
          step(__ldcs(seg + r), __ldcs(vals + r));
        }
      }
    }
    if (stage) __syncwarp();   // the next tile overwrites the stage
    if (head >= 0 && head == cur) {
      run = combine<K>(run, head_v);
      head = -1;
    }
    // where no lane's first run continues the previous lane's last (ids
    // that change from row to row), each lane emits its own two runs
    const int prev_cur = __shfl_up_sync(kFull, cur, 1);
    const int first = head >= 0 ? head : cur;
    if (!__any_sync(kFull, lane > 0 && first >= 0 && first == prev_cur)) {
      if (cur >= 0) emit_one<K, Shared>(cur, run, acc, nseg, out);
      if (head >= 0) emit_one<K, Shared>(head, head_v, acc, nseg, out);
      continue;
    }
    // warp combine: this lane's first run joins the previous lane's last
    // when they share a segment; then every open and first run is grouped
    // by segment across the warp and emitted once per group
    const int next_head = __shfl_down_sync(kFull, head, 1);
    const u64 next_head_v = __shfl_down_sync(kFull, head_v, 1);
    if (lane < 31 && cur >= 0 && next_head == cur) {
      run = combine<K>(run, next_head_v);
    }
    if (lane > 0 && head >= 0 && head == prev_cur) head = -1;
    const u32 cur_peers = __match_any_sync(kFull, cur);
    if (cur >= 0) emit_group<K, Shared>(cur_peers, cur, run, acc, nseg, out);
    const u32 head_peers = __match_any_sync(kFull, head);
    if (head >= 0) {
      emit_group<K, Shared>(head_peers, head, head_v, acc, nseg, out);
    }
  }
  if (Shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nseg; i += blockDim.x) {
      const u64 x = (static_cast<u64>(acc[nseg + i]) << 32) | acc[i];
      if (x != identity64<K>()) atomic_into<K>(&out[i], x);
    }
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

unsigned blocks_for(int64_t items, int64_t per_block, int per_sm) {
  const int64_t resident = static_cast<int64_t>(per_sm) * sm_count();
  const int64_t want = ceil_div(items < 1 ? 1 : items, per_block);
  return static_cast<unsigned>(want < resident ? want : resident);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int K, bool Shared>
void launch_path(const long long* vals, const int32_t* seg,
                 const uint8_t* mask, int64_t n, int nseg, u64* out,
                 bool vec, cudaStream_t s) {
  const unsigned grid =
      blocks_for(n, static_cast<int64_t>(kThreads) * kRows,
                 Shared ? kSharedBlocksPerSm : kGlobalBlocksPerSm);
  const size_t smem = Shared ? sizeof(u32) * 2 * nseg : 0;
  if (vec) {
    bits_reduce<K, Shared, true><<<grid, kThreads, smem, s>>>(
        vals, seg, mask, n, nseg, out);
  } else {
    bits_reduce<K, Shared, false><<<grid, kThreads, smem, s>>>(
        vals, seg, mask, n, nseg, out);
  }
}

template <int K>
void launch_reduce(const long long* vals, const int32_t* seg,
                   const uint8_t* mask, int64_t n, int nseg, u64* out,
                   cudaStream_t s) {
  const bool vec = aligned16(vals) && aligned16(seg) && aligned16(mask);
  if (nseg <= kSmemSegments) {
    launch_path<K, true>(vals, seg, mask, n, nseg, out, vec, s);
  } else {
    launch_path<K, false>(vals, seg, mask, n, nseg, out, vec, s);
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
  fill<<<blocks_for(nseg, kThreads, 4), kThreads, 0, s>>>(
      o, static_cast<const int32_t*>(count), nseg, kind == kAnd);
  if (n > 0) {
    if (kind == kAnd) {
      launch_reduce<kAnd>(v, g, m, n, nseg, o, s);
    } else if (kind == kOr) {
      launch_reduce<kOr>(v, g, m, n, nseg, o, s);
    } else {
      launch_reduce<kXor>(v, g, m, n, nseg, o, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
