// Run layout of a presorted grouping key for Hopper (sm_90a).
//
// Replaces the XLA-lowered loop of spark_tpu/ops/grouping.py:63
// group_rows_presorted (the sorted-run aggregate's segment structure:
// an adjacent difference, a cumsum of run ids and a segment_min of each
// run's first live row):
//   spark_run_layout_i32 / spark_run_layout_i64
//       int32 or int64 key[n] + bool mask[n]
//       -> bool start[n] + int64 seg[n] + int64 num_groups[1]
//
// What it computes, for ANY key order: a run is a maximal stretch of equal
// keys over all n rows (masked and padding rows included). Row i opens a
// group (start[i] = 1) iff mask[i] is set and no row j < i of its run has
// mask[j] set. seg[i] = max(starts in [0, i] - 1, 0) and num_groups[0] =
// the number of starts. Sorted keys make each group one run of equal keys;
// the tests also feed unsorted keys, for which the definition still holds
// row for row.
//
// Design: tiles of kTile = 1024 consecutive rows (256 threads, 4 rows a
// thread), three launches.
// (1) run_summary: each block scans its tile. A break is a row i > the
//     tile's first whose key differs from key[i - 1]; the breaks cut the
//     tile into segments (an inclusive sum scan gives each row its segment
//     index), and a row is a local start iff it is live and the last live
//     row before it in the tile lies in an earlier segment (an exclusive
//     max scan of the live rows' segment indices). The tile writes: its
//     local start count, whether it has a break, whether its leading and
//     trailing segments hold a live row, and whether its first row
//     continues the previous tile's last run (key[s] == key[s - 1]).
// (2) run_carry: one block of 1024 threads scans the tiles' summaries.
//     The run open at a tile's end has had a live row iff
//       f_t(open) = A_t || (B_t && open)
//     with A_t = the trailing (or, without a break, the only) segment's
//     liveness and B_t = no break and the tile continues the previous run;
//     these maps compose associatively, so the threads take contiguous
//     chunks of tiles, compose them, scan the compositions across the
//     block, and walk their chunks again. A tile's carry is set iff its
//     first row continues a run that already had a live row; its start
//     count is then one less where its leading segment holds a live row.
//     An exclusive sum of the counts gives each tile's first group id,
//     and the total is num_groups.
// (3) run_write: each block rescans its tile as in (1), drops the leading
//     segment's local start where its carry is set, and writes start and
//     seg (the tile's first group id plus an inclusive sum of its starts).
// Scratch: 14 bytes a tile (summaries, carries and first group ids,
// spark_run_layout_scratch_bytes), sized by n and never by the data.
//
// What bounds it on an H100: bytes. Each row's key and mask byte are read
// and its start byte and 8-byte id written: 18 (int64 keys) or 14 (int32
// keys) bytes a row at 3.35 TB/s. This first version reads the key and the
// mask twice (passes 1 and 3) and with scalar loads; one pass with
// decoupled look-back and vector loads is later work.
//
// The entry points launch on the caller's stream, allocate nothing, read
// nothing on the host and do not synchronize; each returns
// cudaGetLastError() after its launches. They can run inside a CUDA graph
// capture.

#include <cstdint>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;

// a tile's summary bits (run_summary -> run_carry)
constexpr uint8_t kHasBreak = 1;
constexpr uint8_t kLeadLive = 2;
constexpr uint8_t kTrailLive = 4;
constexpr uint8_t kContinues = 8;

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

// f(x) = a || (b && x), composed left (earlier tiles) to right
struct OpenMap {
  bool a;
  bool b;
};

struct ComposeOp {
  __device__ __forceinline__ OpenMap operator()(OpenMap first,
                                                OpenMap then) const {
    return OpenMap{then.a || (then.b && first.a), then.b && first.b};
  }
};

using IntScan = cub::BlockScan<int, kThreads>;

// One tile's rows after the scans of pass (1) and (3).
struct TileScan {
  int seg[kItems];      // segment index of the row within the tile
  bool local[kItems];   // live, and the first live row of its segment here
  int breaks;           // the tile's breaks: its last segment's index
};

// Scans the tile that starts at row s (rows past n are not live and make
// no break). `temp` is reused by both scans.
template <typename K>
__device__ __forceinline__ void scan_tile(const K* __restrict__ key,
                                          const uint8_t* __restrict__ mask,
                                          int64_t n, int64_t s,
                                          typename IntScan::TempStorage& temp,
                                          TileScan& t) {
  const int64_t base = s + static_cast<int64_t>(threadIdx.x) * kItems;
  int brk[kItems];
  int live_seg[kItems];
  bool live[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    const bool in = i < n;
    live[j] = in && mask[i] != 0;
    brk[j] = (in && i > s && key[i] != key[i - 1]) ? 1 : 0;
  }
  IntScan(temp).InclusiveSum(brk, t.seg, t.breaks);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) live_seg[j] = live[j] ? t.seg[j] : -1;
  int last_live[kItems];
  IntScan(temp).ExclusiveScan(live_seg, last_live, -1, MaxOp());
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    t.local[j] = live[j] && last_live[j] != t.seg[j];
  }
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    run_summary(const K* __restrict__ key, const uint8_t* __restrict__ mask,
                int64_t n, int32_t* __restrict__ tile_starts,
                uint8_t* __restrict__ tile_bits) {
  __shared__ typename IntScan::TempStorage temp;
  __shared__ typename cub::BlockReduce<int, kThreads>::TempStorage red;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kTile;
  TileScan t;
  scan_tile(key, mask, n, s, temp, t);
  int count = 0;
  bool lead = false, trail = false;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    count += t.local[j] ? 1 : 0;
    // a segment holds a live row iff it holds a local start
    lead = lead || (t.local[j] && t.seg[j] == 0);
    trail = trail || (t.local[j] && t.seg[j] == t.breaks);
  }
  const int total = cub::BlockReduce<int, kThreads>(red).Sum(count);
  const int any_lead = __syncthreads_or(lead);
  const int any_trail = __syncthreads_or(trail);
  if (threadIdx.x == 0) {
    uint8_t bits = 0;
    if (t.breaks > 0) bits |= kHasBreak;
    if (any_lead) bits |= kLeadLive;
    if (any_trail) bits |= kTrailLive;
    if (s > 0 && key[s] == key[s - 1]) bits |= kContinues;
    tile_starts[blockIdx.x] = total;
    tile_bits[blockIdx.x] = bits;
  }
}

__device__ __forceinline__ OpenMap tile_map(uint8_t bits) {
  if (bits & kHasBreak) return OpenMap{(bits & kTrailLive) != 0, false};
  return OpenMap{(bits & kLeadLive) != 0, (bits & kContinues) != 0};
}

__global__ void __launch_bounds__(kCarryThreads)
    run_carry(const int32_t* __restrict__ tile_starts,
              const uint8_t* __restrict__ tile_bits, int64_t tiles,
              uint8_t* __restrict__ tile_carry,
              int64_t* __restrict__ tile_first, int64_t* __restrict__ groups) {
  using MapScan = cub::BlockScan<OpenMap, kCarryThreads>;
  using SumScan = cub::BlockScan<long long, kCarryThreads>;
  __shared__ union {
    typename MapScan::TempStorage map;
    typename SumScan::TempStorage sum;
  } temp;
  const int64_t chunk = (tiles + kCarryThreads - 1) / kCarryThreads;
  const int64_t lo0 = static_cast<int64_t>(threadIdx.x) * chunk;
  const int64_t lo = lo0 < tiles ? lo0 : tiles;
  const int64_t hi = lo + chunk < tiles ? lo + chunk : tiles;
  // this thread's tiles composed, then the composition of all earlier ones
  OpenMap mine{false, true};
  for (int64_t t = lo; t < hi; ++t) {
    mine = ComposeOp()(mine, tile_map(tile_bits[t]));
  }
  OpenMap before;
  MapScan(temp.map).ExclusiveScan(mine, before, OpenMap{false, true},
                                  ComposeOp());
  __syncthreads();
  // walk the chunk: carries and corrected start counts
  bool open = before.a;  // applied to "no live row before row 0"
  long long sum = 0;
  for (int64_t t = lo; t < hi; ++t) {
    const uint8_t bits = tile_bits[t];
    const bool carry = (bits & kContinues) && open;
    const int starts =
        tile_starts[t] - ((carry && (bits & kLeadLive)) ? 1 : 0);
    tile_carry[t] = carry ? 1 : 0;
    tile_first[t] = starts;  // the tile's count until the second walk
    sum += starts;
    const OpenMap f = tile_map(bits);
    open = f.a || (f.b && open);
  }
  long long offset, total;
  SumScan(temp.sum).ExclusiveSum(sum, offset, total);
  for (int64_t t = lo; t < hi; ++t) {
    const int64_t c = tile_first[t];
    tile_first[t] = offset;
    offset += c;
  }
  if (threadIdx.x == 0) groups[0] = total;
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    run_write(const K* __restrict__ key, const uint8_t* __restrict__ mask,
              int64_t n, const uint8_t* __restrict__ tile_carry,
              const int64_t* __restrict__ tile_first,
              uint8_t* __restrict__ start, int64_t* __restrict__ seg) {
  __shared__ typename IntScan::TempStorage temp;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kTile;
  TileScan t;
  scan_tile(key, mask, n, s, temp, t);
  const bool carry = tile_carry[blockIdx.x] != 0;
  int st[kItems], incl[kItems], unused;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    st[j] = (t.local[j] && !(carry && t.seg[j] == 0)) ? 1 : 0;
  }
  IntScan(temp).InclusiveSum(st, incl, unused);
  const int64_t first = tile_first[blockIdx.x];
  const int64_t base = s + static_cast<int64_t>(threadIdx.x) * kItems;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t i = base + j;
    if (i < n) {
      start[i] = static_cast<uint8_t>(st[j]);
      const int64_t id = first + incl[j] - 1;
      seg[i] = id > 0 ? id : 0;
    }
  }
}

template <typename K>
int launch(const void* key, const void* mask, int64_t n, void* start,
           void* seg, void* groups, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    cudaMemsetAsync(groups, 0, sizeof(int64_t), s);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  // scratch layout: int64 first[tiles], int32 starts[tiles], uint8
  // bits[tiles], uint8 carry[tiles]
  auto* first = static_cast<int64_t*>(scratch);
  auto* starts = reinterpret_cast<int32_t*>(first + tiles);
  auto* bits = reinterpret_cast<uint8_t*>(starts + tiles);
  uint8_t* carry = bits + tiles;
  const K* k = static_cast<const K*>(key);
  const auto* m = static_cast<const uint8_t*>(mask);
  run_summary<K><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      k, m, n, starts, bits);
  run_carry<<<1, kCarryThreads, 0, s>>>(starts, bits, tiles, carry, first,
                                        static_cast<int64_t*>(groups));
  run_write<K><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      k, m, n, carry, first, static_cast<uint8_t*>(start),
      static_cast<int64_t*>(seg));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch a launch over n rows needs (the wrapper allocates it).
extern "C" int64_t spark_run_layout_scratch_bytes(int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  return tiles * (8 + 4 + 1 + 1);
}

extern "C" int spark_run_layout_i32(const void* key, const void* mask,
                                    int64_t n, void* start, void* seg,
                                    void* groups, void* scratch,
                                    void* stream) {
  return launch<int32_t>(key, mask, n, start, seg, groups, scratch, stream);
}

extern "C" int spark_run_layout_i64(const void* key, const void* mask,
                                    int64_t n, void* start, void* seg,
                                    void* groups, void* scratch,
                                    void* stream) {
  return launch<int64_t>(key, mask, n, start, seg, groups, scratch, stream);
}
