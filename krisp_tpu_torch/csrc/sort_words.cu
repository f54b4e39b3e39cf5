// Lexicographic sort of multi-word u32 rows: a one-sweep LSD radix sort
// (sm_90a).
//
// Replaces krisp_tpu/ops/pallas_sort.py:bitonic_sort_words (kernels
// _local_sort_kernel, _cross_kernel, _local_merge_kernel).  Input: words
// uint32[V, n], word 0 most significant, one row per column.  Output: the
// rows in ascending unsigned lexicographic order (all-ones sentinel rows
// last).  The TPU network is not stable and need not be: equal rows are
// identical, so any correct sort gives the same bits.  Each pass here is
// stable, as an LSD sort needs.
//
// The bitonic network exists because a TPU has no cheap scatter; Hopper
// does.  Bit b of a row's key is bit b % 32 of word V - 1 - b / 32.
//   1. vary_kernel reads every row once: per word the OR of the rows that
//      are not all ones and the OR of their complements, and whether any
//      row is all ones (a sentinel) and any is not.  The host reads those
//      2V + 1 words back (the call's one readback) and plans the passes
//      (ops/sort.py:varying_masks, sort_pass_plan): digits of at most
//      kMaxBits = 9 bits (512 bins) that cover the bits in which the
//      non-sentinel rows differ, plus, where sentinels are present, the
//      one highest bit that is 0 in all the other rows, which puts every
//      sentinel after them.  A table's sentinel rows thus cost one bit,
//      not every bit of the key: the spacer key (59 varying bits) sorts in
//      7 passes, not the 8 that all 64 bits would take.
//   2. histogram_kernel reads the keys once and counts every pass's digits
//      (shared atomics, up to 6 passes a launch); offsets_kernel turns each
//      pass's counts into the first output row of each bin.
//   3. Each pass is one onesweep_kernel.  A block takes the next tile id
//      from an atomic counter (so every earlier tile is resident or done,
//      and waiting on it cannot deadlock), ranks its 8,192 rows stably by
//      digit (warp match from ballots + per-warp bin counters), publishes
//      its per-bin counts, and finds the rows of each bin in earlier tiles
//      by decoupled look-back over those tiles' status words, one bin a
//      thread.  A status word is 0 (not yet), 1 + the tile's count (bit 31
//      clear), or bit 31 | the inclusive count of the bin up to that tile:
//      one self-contained 32-bit store, so relaxed loads read it.  The rows
//      then leave through shared memory two words at a time: a coalesced
//      read of the tile's words, a write in the tile's sorted order, in
//      runs of equal digits.
// Rows of up to 3 words (key mode) carry all their words through every
// pass: 8V bytes a row and pass, 16 at V = 2 (a design of three kernels a
// pass, upsweep count, bin scan and scatter, moves 20).  Wider rows (index
// mode) sort (word, row id) pairs word by word, digits inside one word,
// 16 bytes a row and pass: the first word's first pass reads that word
// from the input and makes the row ids, and the first word's passes carry
// the second word along (24 bytes a row and pass), which spares that word
// a gather; before each later word's passes gather_word_kernel reads that
// word through the row ids so far, beside them.  The last pass writes its
// word into the output, and gather_rows_kernel gathers every other word;
// each gathered word costs a 32-byte sector a row.
//
// What bounds it on the H100, measured (see PERF.md): not the bytes.  At
// 40.6M x 2 a pass moves 650 MB, 0.19 ms at 3.35 TB/s, and takes about
// 0.5 ms; with its look-back, stores and second read taken out it still
// took 0.35 ms: ranking (one ballot a digit bit a row, so about the same
// total for any digit width) and the tile's bookkeeping.  Wider digits
// save passes but lengthen the look-back walks over 4 x bins status bytes
// a tile and shorten the runs the stores write: 6 passes of 11 bits were
// slower than 8 of 8-9, hence the cap of 9.
// The status words of a pass are reset on the stream before it.  The
// kernel allocates nothing: the caller passes the output and every scratch
// buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // rows per thread per pass
constexpr int kWarpRows = 32 * kItems;        // rows a warp ranks
constexpr int kTile = kThreads * kItems;      // rows per block
constexpr int kMinBlocks = 1024 / kThreads;   // resident blocks an SM holds
constexpr int kRowBits = 13;
constexpr int kMaxBits = 9;
constexpr int kMaxBins = 1 << kMaxBits;
constexpr int kMaxWords = 64;
constexpr int kKeyModeWords = 3;              // wider rows take index mode
constexpr int kHistThreads = 256;
constexpr int kHistItems = 8;                 // rows a thread loads at once
constexpr int kHistBlocks = 1024;             // grid-stride
constexpr int kHistGroup = 6;                 // passes a histogram counts
constexpr int kStatusPad = 32;                // status[0]: the tile counter
constexpr unsigned kInclusive = 0x80000000u;
static_assert(kTile == 1 << kRowBits, "row index bits");
static_assert(kRowBits + kMaxBits <= 32, "map word");
static_assert(kMaxBins == kThreads, "one bin a thread");
static_assert(kWarpRows < 65536, "16-bit warp counters");

// Where a pass's digit lies: bits [shift, shift + width) of the 64-bit
// value hi:lo of words w_hi:w_lo (w_hi < 0: the digit is inside w_lo).
struct Digit {
  int w_lo, w_hi, shift;
  unsigned mask;
};

__host__ __device__ inline Digit make_digit(int V, int lo, int width) {
  Digit g;
  g.w_lo = V - 1 - lo / 32;
  g.shift = lo % 32;
  g.w_hi = g.shift + width > 32 ? g.w_lo - 1 : -1;
  g.mask = (1u << width) - 1u;
  return g;
}

// The rows a pass reads and writes, one pointer a word (at most
// kKeyModeWords): in key mode the words of the table, in index mode the
// word being sorted, perhaps a word carried along, and the row ids.
struct Rows {
  const uint32_t* src[kKeyModeWords];
  uint32_t* dst[kKeyModeWords];
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ bool is_leader(unsigned peers) {
  return (int)(__ffs(peers) - 1) == (int)(threadIdx.x & 31);
}

// Status words carry their whole meaning in one 32-bit value and publish
// nothing else, so relaxed device-scope accesses suffice (on the H100 they
// beat acquire/release ones); "volatile" keeps the spinning reads from
// being hoisted.
__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

// The lanes of the warp that are ``in`` and hold the same digit ``d`` of
// ``width`` bits (garbage for lanes that are not in).  One ballot per digit
// bit: on the H100 this beat the hardware __match_any_sync.
__device__ __forceinline__ unsigned match_digit(unsigned d, bool in,
                                                int width) {
  unsigned peers = __ballot_sync(0xffffffffu, in);
  for (int b = 0; b < width; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// Exclusive prefix sum of one value per thread in thread order; every
// thread of the block must call it.  *total receives the block's sum.
__device__ unsigned block_exclusive_sum(unsigned v, unsigned* s_warp,
                                        unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  unsigned incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned t = lane < n_warps ? s_warp[lane] : 0u;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    s_warp[lane] = t;
  }
  __syncthreads();
  const unsigned before = warp > 0 ? s_warp[warp - 1] : 0u;
  *total = s_warp[n_warps - 1];
  __syncthreads();
  return before + incl - v;
}

// Over the rows that are not all ones: acc[v] |= word v, acc[V + v] |=
// ~word v; acc[2V] |= 1 if a row is all ones, 2 if a row is not.  A
// thread first reads its kRows rows' V words to tell sentinels apart, then
// again to fold them; kRows * V <= 16 keeps a block's rows (16 KB) in L1
// for the second read.  Grid-stride; acc zeroed by the caller.
template <int kRows>
__global__ void __launch_bounds__(kHistThreads)
vary_kernel(const uint32_t* __restrict__ words, long long n, int V,
            unsigned* __restrict__ acc) {
  __shared__ unsigned s_acc[2 * kMaxWords + 1];
  for (int j = threadIdx.x; j < 2 * V + 1; j += kHistThreads) s_acc[j] = 0;
  __syncthreads();
  unsigned flags = 0;
  const long long step = (long long)gridDim.x * kHistThreads * kRows;
  for (long long base = (long long)blockIdx.x * kHistThreads * kRows;
       base < n; base += step) {   // uniform over the block
    bool sent[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) sent[k] = true;
    for (int v = 0; v < V; ++v) {
      uint32_t x[kRows];   // all loads in flight before any use
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const long long i = base + k * kHistThreads + threadIdx.x;
        x[k] = i < n ? words[(long long)v * n + i] : ~0u;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) sent[k] = sent[k] && x[k] == ~0u;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (base + k * kHistThreads + threadIdx.x < n) flags |= sent[k] ? 1 : 2;
    for (int v = 0; v < V; ++v) {
      unsigned ones = 0, zeros = 0;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const long long i = base + k * kHistThreads + threadIdx.x;
        if (!sent[k]) {   // rows past n count as sentinels
          const uint32_t x = words[(long long)v * n + i];
          ones |= x;
          zeros |= ~x;
        }
      }
      ones = __reduce_or_sync(0xffffffffu, ones);
      zeros = __reduce_or_sync(0xffffffffu, zeros);
      if ((threadIdx.x & 31) == 0) {
        if (ones) atomicOr(&s_acc[v], ones);
        if (zeros) atomicOr(&s_acc[V + v], zeros);
      }
    }
  }
  flags = __reduce_or_sync(0xffffffffu, flags);
  if ((threadIdx.x & 31) == 0 && flags) atomicOr(&s_acc[2 * V], flags);
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * V + 1; j += kHistThreads)
    if (s_acc[j]) atomicOr(&acc[j], s_acc[j]);
}

// Up to kHistGroup passes' digits, counted in one read of the rows.
struct PassGroup {
  int count, first;
  int word;   // index mode: the one word holding the group's digits
  int lo[kHistGroup], width[kHistGroup];
};

// Every group of a call, counted by one launch (3.8 KB of parameters).
struct PassGroups {
  PassGroup g[kMaxWords];
};

// hist[(g.first + p) * kMaxBins + bin] counts the rows whose digit of pass
// g.first + p is bin, for the group g = groups.g[blockIdx.y].
__global__ void __launch_bounds__(kHistThreads)
histogram_kernel(const uint32_t* __restrict__ words, long long n, int V,
                 const __grid_constant__ PassGroups groups,
                 unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[kHistGroup * kMaxBins];
  const PassGroup& g = groups.g[blockIdx.y];
  for (int j = threadIdx.x; j < g.count * kMaxBins; j += kHistThreads)
    s_hist[j] = 0;
  __syncthreads();
  Digit d[kHistGroup];
#pragma unroll
  for (int p = 0; p < kHistGroup; ++p)
    d[p] = make_digit(V, p < g.count ? g.lo[p] : 0,
                      p < g.count ? g.width[p] : 1);
  const long long step = (long long)gridDim.x * kHistThreads * kHistItems;
  if (V <= kKeyModeWords) {   // the whole key in registers, read once:
    // a digit of at most 9 bits lies in bits [0, 64) or in [32, 96)
    for (long long base = (long long)blockIdx.x * kHistThreads * kHistItems;
         base < n; base += step) {
      uint64_t lo64[kHistItems], hi64[kHistItems];
#pragma unroll
      for (int k = 0; k < kHistItems; ++k) {
        const long long i = base + k * kHistThreads + threadIdx.x;
        const bool in = i < n;
        const uint64_t w2 = in ? words[(V - 1) * n + i] : 0u;
        const uint64_t w1 = in && V >= 2 ? words[(V - 2) * n + i] : 0u;
        const uint64_t w0 = in && V >= 3 ? words[(V - 3) * n + i] : 0u;
        lo64[k] = w1 << 32 | w2;
        hi64[k] = w0 << 32 | w1;
      }
#pragma unroll
      for (int p = 0; p < kHistGroup; ++p) {
        if (p >= g.count) break;
        const bool high = g.lo[p] + g.width[p] > 64;
        const int shift = high ? g.lo[p] - 32 : g.lo[p];
#pragma unroll
        for (int k = 0; k < kHistItems; ++k)
          if (base + k * kHistThreads + threadIdx.x < n)
            atomicAdd(&s_hist[p * kMaxBins +
                              ((unsigned)((high ? hi64[k] : lo64[k]) >>
                                          shift) & d[p].mask)],
                      1u);
      }
    }
  }
  if (V > kKeyModeWords) {   // index mode: one word a row, read once
    const uint32_t* w = words + (long long)g.word * n;
    for (long long base = (long long)blockIdx.x * kHistThreads * kHistItems;
         base < n; base += step) {
      uint32_t x[kHistItems];
#pragma unroll
      for (int k = 0; k < kHistItems; ++k) {
        const long long i = base + k * kHistThreads + threadIdx.x;
        x[k] = i < n ? w[i] : 0u;
      }
#pragma unroll
      for (int p = 0; p < kHistGroup; ++p) {
        if (p >= g.count) break;
#pragma unroll
        for (int k = 0; k < kHistItems; ++k)
          if (base + k * kHistThreads + threadIdx.x < n)
            atomicAdd(&s_hist[p * kMaxBins +
                              ((x[k] >> (g.lo[p] % 32)) & d[p].mask)],
                      1u);
      }
    }
  }
  __syncthreads();
  unsigned* out = hist + (long long)g.first * kMaxBins;
  for (int j = threadIdx.x; j < g.count * kMaxBins; j += kHistThreads)
    if (s_hist[j]) atomicAdd(&out[j], s_hist[j]);
}

// One block per pass, one bin a thread: its counts become each bin's first
// output row.
__global__ void __launch_bounds__(kThreads)
offsets_kernel(unsigned* __restrict__ hist) {
  __shared__ unsigned s_warp[32];
  unsigned* h = hist + (long long)blockIdx.x * kMaxBins;
  unsigned total;
  h[threadIdx.x] = block_exclusive_sum(h[threadIdx.x], s_warp, &total);
}

// Dynamic shared memory of a pass with ``bins`` bins: s_map[kTile] |
// s_bin_start[bins] | s_gadj[bins] | (s_wcnt u16[kWarps][bins], later
// s_buf[2][kTile]).
size_t pass_smem(int bins) {
  const size_t wcnt = (size_t)kWarps * bins * sizeof(unsigned short);
  const size_t buf = (size_t)2 * kTile * sizeof(uint32_t);
  return (size_t)kTile * sizeof(unsigned) + 2 * (size_t)bins * sizeof(unsigned)
         + (wcnt > buf ? wcnt : buf);
}

// One stable LSD pass over digit bits [lo, lo + width) of the V words of
// rows.src, into rows.dst.  offsets: the pass's first output row of each
// bin; status: the tile counter, then one status word per (tile, bin), all
// zero at launch.  Word iota_row (if >= 0; index mode's first pass, the
// row ids) is not read but is each row's index.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
onesweep_kernel(const __grid_constant__ Rows rows, long long n, int V,
                int lo, int width, int iota_row,
                const unsigned* __restrict__ offsets,
                unsigned* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_warp[32];
  __shared__ unsigned s_tile;
  const int bins = 1 << width;
  unsigned* s_map = (unsigned*)smem;
  unsigned* s_bin_start = s_map + kTile;
  unsigned* s_gadj = s_bin_start + bins;
  unsigned short* s_wcnt = (unsigned short*)(s_gadj + bins);
  uint32_t* s_buf = (uint32_t*)(s_gadj + bins);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(status, 1u);
  for (int j = threadIdx.x; j < kWarps * bins / 2; j += kThreads)
    ((unsigned*)s_wcnt)[j] = 0u;
  __syncthreads();
  const long long tile = s_tile;
  const long long start = tile * kTile;
  const int valid = (int)(n - start < kTile ? n - start : kTile);
  const Digit g = make_digit(V, lo, width);
  unsigned* tstat = status + kStatusPad;

  // 1. the digits, all loads in flight at once
  const uint32_t* __restrict__ d_lo = rows.src[g.w_lo] + start;
  const uint32_t* __restrict__ d_hi = g.w_hi >= 0 ? rows.src[g.w_hi] + start
                                                  : nullptr;
  unsigned dr[kItems];   // the digit, then digit << 16 | rank
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = warp * kWarpRows + k * 32 + lane;
    uint64_t x = r < valid ? d_lo[r] : 0u;
    if (d_hi != nullptr && r < valid) x |= (uint64_t)d_hi[r] << 32;
    dr[k] = (unsigned)(x >> g.shift) & g.mask;
  }

  // 2. rank each row among the rows of its warp with its digit, in order
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = warp * kWarpRows + k * 32 + lane;
    const bool in = r < valid;
    const unsigned d = dr[k];
    const unsigned peers = match_digit(d, in, width);
    unsigned short* cnt = s_wcnt + warp * bins + d;
    const unsigned base = in ? *cnt : 0u;
    __syncwarp();
    if (in && is_leader(peers)) *cnt = (unsigned short)(base + __popc(peers));
    __syncwarp();
    dr[k] = d << 16 | (base + __popc(peers & lt));
  }
  __syncthreads();
  //    thread b takes bin b: the warps' counts become exclusive sums over
  //    the warps (all loads first: one shared-memory latency, not kWarps),
  //    and the tile's count is published (tile 0 publishes its inclusive
  //    count: no tile precedes it)
  const int b = threadIdx.x;
  const bool has_bin = b < bins;
  unsigned count = 0;
  if (has_bin) {
    unsigned c[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c[w] = s_wcnt[w * bins + b];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s_wcnt[w * bins + b] = (unsigned short)count;
      count += c[w];
    }
    st_relaxed(&tstat[tile * bins + b], tile == 0 ? (kInclusive | count)
                                                  : 1u + count);
  }

  // 3. each bin's first row in the tile's sorted order
  unsigned total;
  const unsigned bin_start = block_exclusive_sum(count, s_warp, &total);
  if (has_bin) s_bin_start[b] = bin_start;

  // 4. decoupled look-back: the rows of bin b in earlier tiles; the walk
  //    ends at the first tile with an inclusive count
  if (has_bin) {
    unsigned prefix = 0;
    for (long long t = tile - 1; t >= 0;) {
      const unsigned st = ld_relaxed(&tstat[t * bins + b]);
      if (st == 0u) continue;                  // not published yet: again
      if (st & kInclusive) {
        prefix += st & ~kInclusive;
        break;
      }
      prefix += st - 1u;
      --t;
    }
    if (tile > 0)
      st_relaxed(&tstat[tile * bins + b], kInclusive | (prefix + count));
    // output row of the tile's sorted row j with digit b: s_gadj[b] + j
    // (mod 2**32; the sum is below 2**31)
    s_gadj[b] = offsets[b] + prefix - bin_start;
  }
  __syncthreads();

  // 5. each row's place in the tile's sorted order
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = warp * kWarpRows + k * 32 + lane;
    if (r < valid) {
      const unsigned d = dr[k] >> 16;
      const unsigned lp = s_bin_start[d] + s_wcnt[warp * bins + d]
                          + (dr[k] & 0xffffu);
      s_map[lp] = d << kRowBits | (unsigned)r;
    }
  }
  __syncthreads();

  // 6. the words through shared memory, two at a time (s_buf reuses
  //    s_wcnt's space): every load of a thread in flight before its first
  //    store, then writes in the tile's sorted order
  for (int w0 = 0; w0 < V; w0 += 2) {
    const int nw = V - w0 < 2 ? V - w0 : 2;
    uint32_t x[2][kItems];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint32_t* sw = q < nw ? rows.src[w0 + q] + start : nullptr;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int j = k * kThreads + threadIdx.x;
        x[q][k] = q >= nw || j >= valid ? 0u
                  : w0 + q == iota_row ? (uint32_t)(start + j) : sw[j];
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int j = k * kThreads + threadIdx.x;
        if (q < nw && j < valid) s_buf[q * kTile + j] = x[q][k];
      }
    __syncthreads();
    for (int q = 0; q < nw; ++q) {
      uint32_t* dw = rows.dst[w0 + q];
      const uint32_t* sb = s_buf + q * kTile;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int j = k * kThreads + threadIdx.x;
        if (j < valid) {
          const unsigned m = s_map[j];
          dw[s_gadj[m >> kRowBits] + (unsigned)j] = sb[m & (kTile - 1)];
        }
      }
    }
    __syncthreads();
  }
}

// word[i] = word w of row ids[i], in place beside the row ids.
// Grid-stride, kHistItems rows a thread at once.
__global__ void __launch_bounds__(kHistThreads)
gather_word_kernel(const uint32_t* __restrict__ src, long long n, int w,
                   const uint32_t* ids, uint32_t* word) {
  const uint32_t* sw = src + (long long)w * n;
  const long long step = (long long)gridDim.x * kHistThreads * kHistItems;
  for (long long base = (long long)blockIdx.x * kHistThreads * kHistItems;
       base < n; base += step) {
    uint32_t r[kHistItems], x[kHistItems];
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const long long i = base + k * kHistThreads + threadIdx.x;
      r[k] = i < n ? ids[i] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kHistItems; ++k)
      x[k] = base + k * kHistThreads + threadIdx.x < n ? sw[r[k]] : 0u;
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const long long i = base + k * kHistThreads + threadIdx.x;
      if (i < n) word[i] = x[k];
    }
  }
}

// dst[v][i] = src[v][ids[i]] for word v = blockIdx.y, except word skip.
__global__ void __launch_bounds__(kHistThreads)
gather_rows_kernel(const uint32_t* __restrict__ src, long long n,
                   const uint32_t* __restrict__ ids, int skip,
                   uint32_t* __restrict__ dst) {
  if ((int)blockIdx.y == skip) return;
  const long long off = (long long)blockIdx.y * n;
  const long long step = (long long)gridDim.x * kHistThreads * kHistItems;
  for (long long base = (long long)blockIdx.x * kHistThreads * kHistItems;
       base < n; base += step) {
    uint32_t r[kHistItems];
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const long long i = base + k * kHistThreads + threadIdx.x;
      r[k] = i < n ? ids[i] : 0u;
    }
    uint32_t x[kHistItems];
#pragma unroll
    for (int k = 0; k < kHistItems; ++k)
      x[k] = base + k * kHistThreads + threadIdx.x < n ? src[off + r[k]] : 0u;
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const long long i = base + k * kHistThreads + threadIdx.x;
      if (i < n) dst[off + i] = x[k];
    }
  }
}

long long n_tiles(long long n) { return (n + kTile - 1) / kTile; }

template <int kRows>
void launch_vary(const void* in, long long n, int V, void* acc,
                 cudaStream_t s) {
  const long long b = (n + kHistThreads * kRows - 1) / (kHistThreads * kRows);
  vary_kernel<kRows><<<(unsigned)(b < kHistBlocks ? b : kHistBlocks),
                       kHistThreads, 0, s>>>((const uint32_t*)in, n, V,
                                             (unsigned*)acc);
}

}  // namespace

extern "C" int krisp_sort_words_block_rows() { return kTile; }
extern "C" int krisp_sort_words_max_words() { return kMaxWords; }
extern "C" int krisp_sort_words_max_bits() { return kMaxBits; }
extern "C" int krisp_sort_words_key_mode_words() { return kKeyModeWords; }

// Status words a call on n rows needs.
extern "C" long long krisp_sort_words_status_words(long long n) {
  return kStatusPad + n_tiles(n) * kMaxBins;
}

// What varies in ``in`` (uint32[V, n], n >= 1), into the device buffer
// ``acc`` (uint32[2V + 1]) on ``stream``: over the rows that are not all
// ones, per word the OR of the words, then per word the OR of their
// complements; last, bit 0 set if a row is all ones and bit 1 if a row is
// not.
extern "C" int krisp_sort_words_vary(int device, void* stream, const void* in,
                                     int V, long long n, void* acc) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (V < 1 || V > kMaxWords || n < 1 || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(acc, 0, (size_t)(2 * V + 1) * sizeof(unsigned),
                             s)) != cudaSuccess)
    return (int)err;
  if (V <= 2) launch_vary<8>(in, n, V, acc, s);
  else if (V <= 4) launch_vary<4>(in, n, V, acc, s);
  else if (V <= 8) launch_vary<2>(in, n, V, acc, s);
  else launch_vary<1>(in, n, V, acc, s);
  return (int)cudaGetLastError();
}

// Sorts ``in`` (uint32[V, n]) into ``out`` on ``stream`` by the passes of
// ``plan`` (host int32[2 * n_passes]: (lo, width) per pass, least
// significant first, 1 <= width <= kMaxBits, lo + width <= 32 V, and in
// index mode each digit inside one word); no passes copies.  Scratch from
// the caller: ``scratch`` uint32[V * n] in key mode, else uint32[6 * n],
// ``hist`` uint32[n_passes * 512], ``status`` uint32[status_words(n)],
// all on the device.  Queues everything and returns the
// first cudaError_t.
extern "C" int krisp_sort_words(int device, void* stream, const void* in,
                                int V, long long n, const int* plan,
                                int n_passes, void* out, void* scratch,
                                void* hist, void* status) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (V < 1 || V > kMaxWords || n < 0 || n >= (1LL << 31) || n_passes < 0)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < n_passes; ++p) {
    const int lo = plan[2 * p], width = plan[2 * p + 1];
    if (width < 1 || width > kMaxBits || lo < 0 || lo + width > 32 * V ||
        (V > kKeyModeWords && lo / 32 != (lo + width - 1) / 32) ||
        (p > 0 && lo < plan[2 * p - 2] + plan[2 * p - 1]))
      return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)in;
  uint32_t* dst = (uint32_t*)out;
  if (n_passes == 0)
    return (int)cudaMemcpyAsync(dst, src, (size_t)V * n * sizeof(uint32_t),
                                cudaMemcpyDeviceToDevice, s);

  unsigned* h = (unsigned*)hist;
  if ((err = cudaMemsetAsync(h, 0, (size_t)n_passes * kMaxBins *
                                       sizeof(unsigned), s)) != cudaSuccess)
    return (int)err;
  const long long hb = (n + kHistThreads * kHistItems - 1) /
                       (kHistThreads * kHistItems);
  // groups of passes, each counted in one read of the rows: at most
  // kHistGroup passes, and in index mode the passes of one word together,
  // so that each row's word is read once; all groups in one launch
  auto word_of = [&](int p) {
    const int lo = plan[2 * p], hi = lo + plan[2 * p + 1] - 1;
    return lo / 32 == hi / 32 ? V - 1 - lo / 32 : -1;
  };
  PassGroups groups{};
  int n_groups = 0;
  for (int p0 = 0; p0 < n_passes; ++n_groups) {
    if (n_groups == kMaxWords) return (int)cudaErrorInvalidValue;
    PassGroup& g = groups.g[n_groups];
    g.first = p0;
    g.word = word_of(p0);
    while (g.count < kHistGroup && p0 + g.count < n_passes &&
           (V <= kKeyModeWords || word_of(p0 + g.count) == g.word)) {
      g.lo[g.count] = plan[2 * (p0 + g.count)];
      g.width[g.count] = plan[2 * (p0 + g.count) + 1];
      ++g.count;
    }
    p0 += g.count;
  }
  histogram_kernel<<<dim3((unsigned)(hb < kHistBlocks ? hb : kHistBlocks),
                          n_groups),
                     kHistThreads, 0, s>>>(src, n, V, groups, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  offsets_kernel<<<n_passes, kThreads, 0, s>>>(h);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = cudaFuncSetAttribute(onesweep_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)pass_smem(kMaxBins))) != cudaSuccess)
    return (int)err;
  const long long tiles = n_tiles(n);
  auto pass = [&](int p, const Rows& rows, int Vp, int lo, int iota_row) {
    const int width = plan[2 * p + 1];
    const size_t words = kStatusPad + (size_t)tiles * (1u << width);
    cudaError_t e = cudaMemsetAsync(status, 0, words * sizeof(unsigned), s);
    if (e != cudaSuccess) return e;
    onesweep_kernel<<<(unsigned)tiles, kThreads, pass_smem(1 << width), s>>>(
        rows, n, Vp, lo, width, iota_row, h + (long long)p * kMaxBins,
        (unsigned*)status);
    return cudaGetLastError();
  };

  if (V <= kKeyModeWords) {
    // key mode: ping-pong between out and scratch so that the last pass
    // lands in out
    uint32_t* tmp = (uint32_t*)scratch;
    const uint32_t* cur = src;
    for (int p = 0; p < n_passes; ++p) {
      uint32_t* next = (n_passes - 1 - p) % 2 == 0 ? dst : tmp;
      Rows rows{};
      for (int v = 0; v < V; ++v) {
        rows.src[v] = cur + (long long)v * n;
        rows.dst[v] = next + (long long)v * n;
      }
      if ((err = pass(p, rows, V, plan[2 * p], -1)) != cudaSuccess)
        return (int)err;
      cur = next;
    }
    return (int)cudaSuccess;
  }

  // index mode, word by word from the least significant: the word's
  // passes sort (word, row id) pairs.  The first word's first pass reads
  // the word from the input and makes the row ids, and the first word's
  // passes carry the second word along, so that it needs no gather; each
  // later word is gathered through the row ids so far, beside them.  The
  // last pass writes its word into the output, and then every other word
  // is gathered once.
  uint32_t* buf[2] = {(uint32_t*)scratch, (uint32_t*)scratch + 3 * n};
  int nb = 0;                           // the buffer the next pass writes
  const uint32_t* word = nullptr;       // the word being sorted, in order
  const uint32_t* carried = nullptr;    // the second word, in that order
  const uint32_t* ids = nullptr;        // the row ids of that order
  const long long gb = (n + kHistThreads * kHistItems - 1) /
                       (kHistThreads * kHistItems);
  const unsigned gblocks = (unsigned)(gb < kHistBlocks ? gb : kHistBlocks);
  auto word_at = [&](int p) { return V - 1 - plan[2 * p] / 32; };
  int w_last = -1;
  for (int p = 0, k = 0; p < n_passes; ++k) {
    const int w = word_at(p);
    int p_end = p;
    while (p_end < n_passes && word_at(p_end) == w) ++p_end;
    const int w_next = p_end < n_passes ? word_at(p_end) : -1;
    if (k == 0) {
      word = src + (long long)w * n;
      carried = w_next >= 0 ? src + (long long)w_next * n : nullptr;
    } else if (k == 1) {
      word = carried;
    } else {
      uint32_t* row = buf[nb ^ 1];      // beside ids, in place of a
      gather_word_kernel<<<gblocks, kHistThreads, 0, s>>>(src, n, w, ids,
                                                          row);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      word = row;
    }
    const bool carry = k == 0 && carried != nullptr;
    const int Vp = carry ? 3 : 2;
    for (; p < p_end; ++p) {
      uint32_t* o = buf[nb];
      nb ^= 1;
      Rows rows{};
      rows.src[0] = word;
      rows.src[Vp - 1] = ids;           // null on the first pass: iota
      rows.dst[0] = p == n_passes - 1 ? dst + (long long)w * n : o;
      rows.dst[Vp - 1] = o + (long long)(Vp - 1) * n;
      if (carry) {
        rows.src[1] = carried;
        rows.dst[1] = o + n;
      }
      if ((err = pass(p, rows, Vp, 32 * (Vp - 1) + plan[2 * p] % 32,
                      ids == nullptr ? Vp - 1 : -1)) != cudaSuccess)
        return (int)err;
      word = o;
      ids = o + (long long)(Vp - 1) * n;
      if (carry) carried = o + n;
    }
    w_last = w;
  }
  gather_rows_kernel<<<dim3(gblocks, V), kHistThreads, 0, s>>>(
      src, n, ids, w_last, dst);
  return (int)cudaGetLastError();
}
