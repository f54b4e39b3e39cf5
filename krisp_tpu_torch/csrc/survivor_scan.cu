// Survivor scan over a sorted KeyLayout table (sm_90a).
//
// Replaces krisp_tpu/ops/pallas_scan.py:pallas_survivor_scan (kernels
// _forward_kernel and _reverse_kernel).  Input: key words uint32[W, n],
// sorted ascending as unsigned tuples, and either valid uint8[n] (array
// mode) or the genome-id field's word, shift and sentinel (layout mode:
// a row is valid where its field is not the sentinel).  Per row i:
//   head_full / head_ff / head_flank: row i starts a run of equal keys,
//       compared on the whole key / its leading ff_bits / its leading
//       flank_bits (row 0 is a head of all three);
//   x = head_ff & valid;  the flank group of i is [h, t], h its head, t
//       the row before the next flank head (or n - 1);
// Output: keep[i] = head_full & valid & (sum of x over [h, t] == n_files),
//         counts[i] = head_full & valid ? (next full head after i, or n) - i
//                                       : 0,
//         gid[i] = (flank heads in rows 0..i) - 1.
// This is krisp_tpu/ops/intersect.py:survivor_mark_bits (unweighted).  The
// TPU kernel forms c = prefix sum of x, base = running max of c at group
// heads and endc = suffix min of c at group tails; as c never decreases,
// endc - base is the sum of x over the row's own group, which is what a
// tile here adds up, and only gid is a prefix over the whole table.
//
// What bounds it on the H100: memory.  Each row's key is read once (4
// bytes a 32-bit word: 8 bytes at the spacer path's W = 2), valid in array
// mode (1 byte), and keep, counts and gid are written once (9 bytes): 4W +
// 9 bytes a row in layout mode, 4W + 10 with an array; at 40.6M rows x 2
// words that is 690 MB, 0.206 ms at 3.35 TB/s.  The design before this one
// moved about 21 bytes a row (a flag byte written and read back twice) in
// four launches, one of them a single block that carried the tiles' sums
// through the whole table.  This design:
//   scan_kernel: a block takes the next tile id from an atomic counter
//      (every earlier tile is then resident or done, so waiting on one
//      cannot deadlock) and kTile rows.  It copies two key planes at a
//      time into shared memory with 16-byte cp.async (the row before the
//      tile and kAhead rows past it included) and forms the head flags and
//      validity of its rows in registers: a ballot a 32-row word turns
//      them into bitmaps (flank heads, x, full heads, valid full heads).
//      No flag array reaches device memory.  A ninth, control warp scans
//      the 136 bitmap words (popcounts, last head before and next head
//      after each word, the x count below those heads) and publishes the
//      tile's pair (flank heads, sum of x after its last flank head).  It
//      then finds the same pair over all earlier tiles by decoupled
//      look-back (gid's carry, and the sum of x of the group the tile
//      starts inside) while the 8 row warps form their rows' outputs from
//      the bitmaps and the arrays of each row's own word (clz/ffs within
//      the word): four rows a thread, counts stored at once, gid and keep
//      once the carry is known, with 16-byte (counts, gid) and 4-byte
//      (keep) stores and no staging buffer, so no bank conflicts.  The look-ahead rows close the
//      tile's last group and run; rows past n count as heads, which closes
//      both at n.  They are kAhead / kTile = 1/16 more key reads, most of
//      them hits in L2, where the next tile reads them.
//   patch_kernel: a group still open at the end of the look-ahead is rare
//      in genomes, but makes the whole of a table of long runs.  For it
//      scan_kernel writes keep = 0 and a provisional count, and each tile
//      publishes (has a flank head, sum of x before its first flank head,
//      its first full head).  patch_kernel walks the tiles from the last,
//      one warp of a block per tile, and finds the same triple over all
//      later tiles by a look-back that stops at the first tile with a head
//      or one already combined: a tile with a flank head needs no walk,
//      and publishes nothing.  An open tile then has its group's exact sum
//      and the end of its last run, and rewrites only the rows of that
//      group.  Its blocks of closed tiles with a head return at once.
// Measured on an H100 SXM at 700 W (PERF.md, tools/scan_variants.py):
// 0.39-0.41 ms of busy time at 40.6M x 2 in layout mode, about half the
// bytes' bound.  Not the bytes but each tile's chain of steps bounds it:
// scan_kernel took 0.386 ms, and 0.331 with the look-back taken out,
// 0.333 without the stores, 0.335 without the rows' outputs, 0.352
// without the key copies, 0.371 without the ticket.  kMinBlocks caps the
// registers so that five blocks share an SM.
// The status words are 0 until written and are read and written whole
// with relaxed device-scope accesses.  The kernels allocate nothing: the
// caller passes the output and the scratch (ticket, status words, one
// 16-byte record a tile), which the entry point resets on the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowWarps = 8;                  // warps that own rows
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kThreads = kRowThreads + 32;    // and one control warp
constexpr int kTile = 4096;                   // rows a block writes
constexpr int kAhead = 256;                   // rows it reads past them
constexpr int kSpan = kTile + kAhead;         // rows whose flags it forms
constexpr int kMapWords = kSpan / 32;         // bitmap words a block
constexpr int kTileWords = kTile / 32;
constexpr int kWarpWords = kMapWords / kRowWarps;   // bitmap words a warp
constexpr int kLaneWords = (kMapWords + 31) / 32;   // in the word scans
constexpr int kBuf = kSpan + 8;               // a plane: row before, alignment
constexpr int kPlanes = 2;                    // key planes loaded at once
constexpr int kRowsPerThread = kTile / kRowThreads;
constexpr int kMinBlocks = 5;                 // resident blocks an SM holds
constexpr int kPatchThreads = 128;
constexpr int POS = 2147483647;
static_assert(kSpan % 32 == 0 && kMapWords % kRowWarps == 0, "bitmap words");
static_assert(kWarpWords <= 32, "a thread's rows fit one mask");
static_assert(kRowsPerThread % 4 == 0, "four rows a store");

// Forward status word: bits 62-63 kind (1: the tile's own pair, 2: the
// pair over tiles 0..b), bits 31-61 flank heads, bits 0-30 the sum of x
// after the last flank head (of all the rows, if there is none).
constexpr unsigned long long kOwn = 1ull << 62, kInclusive = 2ull << 62;
constexpr unsigned long long kField = 0x7fffffffull;

struct Fwd { int heads, sum; };

__device__ __forceinline__ Fwd fwd_combine(Fwd earlier, Fwd later) {
  return {earlier.heads + later.heads,
          later.heads ? later.sum : earlier.sum + later.sum};
}

__device__ __forceinline__ unsigned long long fwd_pack(unsigned long long kind,
                                                       Fwd v) {
  return kind | (unsigned long long)v.heads << 31 | (unsigned long long)v.sum;
}

__device__ __forceinline__ Fwd fwd_unpack(unsigned long long w) {
  return {(int)((w >> 31) & kField), (int)(w & kField)};
}

// Reverse status word: bit 63 set once the triple covers every tile from
// b to the end, bit 62 the tile has a flank head, bits 31-61 the sum of x
// before its first flank head (all its rows, if none), bits 0-30 its
// first full head + 1 (n + 1 if none): never 0 once written.
constexpr unsigned long long kDone = 1ull << 63, kHasHead = 1ull << 62;

struct Rev { bool head; int sum, first; };

__device__ __forceinline__ Rev rev_combine(Rev near, Rev far) {
  // a first full head in a nearer tile precedes any farther one, and
  // "none" is n, above every row
  return {near.head || far.head, near.head ? near.sum : near.sum + far.sum,
          min(near.first, far.first)};
}

__device__ __forceinline__ unsigned long long rev_pack(bool done, Rev v) {
  return (done ? kDone : 0ull) | (v.head ? kHasHead : 0ull)
         | (unsigned long long)v.sum << 31 | (unsigned long long)(v.first + 1);
}

__device__ __forceinline__ Rev rev_unpack(unsigned long long w) {
  return {(w & kHasHead) != 0, (int)((w >> 31) & kField),
          (int)(w & kField) - 1};
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// 16 bytes from global to shared memory, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ uint32_t prefix_mask(int w, int n_bits) {
  const int full = n_bits >> 5, rem = n_bits & 31;
  if (w < full) return 0xffffffffu;
  if (w == full && rem) return 0xffffffffu << (32 - rem);
  return 0u;
}

// Inclusive scans of one value a lane across the warp.
__device__ __forceinline__ int warp_sum(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

__device__ __forceinline__ int warp_max(int v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, y);
  }
  return v;
}

__device__ __forceinline__ int warp_rmin(int v, int lane) {   // from lane 31
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, v, d);
    if (lane + d < 32) v = min(v, y);
  }
  return v;
}

// The pair over tiles 0..b-1, for one warp.  Lane l reads tile t0 - l; the
// window is combined from its farthest tile to its nearest up to the
// nearest inclusive word, and the walk goes on 32 tiles back otherwise.
__device__ Fwd lookback_fwd(const unsigned long long* fwd, int b, int lane) {
  Fwd acc = {0, 0};
  for (int t0 = b - 1; t0 >= 0; t0 -= 32) {
    const int t = t0 - lane;
    unsigned long long w = kInclusive;          // before tile 0: (0, 0)
    if (t >= 0) {
      do { w = ld_relaxed(fwd + t); } while (w == 0);
    }
    const unsigned stop = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    const int last = stop ? __ffs(stop) - 1 : 31;
    Fwd x = lane <= last ? fwd_unpack(w) : Fwd{0, 0};
    for (int d = 1; d < 32; d <<= 1) {
      const Fwd y = {__shfl_down_sync(0xffffffffu, x.heads, d),
                     __shfl_down_sync(0xffffffffu, x.sum, d)};
      if (lane + d < 32) x = fwd_combine(y, x);  // y lies earlier
    }
    x = {__shfl_sync(0xffffffffu, x.heads, 0),
         __shfl_sync(0xffffffffu, x.sum, 0)};
    acc = fwd_combine(x, acc);
    if (stop) break;
  }
  return acc;
}

// The triple over tiles b+1..nb-1, for one warp.  Every word was written
// by scan_kernel, so nothing waits; the walk stops at a tile with a flank
// head or one whose word already covers the rest.
__device__ Rev lookback_rev(const unsigned long long* rev, int b, int nb,
                            int n, int lane) {
  Rev acc = {false, 0, n};
  for (int t0 = b + 1; t0 < nb; t0 += 32) {
    const int t = t0 + lane;
    const unsigned long long w =
        t < nb ? ld_relaxed(rev + t) : kDone | (unsigned long long)(n + 1);
    const unsigned stop =
        __ballot_sync(0xffffffffu, (w & (kDone | kHasHead)) != 0);
    const int last = stop ? __ffs(stop) - 1 : 31;
    Rev x = lane <= last ? rev_unpack(w) : Rev{false, 0, n};
    for (int d = 1; d < 32; d <<= 1) {
      const Rev y = {__shfl_down_sync(0xffffffffu, (int)x.head, d) != 0,
                     __shfl_down_sync(0xffffffffu, x.sum, d),
                     __shfl_down_sync(0xffffffffu, x.first, d)};
      if (lane + d < 32) x = rev_combine(x, y);  // y lies farther
    }
    x = {__shfl_sync(0xffffffffu, (int)x.head, 0) != 0,
         __shfl_sync(0xffffffffu, x.sum, 0),
         __shfl_sync(0xffffffffu, x.first, 0)};
    acc = rev_combine(acc, x);
    if (stop) break;
  }
  return acc;
}

struct Maps {
  uint32_t head[kMapWords];    // flank heads
  uint32_t x[kMapWords];       // head_ff & valid
  uint32_t full[kMapWords];    // full heads
  uint32_t kept[kMapWords];    // full heads & valid
  int head_pre[kMapWords + 1]; // flank heads in the words before
  int x_pre[kMapWords + 1];    // x in the words before
  int last_head[kMapWords];    // last flank head in the words before, or -1
  int next_head[kMapWords];    // first flank head in the words after, or kSpan
  int next_full[kMapWords];    // first full head in the words after, or kSpan
  int x_next[kMapWords];       // x below next_head (when < kSpan)
  int x_last[kMapWords];       // x below last_head (when >= 0)
};

// x in the block's rows [0, p), p < kSpan.
__device__ __forceinline__ int x_below(const Maps& m, int p) {
  return m.x_pre[p >> 5] + __popc(m.x[p >> 5] & ((1u << (p & 31)) - 1u));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
scan_kernel(const uint32_t* __restrict__ words, int W, int n,
            const uint8_t* __restrict__ valid, int file_word, int file_shift,
            uint32_t sentinel, int flank_bits, int ff_bits, int n_files,
            unsigned* __restrict__ ticket, unsigned long long* fwd,
            unsigned long long* rev, int4* __restrict__ open,
            uint8_t* __restrict__ keep, int* __restrict__ counts,
            int* __restrict__ gid) {
  __shared__ __align__(16) uint32_t s_buf[kPlanes][kBuf];
  __shared__ Maps m;
  __shared__ int s_tile, s_heads_before;
  __shared__ bool s_first_keep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool control = warp == kRowWarps;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = s_tile;
  const long long s = (long long)b * kTile;
  const long long lo = s > 0 ? s - 1 : 0;
  const long long hi = min((long long)n, s + kSpan);

  // 1. Head flags and validity of this thread's rows s + 32 * (warp *
  //    kWarpWords + k) + lane, bit k of each mask.
  uint32_t any = 0, ff = 0, fl = 0, ok = 0;
  if (valid && !control) {
    #pragma unroll
    for (int k = 0; k < kWarpWords; ++k) {
      const long long r = s + 32 * (warp * kWarpWords + k) + lane;
      if (r < n && valid[r]) ok |= 1u << k;
    }
  }
  // Plane w's rows [lo, hi) land at s_buf[p] from index pad(w) on, the
  // 16-byte block of the first row at index 0.
  auto pad_of = [&](int w) {
    return (int)(((uintptr_t)(words + (long long)w * n + lo) & 15) >> 2);
  };
  for (int w0 = 0; w0 < W; w0 += kPlanes) {
    const int planes = min(kPlanes, W - w0);
    for (int p = 0; p < planes; ++p) {
      const char* src = (const char*)(words + (long long)(w0 + p) * n + lo)
                        - 4 * pad_of(w0 + p);
      const int n_vec = (pad_of(w0 + p) + (int)(hi - lo) + 3) >> 2;
      for (int v = threadIdx.x; v < n_vec; v += kThreads)
        cp_async16(&s_buf[p][4 * v], src + 16 * v);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int p = 0; p < planes && !control; ++p) {
      const int w = w0 + p;
      const uint32_t* buf = s_buf[p] + pad_of(w) + (int)(s - lo);   // row s
      const uint32_t ff_mask = prefix_mask(w, ff_bits);
      const uint32_t fl_mask = prefix_mask(w, flank_bits);
      #pragma unroll
      for (int k = 0; k < kWarpWords; ++k) {
        const int j = 32 * (warp * kWarpWords + k) + lane;
        if (s + j >= hi) continue;
        const uint32_t cur = buf[j];
        if (s + j > 0) {
          const uint32_t d = cur ^ buf[j - 1];
          any |= (uint32_t)(d != 0) << k;
          ff |= (uint32_t)((d & ff_mask) != 0) << k;
          fl |= (uint32_t)((d & fl_mask) != 0) << k;
        }
        if (!valid && w == file_word && ((cur >> file_shift) & sentinel)
                                            != sentinel)
          ok |= 1u << k;
      }
    }
    __syncthreads();
  }
  #pragma unroll
  for (int k = 0; k < kWarpWords && !control; ++k) {
    const long long r = s + 32 * (warp * kWarpWords + k) + lane;
    const bool edge = r == 0 || r >= n;        // rows past n: heads, invalid
    const bool v = r < n && ((ok >> k) & 1);
    const bool hf = edge || ((any >> k) & 1);
    const unsigned bh = __ballot_sync(0xffffffffu, edge || ((fl >> k) & 1));
    const unsigned bx = __ballot_sync(0xffffffffu,
                                      v && (edge || ((ff >> k) & 1)));
    const unsigned bf = __ballot_sync(0xffffffffu, hf);
    const unsigned bk = __ballot_sync(0xffffffffu, v && hf);
    if (lane == 0) {
      const int i = warp * kWarpWords + k;
      m.head[i] = bh;
      m.x[i] = bx;
      m.full[i] = bf;
      m.kept[i] = bk;
    }
  }
  __syncthreads();

  // 2. The control warp scans the bitmap words, publishes the tile's own
  //    pair and triple, and keeps the x counts below each word's nearest
  //    heads, so that a row reads the shared arrays of its own word only.
  Fwd own = {0, 0};
  int first_x = -1;          // x below the tile's first flank head (or -1)
  if (control) {
    int hc = 0, xc = 0, last = -1, first_h = kSpan, first_f = kSpan;
    for (int i = 0; i < kLaneWords; ++i) {
      const int q = kLaneWords * lane + i;
      if (q >= kMapWords) break;
      const uint32_t h = m.head[q], f = m.full[q];
      hc += __popc(h);
      xc += __popc(m.x[q]);
      if (h) {
        last = 32 * q + 31 - __clz(h);
        if (first_h == kSpan) first_h = 32 * q + __ffs(h) - 1;
      }
      if (f && first_f == kSpan) first_f = 32 * q + __ffs(f) - 1;
    }
    const int h_in = warp_sum(hc, lane), x_in = warp_sum(xc, lane);
    int h_run = h_in - hc, x_run = x_in - xc;
    int last_run = __shfl_up_sync(0xffffffffu, warp_max(last, lane), 1);
    if (lane == 0) last_run = -1;
    int nh_run = __shfl_down_sync(0xffffffffu, warp_rmin(first_h, lane), 1);
    int nf_run = __shfl_down_sync(0xffffffffu, warp_rmin(first_f, lane), 1);
    if (lane == 31) nh_run = nf_run = kSpan;
    for (int i = 0; i < kLaneWords; ++i) {
      const int q = kLaneWords * lane + i;
      if (q >= kMapWords) break;
      const uint32_t h = m.head[q];
      m.head_pre[q] = h_run;
      m.x_pre[q] = x_run;
      m.last_head[q] = last_run;
      h_run += __popc(h);
      x_run += __popc(m.x[q]);
      if (h) last_run = 32 * q + 31 - __clz(h);
    }
    for (int i = kLaneWords - 1; i >= 0; --i) {
      const int q = kLaneWords * lane + i;
      if (q >= kMapWords) continue;
      m.next_head[q] = nh_run;
      m.next_full[q] = nf_run;
      if (m.head[q]) nh_run = 32 * q + __ffs(m.head[q]) - 1;
      if (m.full[q]) nf_run = 32 * q + __ffs(m.full[q]) - 1;
    }
    if (lane == 31) {
      m.head_pre[kMapWords] = h_in;
      m.x_pre[kMapWords] = x_in;
    }
    __syncwarp();
    for (int i = 0; i < kLaneWords; ++i) {
      const int q = kLaneWords * lane + i;
      if (q >= kMapWords) break;
      const int nh = m.next_head[q], lh = m.last_head[q];
      m.x_next[q] = nh < kSpan ? x_below(m, nh) : 0;
      m.x_last[q] = lh >= 0 ? x_below(m, lh) : 0;
    }
    // the tile's own pair (its rows only, not the look-ahead), and the
    // triple patch_kernel reads: a tile with a flank head covers the rest
    // of the table by itself
    const int heads = m.head_pre[kTileWords], xs = m.x_pre[kTileWords];
    const int last_h = m.last_head[kTileWords];
    own = {heads, last_h >= 0 ? xs - x_below(m, last_h) : xs};
    const int fh = m.head[0] ? __ffs(m.head[0]) - 1 : m.next_head[0];
    first_x = fh < kSpan ? x_below(m, fh) : -1;
    if (lane == 0) {
      st_relaxed(fwd + b, fwd_pack(b ? kOwn : kInclusive, own));
      const int ffh = m.full[0] ? __ffs(m.full[0]) - 1 : m.next_full[0];
      const Rev r = {heads > 0, fh < kTile ? first_x : xs,
                     ffh < kTile ? (int)(s + ffh) : n};
      st_relaxed(rev + b, rev_pack(heads > 0, r));
    }
  }
  __syncthreads();

  // 3. The control warp finds the pair over the earlier tiles (decoupled
  //    look-back) while the row warps form their rows' outputs; only gid
  //    and the keep of rows in a group begun before the tile need it.
  //    Four consecutive rows a thread and store; counts leave at once.
  if (control) {
    const Fwd before = b ? lookback_fwd(fwd, b, lane) : Fwd{0, 0};
    const Fwd incl = fwd_combine(before, own);
    if (lane == 0) {
      if (b) st_relaxed(fwd + b, fwd_pack(kInclusive, incl));
      s_heads_before = before.heads;
      s_first_keep = first_x >= 0 && first_x + before.sum == n_files;
    }
    // the tile's last group is open if no flank head lies in the
    // look-ahead; its last run then too if no full head does
    const bool is_open = m.next_head[kTileWords - 1] == kSpan;
    int run = -1;
    if (is_open && m.next_full[kTileWords - 1] == kSpan) {
      // the tile's last full head, found from its last word down
      for (int c = 0; c < kTileWords / 32; ++c) {
        const int q = kTileWords - 1 - 32 * c - lane;
        const uint32_t f = m.full[q];
        const unsigned any_f = __ballot_sync(0xffffffffu, f != 0);
        if (!any_f) continue;
        const int l = __ffs(any_f) - 1;
        const int ql = kTileWords - 1 - 32 * c - l;
        const int p = 32 * ql + 31 - __clz(__shfl_sync(0xffffffffu, f, l));
        if ((m.kept[ql] >> (p & 31)) & 1) run = (int)(s + p);
        break;
      }
    }
    if (lane == 0)
      open[b] = make_int4(is_open, incl.sum,
                          own.heads ? m.last_head[kTileWords] : 0, run);
  }
  int g_local[kRowsPerThread];
  uint32_t kept_rows = 0, pending = 0;   // bit 4 it + e: row r0(it) + e
  #pragma unroll
  for (int it = 0; it < kRowsPerThread / 4; ++it) {
    const int r0 = 4 * (threadIdx.x + it * kRowThreads);
    if (control || s + r0 >= n) break;
    const int q = r0 >> 5;
    const uint32_t h = m.head[q], f = m.full[q], kept = m.kept[q];
    const uint32_t x = m.x[q];
    const int hp = m.head_pre[q], xp = m.x_pre[q], nfq = m.next_full[q];
    const int nhq = m.next_head[q], lhq = m.last_head[q];
    const int xnq = m.x_next[q], xlq = m.x_last[q];
    int c4[4];
    #pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + e, bit = r & 31, i = 4 * it + e;
      const uint32_t le = 0xffffffffu >> (31 - bit);   // bits 0..bit
      g_local[i] = hp + __popc(h & le) - 1;
      c4[e] = 0;
      if (!((kept >> bit) & 1)) continue;
      const uint32_t fn = f & ~le, hn = h & ~le, hw = h & le;
      // provisional for an open run: kSpan - r > 0 marks a valid head
      c4[e] = (fn ? 32 * q + __ffs(fn) - 1 : nfq) - r;
      int x_end = -1;                 // x below the next flank head
      if (hn) x_end = xp + __popc(x & ((1u << (__ffs(hn) - 1)) - 1u));
      else if (nhq < kSpan) x_end = xnq;
      if (x_end < 0) continue;        // open group: patch_kernel's
      if (hw)
        kept_rows |= (uint32_t)(x_end - xp - __popc(
            x & ((1u << (31 - __clz(hw))) - 1u)) == n_files) << i;
      else if (lhq >= 0)
        kept_rows |= (uint32_t)(x_end - xlq == n_files) << i;
      else
        pending |= 1u << i;           // the group began before the tile
    }
    const long long row = s + r0;
    if (row + 3 < n) {
      *reinterpret_cast<int4*>(counts + row) =
          make_int4(c4[0], c4[1], c4[2], c4[3]);
    } else {
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        if (row + e < n) counts[row + e] = c4[e];
    }
  }
  __syncthreads();
  const int heads_before = s_heads_before;
  if (s_first_keep) kept_rows |= pending;
  #pragma unroll
  for (int it = 0; it < kRowsPerThread / 4; ++it) {
    const long long row = s + 4 * (threadIdx.x + it * kRowThreads);
    if (control || row >= n) break;
    const int i = 4 * it;
    const uint32_t k4 = (kept_rows >> i) & 0xfu;
    if (row + 3 < n) {
      *reinterpret_cast<int4*>(gid + row) = make_int4(
          heads_before + g_local[i], heads_before + g_local[i + 1],
          heads_before + g_local[i + 2], heads_before + g_local[i + 3]);
      *reinterpret_cast<uchar4*>(keep + row) =
          make_uchar4(k4 & 1, (k4 >> 1) & 1, (k4 >> 2) & 1, k4 >> 3);
    } else {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (row + e >= n) break;
        gid[row + e] = heads_before + g_local[i + e];
        keep[row + e] = (k4 >> e) & 1;
      }
    }
  }
}

// open[b] = (the tile's last group is open, the sum of x from that group's
// head to the tile's end, its head's row in the tile (0 if before), the
// row of a valid full head whose run is open, or -1).
__global__ void __launch_bounds__(kPatchThreads)
patch_kernel(int n, int nb, int n_files, unsigned long long* rev,
             const int4* __restrict__ open, uint8_t* __restrict__ keep,
             int* __restrict__ counts) {
  __shared__ int s_sum, s_first;
  const int b = nb - 1 - (int)blockIdx.x;
  const int4 o = open[b];
  const unsigned long long own = ld_relaxed(rev + b);
  if ((own & kDone) && !o.x) return;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const Rev after = lookback_rev(rev, b, nb, n, lane);
    if (lane == 0) {
      if (!(own & kDone))
        st_relaxed(rev + b, rev_pack(true, rev_combine(rev_unpack(own),
                                                       after)));
      s_sum = after.sum;
      s_first = after.first;
    }
  }
  __syncthreads();
  if (!o.x) return;
  if (o.w >= 0 && threadIdx.x == 0) counts[o.w] = s_first - o.w;
  if (o.y + s_sum != n_files) return;
  __syncthreads();
  const long long s = (long long)b * kTile;
  const long long end = min((long long)n, s + kTile);
  // counts is non-zero exactly at valid full heads (provisional or not)
  for (long long r = s + o.z + threadIdx.x; r < end; r += kPatchThreads)
    keep[r] = counts[r] != 0;
}

}  // namespace

extern "C" int krisp_survivor_scan_block_rows() { return kTile; }
extern "C" int krisp_survivor_scan_ahead_rows() { return kAhead; }

// Launches scan_kernel and patch_kernel on ``stream``.  ``valid`` null:
// layout mode, a row is valid where bits [file_shift, file_shift + width)
// of its word ``file_word``, masked by ``file_sentinel``, are not the
// sentinel.  Scratch: ``state`` uint64[1 + 2 nb] (the ticket, then the
// forward and reverse status words) and ``open`` int32[nb, 4], nb = ceil(n
// / kTile).  Returns the first cudaError_t of a call.
extern "C" int krisp_survivor_scan(int device, void* stream, const void* words,
                                   int W, long long n, const void* valid,
                                   int file_word, int file_shift,
                                   unsigned file_sentinel, int flank_bits,
                                   int ff_bits, int n_files, void* state,
                                   void* open, void* keep, void* counts,
                                   void* gid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (n >= POS || W < 1 || (!valid && (file_word < 0 || file_word >= W)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (int)((n + kTile - 1) / kTile);
  unsigned long long* st = (unsigned long long*)state;
  err = cudaMemsetAsync(st, 0, sizeof(unsigned long long) * (1 + nb), s);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<nb, kThreads, 0, s>>>(
      (const uint32_t*)words, W, (int)n, (const uint8_t*)valid, file_word,
      file_shift, file_sentinel, flank_bits, ff_bits, n_files,
      (unsigned*)st, st + 1, st + 1 + nb, (int4*)open, (uint8_t*)keep,
      (int*)counts, (int*)gid);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  patch_kernel<<<nb, kPatchThreads, 0, s>>>((int)n, nb, n_files,
                                            st + 1 + nb, (const int4*)open,
                                            (uint8_t*)keep, (int*)counts);
  return (int)cudaGetLastError();
}

extern "C" const char* krisp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
