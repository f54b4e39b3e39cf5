// Lexicographic sort of multi-word u32 rows: an LSD radix sort (sm_90a).
//
// Replaces krisp_tpu/ops/pallas_sort.py:bitonic_sort_words (kernels
// _local_sort_kernel, _cross_kernel, _local_merge_kernel).  Input: words
// uint32[V, n], word 0 most significant, one row per column.  Output: the
// rows in ascending unsigned lexicographic order (all-ones sentinel rows
// last).  The TPU network is not stable and need not be: equal rows are
// identical, so any correct sort gives the same bits.  This one happens to
// be stable.
//
// The bitonic network exists because a TPU has no cheap scatter; Hopper
// does, so this is a least-significant-digit radix sort over 8-bit digits,
// from the low byte of word V-1 to the high byte of word 0.  Digit k
// (k = 0 the least significant) is byte k % 4 of word V - 1 - k / 4.
//   1. histogram_kernel reads the keys once and builds all 4V digit
//      histograms (256 bins each, shared atomics) at once.  The host reads them back and
//      skips every digit whose histogram puts all n rows in one bin: the
//      zero tail bits of the last word (204 of 224 bits are used at
//      30/40/30, 116 of 128 at 4-bit 25/1/2) and constant high digits cost
//      nothing.
//   2. Each remaining digit is one pass of three kernels:
//      upsweep_kernel counts each block's rows per bin (bin-major, so
//      counts[bin][block]); scan_kernel turns those counts, with the
//      digit's histogram, into each (bin, block)'s first output row;
//      scatter_kernel ranks its block's rows stably in shared memory (warp
//      match from 8 ballots + per-warp bin counters), stages them in
//      sorted order and writes them out in runs of equal digits.
//
// What bounds it: bytes moved per pass.  Moving all V words every pass
// would be O(V^2) traffic (the problem krisp_tpu/ops/sort.py:lsd_sort
// describes), so:
//   - V <= 2: the passes move the key words themselves (8 bytes a row);
//   - V > 2: the passes move (digit word, 32-bit row id) pairs.  Before the
//     first pass on a word, gather_kernel reads that word through the
//     current permutation; after the last pass, all V words are gathered
//     once through the final permutation.
// Per pass a row costs 4 bytes read by the upsweep, 8 read and 8 written by
// the scatter; a gather costs a 32-byte sector per row, which makes index
// mode dearer per pass (H100: 40.6M rows x 2 words in about 4.5 ms, x 7
// words in about 30 ms, two thirds of it gathers).  The kernel allocates nothing: the caller passes the output,
// the scratch buffers and a host buffer for the histograms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // rows per thread per pass
constexpr int kTile = kThreads * kItems;      // rows per block
constexpr int kBins = 256;
constexpr int kScanThreads = 1024;
constexpr int kHistItems = 4;
constexpr int kHistBlocks = 512;              // per word, grid-stride
constexpr int kMaxWords = 64;
static_assert(kThreads == kBins, "one thread per bin in the block scans");

// What a pass carries beside its digit word.
constexpr int kCarryNone = 0;    // V == 1
constexpr int kCarryArray = 1;   // the other key word (V == 2) or row ids
constexpr int kCarryIota = 2;    // row ids of the input order (V > 2, first pass)

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ bool is_leader(unsigned peers) {
  return (int)(__ffs(peers) - 1) == (int)(threadIdx.x & 31);
}

// The lanes of the warp that are ``in`` and hold the same 8-bit digit ``d``
// (garbage for lanes that are not in).  One ballot per digit bit: on the
// H100 the scatter ran 1.3x slower with the hardware __match_any_sync.
// The counting kernels take plain shared atomics, which beat both there,
// heavy ties included.
__device__ __forceinline__ unsigned match_digit(unsigned d, bool in) {
  unsigned peers = __ballot_sync(0xffffffffu, in);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
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

// hist[(4 * (V - 1 - v) + j) * 256 + bin] counts the rows whose byte j of
// word v (j = 0 the low byte) is bin.  Grid: (blocks, V).
__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint32_t* __restrict__ words, long long n, int V,
                 unsigned* __restrict__ hist) {
  __shared__ unsigned s_hist[4 * kBins];
  for (int j = threadIdx.x; j < 4 * kBins; j += kThreads) s_hist[j] = 0;
  __syncthreads();
  const int v = blockIdx.y;
  const uint32_t* w = words + (long long)v * n;
  const long long step = (long long)gridDim.x * kThreads * kHistItems;
  for (long long base = (long long)blockIdx.x * kThreads * kHistItems;
       base < n; base += step) {
    uint32_t x[kHistItems];
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      x[k] = i < n ? w[i] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kHistItems; ++k) {
      const bool in = base + k * kThreads + threadIdx.x < n;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (in) atomicAdd(&s_hist[j * kBins + ((x[k] >> (8 * j)) & 0xffu)],
                          1u);
    }
  }
  __syncthreads();
  unsigned* out = hist + (long long)4 * (V - 1 - v) * kBins;
  for (int j = threadIdx.x; j < 4 * kBins; j += kThreads)
    if (s_hist[j]) atomicAdd(&out[j], s_hist[j]);
}

// counts[bin * nb + b]: rows of block b's tile whose digit is bin.
__global__ void __launch_bounds__(kThreads)
upsweep_kernel(const uint32_t* __restrict__ src, long long n, int shift,
               int nb, unsigned* __restrict__ counts) {
  __shared__ unsigned s_cnt[kBins];
  s_cnt[threadIdx.x] = 0;
  __syncthreads();
  const long long start = (long long)blockIdx.x * kTile;
  uint32_t x[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = start + k * kThreads + threadIdx.x;
    x[k] = i < n ? src[i] : 0u;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool in = start + k * kThreads + threadIdx.x < n;
    if (in) atomicAdd(&s_cnt[(x[k] >> shift) & 0xffu], 1u);
  }
  __syncthreads();
  counts[(long long)threadIdx.x * nb + blockIdx.x] = s_cnt[threadIdx.x];
}

// One block per bin: counts[bin][*] becomes the first output row of each
// (bin, block), that is the rows of lower digits plus the rows of this digit
// in earlier blocks.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(unsigned* __restrict__ counts, int nb,
            const unsigned* __restrict__ digit_hist) {
  __shared__ unsigned s_warp[32];
  const int bin = blockIdx.x;
  unsigned total;
  const unsigned below = threadIdx.x < bin ? digit_hist[threadIdx.x] : 0u;
  block_exclusive_sum(below, s_warp, &total);
  unsigned run = total;
  unsigned* row = counts + (long long)bin * nb;
  for (int s = 0; s < nb; s += kScanThreads) {
    const int b = s + threadIdx.x;
    const unsigned c = b < nb ? row[b] : 0u;
    const unsigned excl = block_exclusive_sum(c, s_warp, &total);
    if (b < nb) row[b] = run + excl;
    run += total;
  }
}

// Stable scatter of block b's tile by digit.  Warp w ranks rows
// [start + w * 32 * kItems, +32 * kItems) in order, 32 at a time: a match
// groups the lanes of equal digit, and a per-warp counter per bin gives the
// group its base.  Per bin, the warps' counts and the block's lower bins
// give each row its place in the tile's sorted order; rows are staged there
// in shared memory and leave in runs of equal digits.
template <int kCarry>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint32_t* __restrict__ src_d,
               const uint32_t* __restrict__ src_c, long long n, int shift,
               int nb, const unsigned* __restrict__ offsets,
               uint32_t* __restrict__ dst_d, uint32_t* __restrict__ dst_c) {
  __shared__ unsigned s_whist[kWarps][kBins];
  __shared__ unsigned s_bin_start[kBins];
  __shared__ unsigned s_gofs[kBins];
  __shared__ unsigned s_warp[32];
  __shared__ uint32_t s_key[kTile];
  __shared__ uint32_t s_carry[kCarry == kCarryNone ? 1 : kTile];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long start = (long long)blockIdx.x * kTile;
  const long long wstart = start + (long long)warp * 32 * kItems;
  for (int j = threadIdx.x; j < kWarps * kBins; j += kThreads)
    (&s_whist[0][0])[j] = 0;

  uint32_t key[kItems], car[kItems];
  unsigned rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = wstart + k * 32 + lane;
    const bool in = i < n;
    key[k] = in ? src_d[i] : 0u;
    if (kCarry == kCarryArray) car[k] = in ? src_c[i] : 0u;
    if (kCarry == kCarryIota) car[k] = (uint32_t)i;
  }
  __syncthreads();

  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool in = wstart + k * 32 + lane < n;
    const unsigned d = (key[k] >> shift) & 0xffu;
    const unsigned peers = match_digit(d, in);
    const unsigned base = in ? s_whist[warp][d] : 0u;
    __syncwarp();
    if (in && is_leader(peers)) s_whist[warp][d] = base + __popc(peers);
    __syncwarp();
    rank[k] = base + __popc(peers & lt);
  }
  __syncthreads();

  {
    const int bin = threadIdx.x;
    unsigned run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const unsigned t = s_whist[w][bin];
      s_whist[w][bin] = run;
      run += t;
    }
    unsigned total;
    s_bin_start[bin] = block_exclusive_sum(run, s_warp, &total);
    s_gofs[bin] = offsets[(long long)bin * nb + blockIdx.x];
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (wstart + k * 32 + lane < n) {
      const unsigned d = (key[k] >> shift) & 0xffu;
      const unsigned lp = s_bin_start[d] + s_whist[warp][d] + rank[k];
      s_key[lp] = key[k];
      if (kCarry != kCarryNone) s_carry[lp] = car[k];
    }
  }
  __syncthreads();

  const long long rest = n - start;
  const int valid = (int)(rest < kTile ? rest : kTile);
  for (int j = threadIdx.x; j < valid; j += kThreads) {
    const uint32_t x = s_key[j];
    const unsigned d = (x >> shift) & 0xffu;
    const long long pos = (long long)s_gofs[d] + (j - (int)s_bin_start[d]);
    dst_d[pos] = x;
    if (kCarry != kCarryNone) dst_c[pos] = s_carry[j];
  }
}

// dst[y][i] = src[y][perm[i]] for word y = blockIdx.y, except word skip.
__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint32_t* __restrict__ src,
              const uint32_t* __restrict__ perm, long long n, int skip,
              uint32_t* __restrict__ dst) {
  if ((int)blockIdx.y == skip) return;
  const long long off = (long long)blockIdx.y * n;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step)
    dst[off + i] = src[off + perm[i]];
}

struct Pass {
  cudaStream_t s;
  long long n;
  int nb;
  unsigned* counts;
  const unsigned* hist;   // device histograms, [4V][256]
};

// One digit pass: upsweep, scan, scatter.  Returns the first launch error.
cudaError_t run_pass(const Pass& p, int k, int carry, const uint32_t* src_d,
                     const uint32_t* src_c, uint32_t* dst_d, uint32_t* dst_c) {
  const int shift = 8 * (k % 4);
  upsweep_kernel<<<p.nb, kThreads, 0, p.s>>>(src_d, p.n, shift, p.nb,
                                             p.counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<<<kBins, kScanThreads, 0, p.s>>>(p.counts, p.nb,
                                               p.hist + (long long)k * kBins);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (carry == kCarryNone)
    scatter_kernel<kCarryNone><<<p.nb, kThreads, 0, p.s>>>(
        src_d, src_c, p.n, shift, p.nb, p.counts, dst_d, dst_c);
  else if (carry == kCarryArray)
    scatter_kernel<kCarryArray><<<p.nb, kThreads, 0, p.s>>>(
        src_d, src_c, p.n, shift, p.nb, p.counts, dst_d, dst_c);
  else
    scatter_kernel<kCarryIota><<<p.nb, kThreads, 0, p.s>>>(
        src_d, src_c, p.n, shift, p.nb, p.counts, dst_d, dst_c);
  return cudaGetLastError();
}

unsigned gather_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 4096 ? b : 4096);
}

}  // namespace

extern "C" int krisp_sort_words_block_rows() { return kTile; }
extern "C" int krisp_sort_words_max_words() { return kMaxWords; }

// Sorts ``in`` (uint32[V, n]) into ``out`` on ``stream``.  Scratch, all
// from the caller: ``scratch`` uint32[V * n] for V <= 2, else uint32[4 * n];
// ``hist`` uint32[4 V * 256] on the device and ``hist_host`` the same on the
// host; ``counts`` uint32[256 * nb] with nb = ceil(n / block rows).  The
// call waits for the histograms (one stream synchronisation), then queues
// the passes and returns.  Returns the first cudaError_t.
extern "C" int krisp_sort_words(int device, void* stream, const void* in,
                                int V, long long n, void* out, void* scratch,
                                void* hist, void* hist_host, void* counts) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (V < 1 || V > kMaxWords || n < 0 || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* src = (const uint32_t*)in;
  uint32_t* dst = (uint32_t*)out;
  const size_t hist_bytes = (size_t)4 * V * kBins * sizeof(unsigned);

  if ((err = cudaMemsetAsync(hist, 0, hist_bytes, s)) != cudaSuccess)
    return (int)err;
  const long long hb = (n + kThreads * kHistItems - 1) / (kThreads * kHistItems);
  histogram_kernel<<<dim3((unsigned)(hb < kHistBlocks ? hb : kHistBlocks), V),
                     kThreads, 0, s>>>(src, n, V, (unsigned*)hist);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaMemcpyAsync(hist_host, hist, hist_bytes,
                             cudaMemcpyDeviceToHost, s)) != cudaSuccess)
    return (int)err;
  if ((err = cudaStreamSynchronize(s)) != cudaSuccess) return (int)err;

  // active[k]: digit k splits the rows (no bin holds all n)
  const unsigned* h = (const unsigned*)hist_host;
  bool active[4 * kMaxWords];
  int n_active = 0;
  for (int k = 0; k < 4 * V; ++k) {
    bool split = true;
    for (int b = 0; b < kBins; ++b)
      if (h[k * kBins + b] == (unsigned)n) split = false;
    active[k] = split;
    n_active += split;
  }
  const size_t bytes = (size_t)V * n * sizeof(uint32_t);
  if (n_active == 0)
    return (int)cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, s);

  Pass p{s, n, (int)((n + kTile - 1) / kTile), (unsigned*)counts,
         (const unsigned*)hist};

  if (V <= 2) {
    // ping-pong between out and scratch so that the last pass lands in out
    uint32_t* tmp = (uint32_t*)scratch;
    const uint32_t* cur = src;
    int done = 0;
    for (int k = 0; k < 4 * V; ++k) {
      if (!active[k]) continue;
      uint32_t* next = (n_active - 1 - done) % 2 == 0 ? dst : tmp;
      const int wd = V - 1 - k / 4, wc = 1 - wd;
      err = run_pass(p, k, V == 2 ? kCarryArray : kCarryNone, cur + wd * n,
                     V == 2 ? cur + wc * n : nullptr, next + wd * n,
                     V == 2 ? next + wc * n : nullptr);
      if (err != cudaSuccess) return (int)err;
      cur = next;
      ++done;
    }
    return (int)cudaSuccess;
  }

  // V > 2: sort (digit word, row id) pairs, one word at a time
  uint32_t* cur_buf[2] = {(uint32_t*)scratch, (uint32_t*)scratch + n};
  uint32_t* perm_buf[2] = {(uint32_t*)scratch + 2 * n,
                           (uint32_t*)scratch + 3 * n};
  const uint32_t* perm = nullptr;     // nullptr: the input order
  const uint32_t* digits = nullptr;   // the sorted values of word sorted_wd
  int sorted_wd = -1;
  for (int wd = V - 1; wd >= 0; --wd) {
    const int k0 = 4 * (V - 1 - wd);
    if (!(active[k0] || active[k0 + 1] || active[k0 + 2] || active[k0 + 3]))
      continue;
    digits = src + (long long)wd * n;
    if (perm != nullptr) {
      gather_kernel<<<dim3(gather_blocks(n), 1), kThreads, 0, s>>>(
          digits, perm, n, -1, cur_buf[0]);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      digits = cur_buf[0];
    }
    for (int k = k0; k < k0 + 4; ++k) {
      if (!active[k]) continue;
      uint32_t* next_d = digits == cur_buf[0] ? cur_buf[1] : cur_buf[0];
      uint32_t* next_p = perm == perm_buf[0] ? perm_buf[1] : perm_buf[0];
      err = run_pass(p, k, perm == nullptr ? kCarryIota : kCarryArray, digits,
                     perm, next_d, next_p);
      if (err != cudaSuccess) return (int)err;
      digits = next_d;
      perm = next_p;
    }
    sorted_wd = wd;
  }
  // the last word sorted is in place already; gather the others
  if ((err = cudaMemcpyAsync(dst + (long long)sorted_wd * n, digits,
                             n * sizeof(uint32_t), cudaMemcpyDeviceToDevice,
                             s)) != cudaSuccess)
    return (int)err;
  gather_kernel<<<dim3(gather_blocks(n), V), kThreads, 0, s>>>(
      src, perm, n, sorted_wd, dst);
  return (int)cudaGetLastError();
}
