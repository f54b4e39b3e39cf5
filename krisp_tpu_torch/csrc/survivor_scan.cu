// Survivor scan over a sorted KeyLayout table (sm_90a).
//
// Replaces krisp_tpu/ops/pallas_scan.py:pallas_survivor_scan (kernels
// _forward_kernel and _reverse_kernel).  Input: key words uint32[W, n],
// sorted ascending as unsigned tuples, and valid uint8[n].  Per row i:
//   head_full / head_ff / head_flank: row i starts a run of equal keys,
//       compared on the whole key / its leading ff_bits / its leading
//       flank_bits (row 0 is a head of all three);
//   x    = head_ff & valid;        c = inclusive prefix sum of x;
//   gid  = (inclusive prefix count of head_flank) - 1;
//   base = running max of (head_flank ? c - x : NEG);
//   endc = suffix min of (is_last ? c : POS), is_last[i] = head_flank[i+1]
//          (the last row is always a tail);
//   nxt  = suffix min of (head_full[i+1] ? i+1 : n);
// Output: keep = head_full & valid & (endc - base == n_files),
//         counts = head_full & valid ? nxt - i : 0, and gid.
// This is krisp_tpu/ops/intersect.py:survivor_mark_bits (unweighted).
//
// The TPU kernel carried scalars across a sequential grid.  CUDA blocks run
// in no order, so this is a plain three-phase scan instead:
//   1. flags_kernel:     head flags + validity, one byte per row;
//      aggregate_kernel: per block of kTile rows, the block's sum of x, count
//                        of flank heads, and the block-local max/min that
//                        base, endc and nxt need;
//   2. carries_kernel:   one block scans the per-block aggregates into each
//                        block's incoming carries (a block's local max of
//                        c - x is shifted by that block's incoming c; NEG and
//                        POS stay as they are);
//   3. apply_kernel:     each block redoes its local scans with its carries
//                        and writes keep, counts and gid.
// Each block reads one flag byte past its end (is_last and nxt need row
// i + 1), and the ragged last block masks rows >= n.
//
// What bounds it: memory.  Per row it reads 4W + 1 bytes of input, writes
// one flag byte and reads it back twice, and writes 9 bytes of output; the
// block aggregates are 40 bytes per 2,048 rows.  Outputs are staged in
// shared memory so every global store is coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // consecutive rows per thread
constexpr int kTile = kThreads * kItems;     // rows per block
constexpr int kCarryThreads = 1024;
constexpr int NEG = -2147483647;
constexpr int POS = 2147483647;

constexpr uint8_t F_FULL = 1, F_FF = 2, F_FLANK = 4, F_VALID = 8;

struct Sum { __device__ int operator()(int a, int b) const { return a + b; } };
struct Max { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct Min { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };

// Exclusive scan of one value per thread across the block, in thread order
// (kReverse: from the last thread down).  Every thread of the block must
// call it.  *total receives the combination of all values.
template <bool kReverse, typename Op>
__device__ int block_exclusive(int v, Op op, int identity, int* s_warp,
                               int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = kReverse ? __shfl_down_sync(0xffffffffu, incl, d)
                           : __shfl_up_sync(0xffffffffu, incl, d);
    if (kReverse ? lane + d < 32 : lane >= d) incl = op(incl, y);
  }
  int excl = kReverse ? __shfl_down_sync(0xffffffffu, incl, 1)
                      : __shfl_up_sync(0xffffffffu, incl, 1);
  if (kReverse ? lane == 31 : lane == 0) excl = identity;
  if (kReverse ? lane == 0 : lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = identity, all = identity;
  for (int w = 0; w < n_warps; ++w) {
    const int t = s_warp[w];
    all = op(all, t);
    if (kReverse ? w > warp : w < warp) before = op(before, t);
  }
  __syncthreads();
  *total = all;
  return op(before, excl);
}

__device__ __forceinline__ uint32_t prefix_mask(int w, int n_bits) {
  const int full = n_bits >> 5, rem = n_bits & 31;
  if (w < full) return 0xffffffffu;
  if (w == full && rem) return 0xffffffffu << (32 - rem);
  return 0u;
}

__global__ void flags_kernel(const uint32_t* __restrict__ words, int W,
                             long long n, const uint8_t* __restrict__ valid,
                             int flank_bits, int ff_bits,
                             uint8_t* __restrict__ flags) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t f = valid[i] ? F_VALID : 0;
  if (i == 0) {
    f |= F_FULL | F_FF | F_FLANK;
  } else {
    uint32_t any = 0, ff = 0, fl = 0;
    for (int w = 0; w < W; ++w) {
      const uint32_t d = words[(long long)w * n + i] ^
                         words[(long long)w * n + i - 1];
      any |= d;
      ff |= d & prefix_mask(w, ff_bits);
      fl |= d & prefix_mask(w, flank_bits);
    }
    if (any) f |= F_FULL;
    if (ff) f |= F_FF;
    if (fl) f |= F_FLANK;
  }
  flags[i] = f;
}

// The rows of one thread: the flags of its kItems consecutive rows and the
// per-row inputs of the scans.
struct Items {
  int x[kItems];        // head_ff & valid
  int hf[kItems];       // head_flank
  int head[kItems];     // head_full & valid
  int last[kItems];     // is_last
  int nxt[kItems];      // head_full[i+1] ? i+1 : n
};

// Loads the block's tile of flags (plus one row past it) into shared memory
// and unpacks this thread's rows.  Rows >= n get the identity of every scan.
__device__ void load_items(const uint8_t* __restrict__ flags, long long n,
                           uint8_t* s_flags, Items& it) {
  const long long start = (long long)blockIdx.x * kTile;
  for (int j = threadIdx.x; j <= kTile; j += kThreads) {
    const long long row = start + j;
    s_flags[j] = row < n ? flags[row] : 0;
  }
  __syncthreads();
  for (int k = 0; k < kItems; ++k) {
    const int j = threadIdx.x * kItems + k;
    const long long row = start + j;
    const uint8_t f = s_flags[j], next = s_flags[j + 1];
    const bool in = row < n, tail = row == n - 1;
    it.x[k] = (f & F_FF) && (f & F_VALID);
    it.hf[k] = (f & F_FLANK) != 0;
    it.head[k] = (f & F_FULL) && (f & F_VALID);
    it.last[k] = in && (tail || (next & F_FLANK));
    it.nxt[k] = (in && !tail && (next & F_FULL)) ? (int)(row + 1) : (int)n;
  }
}

// agg[0..4][b]: sum of x, count of flank heads, max of (head_flank ?
// c_local - x : NEG), min of (is_last ? c_local : POS), min of nxt; c_local
// is the prefix sum of x from the block's first row.
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const uint8_t* __restrict__ flags, long long n, int nb,
                 int* __restrict__ agg) {
  __shared__ uint8_t s_flags[kTile + 1];
  __shared__ int s_warp[32];
  Items it;
  load_items(flags, n, s_flags, it);

  int sx = 0, shf = 0;
  for (int k = 0; k < kItems; ++k) { sx += it.x[k]; shf += it.hf[k]; }
  int tot_x, tot_hf, tot_m, tot_e, tot_n;
  int c = block_exclusive<false>(sx, Sum(), 0, s_warp, &tot_x);
  block_exclusive<false>(shf, Sum(), 0, s_warp, &tot_hf);
  int m = NEG, e = POS, nx = (int)n;
  for (int k = 0; k < kItems; ++k) {
    c += it.x[k];
    if (it.hf[k]) m = Max()(m, c - it.x[k]);
    if (it.last[k]) e = Min()(e, c);
    nx = Min()(nx, it.nxt[k]);
  }
  block_exclusive<false>(m, Max(), NEG, s_warp, &tot_m);
  block_exclusive<false>(e, Min(), POS, s_warp, &tot_e);
  block_exclusive<false>(nx, Min(), (int)n, s_warp, &tot_n);
  if (threadIdx.x == 0) {
    const int b = blockIdx.x;
    agg[b] = tot_x;
    agg[nb + b] = tot_hf;
    agg[2 * nb + b] = tot_m;
    agg[3 * nb + b] = tot_e;
    agg[4 * nb + b] = tot_n;
  }
}

// carry[0..4][b]: the global c before block b, flank heads before block b,
// max of base over blocks before b, min of endc over blocks after b, min of
// nxt over blocks after b.  One block walks the aggregates tile by tile.
__global__ void __launch_bounds__(kCarryThreads)
carries_kernel(const int* __restrict__ agg, int nb, long long n,
               int* __restrict__ carry) {
  __shared__ int s_warp[32];
  int c_run = 0, g_run = 0, b_run = NEG;
  for (int s = 0; s < nb; s += kCarryThreads) {
    const int b = s + threadIdx.x;
    const bool in = b < nb;
    const int sx = in ? agg[b] : 0;
    const int shf = in ? agg[nb + b] : 0;
    const int bm = in ? agg[2 * nb + b] : NEG;
    int tx, th, tm;
    const int cx = c_run + block_exclusive<false>(sx, Sum(), 0, s_warp, &tx);
    const int cg = g_run + block_exclusive<false>(shf, Sum(), 0, s_warp, &th);
    const int shifted = bm == NEG ? NEG : bm + cx;
    const int cm = Max()(b_run, block_exclusive<false>(shifted, Max(), NEG,
                                                       s_warp, &tm));
    if (in) {
      carry[b] = cx;
      carry[nb + b] = cg;
      carry[2 * nb + b] = cm;
    }
    c_run += tx;
    g_run += th;
    b_run = Max()(b_run, tm);
  }
  __syncthreads();
  int e_run = POS, n_run = (int)n;
  const int n_tiles = (nb + kCarryThreads - 1) / kCarryThreads;
  for (int t = n_tiles - 1; t >= 0; --t) {
    const int b = t * kCarryThreads + threadIdx.x;
    const bool in = b < nb;
    const int be = in ? agg[3 * nb + b] : POS;
    const int bn = in ? agg[4 * nb + b] : (int)n;
    const int shifted = be == POS ? POS : be + (in ? carry[b] : 0);
    int te, tn;
    const int ce = Min()(e_run, block_exclusive<true>(shifted, Min(), POS,
                                                      s_warp, &te));
    const int cn = Min()(n_run, block_exclusive<true>(bn, Min(), (int)n,
                                                      s_warp, &tn));
    if (in) {
      carry[3 * nb + b] = ce;
      carry[4 * nb + b] = cn;
    }
    e_run = Min()(e_run, te);
    n_run = Min()(n_run, tn);
  }
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const uint8_t* __restrict__ flags, long long n, int nb,
             int n_files, const int* __restrict__ carry,
             uint8_t* __restrict__ keep, int* __restrict__ counts,
             int* __restrict__ gid) {
  __shared__ uint8_t s_flags[kTile + 1];
  __shared__ int s_warp[32];
  __shared__ int s_counts[kTile];
  __shared__ int s_gid[kTile];
  __shared__ uint8_t s_keep[kTile];
  Items it;
  load_items(flags, n, s_flags, it);
  const int b = blockIdx.x;
  const long long start = (long long)b * kTile;

  int sx = 0, shf = 0;
  for (int k = 0; k < kItems; ++k) { sx += it.x[k]; shf += it.hf[k]; }
  int tot;
  int c = carry[b] + block_exclusive<false>(sx, Sum(), 0, s_warp, &tot);
  int g = carry[nb + b] + block_exclusive<false>(shf, Sum(), 0, s_warp, &tot);

  int cs[kItems], gs[kItems];
  int m = NEG, e = POS, nx = (int)n;
  for (int k = 0; k < kItems; ++k) {
    c += it.x[k];
    g += it.hf[k];
    cs[k] = c;
    gs[k] = g;
    if (it.hf[k]) m = Max()(m, c - it.x[k]);
    if (it.last[k]) e = Min()(e, c);
    nx = Min()(nx, it.nxt[k]);
  }
  int base = Max()(carry[2 * nb + b],
                   block_exclusive<false>(m, Max(), NEG, s_warp, &tot));
  int endc = Min()(carry[3 * nb + b],
                   block_exclusive<true>(e, Min(), POS, s_warp, &tot));
  int nxt = Min()(carry[4 * nb + b],
                  block_exclusive<true>(nx, Min(), (int)n, s_warp, &tot));

  int bases[kItems];
  for (int k = 0; k < kItems; ++k) {
    if (it.hf[k]) base = Max()(base, cs[k] - it.x[k]);
    bases[k] = base;
  }
  for (int k = kItems - 1; k >= 0; --k) {
    const int j = threadIdx.x * kItems + k;
    if (it.last[k]) endc = Min()(endc, cs[k]);
    nxt = Min()(nxt, it.nxt[k]);
    const bool head = it.head[k];
    s_keep[j] = head && (endc - bases[k] == n_files);
    s_counts[j] = head ? nxt - (int)(start + j) : 0;
    s_gid[j] = gs[k] - 1;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long row = start + j;
    if (row >= n) break;
    keep[row] = s_keep[j];
    counts[row] = s_counts[j];
    gid[row] = s_gid[j];
  }
}

}  // namespace

extern "C" int krisp_survivor_scan_block_rows() { return kTile; }

// Launches the four kernels on ``stream``.  Scratch: flags uint8[n],
// agg and carry int32[5, nb] with nb = ceil(n / kTile).  Returns the first
// cudaError_t of a launch.
extern "C" int krisp_survivor_scan(int device, void* stream, const void* words,
                                   int W, long long n, const void* valid,
                                   int flank_bits, int ff_bits, int n_files,
                                   void* flags, void* agg, void* carry,
                                   void* keep, void* counts, void* gid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (n >= POS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (int)((n + kTile - 1) / kTile);
  flags_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const uint32_t*)words, W, n, (const uint8_t*)valid, flank_bits,
      ff_bits, (uint8_t*)flags);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  aggregate_kernel<<<nb, kThreads, 0, s>>>((const uint8_t*)flags, n, nb,
                                           (int*)agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  carries_kernel<<<1, kCarryThreads, 0, s>>>((const int*)agg, nb, n,
                                             (int*)carry);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  apply_kernel<<<nb, kThreads, 0, s>>>((const uint8_t*)flags, n, nb, n_files,
                                       (const int*)carry, (uint8_t*)keep,
                                       (int*)counts, (int*)gid);
  return (int)cudaGetLastError();
}

extern "C" const char* krisp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
