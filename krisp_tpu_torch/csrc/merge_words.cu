// Merge of two sorted multi-word u32 tables: a merge-path merge (sm_90a).
//
// Replaces krisp_tpu/ops/pallas_merge.py:merge_sorted_words (diagonal
// search _merge_splits, kernel _merge_kernel).  Input: A uint32[V, nA] and
// B uint32[V, nB], word 0 most significant, one row per column, each sorted
// ascending as unsigned tuples.  Output: uint32[V, nA + nB], the rows of
// both in ascending order.  Equal rows are identical, so the order of ties
// does not show in the bits; here a tie takes the B row first, as
// _merge_splits sends ties to B.
//
// The TPU kernel merges an A window and a pre-reversed B window with a
// bitonic network, because a TPU core cannot address VMEM by data.  Hopper
// can, so this is a plain merge path over tiles of T output rows:
//   1. split_kernel: one thread per tile boundary d = g * T binary-searches
//      the diagonal d for a_split[g], the number of the first d merged rows
//      that come from A (A[i] < B[d-1-i] moves the split right).
//   2. merge_kernel: block g stages A[a_split[g], a_split[g+1]) and the
//      matching B slice (T rows together) in shared memory, word by word
//      with coalesced loads; each thread merge-path-searches its own
//      sub-diagonal there, merges its T / 256 rows serially and records
//      each output row's staged slot; the block then stores the tile word by
//      word, coalesced, reading the rows through those slots.
// Every read of a slice is bounded by its count, so a run that is used up
// (its split at the last boundary) and empty runs need no padding.
//
// What bounds it: bytes.  Each row is read once and written once (8 V bytes
// a row) beside the split search's log2(n) scattered reads per tile: a
// 40M-row x 2-word merge moves 0.64 GB, about 0.2 ms at the H100's
// published 3.35 TB/s.  T shrinks for wide rows so that a staged tile stays
// within 96 KB of dynamic shared memory.  The kernel allocates nothing: the
// caller passes the output and the split array.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 2048;             // rows per tile, V <= 12
constexpr int kStageBytes = 96 * 1024;     // staged rows per block, at most
constexpr int kMaxWords = 64;
constexpr int kSplitThreads = 256;

// Rows per tile for V words: the largest power of two up to kMaxTile whose
// staged rows fit kStageBytes, and at least one row a thread.
int tile_rows(int V) {
  int t = kMaxTile;
  while (t > kThreads && (long long)t * V * 4 > kStageBytes) t /= 2;
  return t;
}

// Row ia of x < row ib of y, unsigned and lexicographic over V words; word w
// of a row sits at w * stride.
__device__ __forceinline__ bool row_less(const uint32_t* x, long long sx,
                                         long long ia, const uint32_t* y,
                                         long long sy, long long ib, int V) {
  for (int w = 0; w < V; ++w) {
    const uint32_t p = x[w * sx + ia], q = y[w * sy + ib];
    if (p != q) return p < q;
  }
  return false;
}

// splits[g] for g in [0, G]: how many of the first min(g * T, n) merged rows
// come from A.
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const uint32_t* __restrict__ a, long long na,
             const uint32_t* __restrict__ b, long long nb, int V, int T,
             int G, int* __restrict__ splits) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g > G) return;
  const long long n = na + nb;
  const long long d = (long long)g * T < n ? (long long)g * T : n;
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {   // lo <= mid < hi keeps both reads inside their runs
    const long long mid = (lo + hi) >> 1;
    if (row_less(a, na, mid, b, nb, d - 1 - mid, V))
      lo = mid + 1;
    else
      hi = mid;
  }
  splits[g] = (int)lo;
}

// One tile of T output rows.  Dynamic shared memory: the staged rows
// uint32[V][T] (A's slice, then B's), then each output row's slot
// uint16[T].
__global__ void __launch_bounds__(kThreads)
merge_kernel(const uint32_t* __restrict__ a, long long na,
             const uint32_t* __restrict__ b, long long nb, int V, int T,
             const int* __restrict__ splits, uint32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* stage = smem;
  uint16_t* slot = (uint16_t*)(smem + (size_t)V * T);
  const long long n = na + nb;
  const long long d0 = (long long)blockIdx.x * T;
  const long long d1 = d0 + T < n ? d0 + T : n;
  const long long a_lo = splits[blockIdx.x], a_hi = splits[blockIdx.x + 1];
  const long long b_lo = d0 - a_lo;
  const int cnt = (int)(d1 - d0);
  const int a_cnt = (int)(a_hi - a_lo), b_cnt = cnt - a_cnt;

  for (int w = 0; w < V; ++w) {
    uint32_t* row = stage + (size_t)w * T;
    const uint32_t* aw = a + w * na + a_lo;
    const uint32_t* bw = b + w * nb + b_lo;
    for (int i = threadIdx.x; i < a_cnt; i += kThreads) row[i] = aw[i];
    for (int i = threadIdx.x; i < b_cnt; i += kThreads) row[a_cnt + i] = bw[i];
  }
  __syncthreads();

  // this thread's output rows [p, q) of the tile
  const int items = T / kThreads;
  int p = threadIdx.x * items;
  if (p < cnt) {
    const int q = p + items < cnt ? p + items : cnt;
    int lo = p > b_cnt ? p - b_cnt : 0;
    int hi = p < a_cnt ? p : a_cnt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (row_less(stage, T, mid, stage, T, a_cnt + p - 1 - mid, V))
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = p - lo;
    for (; p < q; ++p) {
      // A's row goes first only when strictly less: ties take B, as the
      // splits do, so every thread's rows continue its neighbour's
      const bool take_a =
          j >= b_cnt ||
          (i < a_cnt && row_less(stage, T, i, stage, T, a_cnt + j, V));
      slot[p] = (uint16_t)(take_a ? i++ : a_cnt + j++);
    }
  }
  __syncthreads();

  for (int w = 0; w < V; ++w) {
    const uint32_t* row = stage + (size_t)w * T;
    uint32_t* ow = out + w * n + d0;
    for (int k = threadIdx.x; k < cnt; k += kThreads) ow[k] = row[slot[k]];
  }
}

}  // namespace

extern "C" int krisp_merge_words_max_words() { return kMaxWords; }
extern "C" int krisp_merge_words_tile_rows(int V) { return tile_rows(V); }

// Merges ``a`` (uint32[V, na]) and ``b`` (uint32[V, nb]), each sorted, into
// ``out`` (uint32[V, na + nb]) on ``stream``.  Scratch from the caller:
// ``splits`` int32[G + 1] with G = ceil((na + nb) / tile_rows(V)).  Returns
// the first cudaError_t; na + nb = 0 launches nothing.
extern "C" int krisp_merge_words(int device, void* stream, const void* a,
                                 long long na, const void* b, long long nb,
                                 int V, void* out, void* splits) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = na + nb;
  if (V < 1 || V > kMaxWords || na < 0 || nb < 0 || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = tile_rows(V);
  const int G = (int)((n + T - 1) / T);
  split_kernel<<<(G + kSplitThreads) / kSplitThreads, kSplitThreads, 0, s>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, V, T, G, (int*)splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = (size_t)V * T * sizeof(uint32_t) + T * sizeof(uint16_t);
  if ((err = cudaFuncSetAttribute(merge_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  merge_kernel<<<G, kThreads, smem, s>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, V, T,
      (const int*)splits, (uint32_t*)out);
  return (int)cudaGetLastError();
}
