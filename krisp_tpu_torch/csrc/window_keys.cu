// Window keys for one genome buffer, both strands, in one pass (sm_90a).
//
// Replaces krisp_tpu/ops/pallas_pack.py:pallas_window_keys_both (kernel
// _tree_kernel).  For every window start i of a uint8 buffer of P bytes
// (n_win = P - L + 1 windows) it computes
//   ok[i]       1 when all L bases are A/C/G/T (and, under omit_soft, none
//               is lowercase), else 0;
//   fwd[w][i]   word w of the forward-strand KeyLayout key;
//   rc[w][i]    word w of the reverse-complement key.
// Codes come from arithmetic on the byte, exactly as
// pallas_pack.py:_codes_and_valid does.  Two modes:
//   - krisp_window_keys: (ok, fwd, rc) with the genome-id field zero, the
//     TPU kernel's contract;
//   - krisp_window_keys_table: the whole per-genome table of
//     ops/intersect.py:_all_window_keys in one pass: int32[W, 2 n_win] at a
//     row stride the caller gives (a slice of a wider table), forward keys
//     in columns [0, n_win), reverse keys in [n_win, 2 n_win), the genome
//     id OR'd into its word, and all-ones rows where a window is not valid.
//
// What bounds it: memory.  Each window reads one byte and writes 8W bytes
// of keys (plus 1 byte of ok in the first mode): 16 bytes out per byte in
// at 25/1/2.  So the work per window has to stay below the stores:
//   - a block stages its tile of 4,096 windows' bases plus the
//     (L - 1)-byte halo in shared memory once, as (code, validity) bytes,
//     in 16-byte loads, padded so that a warp's reads hit 32 banks;
//   - a thread owns a stretch of 16 consecutive windows and slides them:
//     for each run of the key plan it keeps the run's bits of the forward
//     key in a register that shifts in the next base's code per window,
//     and the reverse-complement run shifts in the complement from the
//     other end.  A running count of invalid bases enters and leaves with
//     the window.  A window then costs O(runs of the plan) shared loads,
//     not O(L), plus (L + m) / 16 for priming each stretch;
//   - each word's stretch values are staged in shared memory (row pitch
//     17, conflict free) and leave as structure-of-arrays rows, a warp's
//     32 neighbouring windows in one coalesced 128-byte store.
//
// The key plan is not hard-coded: the caller passes the runs of
// ops/encode.py:_word_runs as (word, p0, bit0, m) quadruples, sorted by
// word.  A run puts m consecutive window bases, starting at window
// position p0, at bit offsets bit0, bit0 + 2, ... of its word (MSB first).
// The reverse-complement key holds, at the same slots, the complement of
// window base L - 1 - p.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStretch = 16;                 // windows a thread slides
constexpr int kTile = kThreads * kStretch;   // windows per block
constexpr int kPitch = kStretch + 1;         // staging row pitch
constexpr int kMaxL = 1024;
constexpr int kMaxRuns = 256;
constexpr int kCodeBytes = kTile + kMaxL + 4 * ((kTile + kMaxL) / 128 + 1);

// Where staged byte j lives: 4 bytes of padding after every 128, so that
// the 32 lanes of a warp, whose stretches start 16 bytes apart, read 32
// different banks rather than 8.
__device__ __forceinline__ int cpos(int j) { return j + 4 * (j >> 7); }

// bits 0-1: 2-bit code (A0 C1 G2 T3), bit 2: base is valid
__device__ __forceinline__ uint8_t code_of(uint32_t b, int omit_soft) {
  const uint32_t upper = b & 0xDFu;          // fold a..z onto A..Z
  const uint32_t y = (upper >> 1) & 3u;      // A0 C1 T2 G3
  const uint32_t code = y ^ (y >> 1);        // swap 2 <-> 3
  bool valid = upper == 'A' || upper == 'C' || upper == 'G' || upper == 'T';
  if (omit_soft && (b & 0x20u)) valid = false;
  return (uint8_t)(code | (valid ? 4u : 0u));
}

template <bool kTable>
__global__ void __launch_bounds__(kThreads)
window_keys_kernel(const uint8_t* __restrict__ buf, long long P,
                   long long n_win, int L, int W,
                   const int4* __restrict__ runs, int n_runs, int omit_soft,
                   uint8_t* __restrict__ ok, uint32_t* __restrict__ fwd,
                   uint32_t* __restrict__ rc, long long row_stride,
                   int fword, uint32_t fvalue) {
  __shared__ __align__(16) uint8_t s_code[kCodeBytes];   // code_of, at cpos
  __shared__ int4 s_runs[kMaxRuns];
  __shared__ uint32_t s_f[kThreads * kPitch];
  __shared__ uint32_t s_c[kThreads * kPitch];

  const long long start = (long long)blockIdx.x * kTile;
  const long long rest = P - start;
  const int span = (int)(rest < kTile + L - 1 ? rest : kTile + L - 1);
  // the tile and its halo in 16-byte loads where the buffer allows them
  // (one or a few a thread, all in flight at once), else byte by byte;
  // past the buffer the bytes are 0: invalid, read only by unstored windows
  const int staged = kTile + L - 1;
  const bool wide = ((uintptr_t)(buf + start) & 15u) == 0;
  const int n_vec = wide ? span / 16 : 0;
  for (int q = threadIdx.x; q < n_vec; q += kThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf + start + 16 * q);
    const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t out = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out |= (uint32_t)code_of((in[k] >> (8 * b)) & 0xFFu, omit_soft)
               << (8 * b);
      *reinterpret_cast<uint32_t*>(s_code + cpos(16 * q + 4 * k)) = out;
    }
  }
  for (int j = 16 * n_vec + threadIdx.x; j < staged; j += kThreads)
    s_code[cpos(j)] = j < span ? code_of(buf[start + j], omit_soft)
                               : (uint8_t)0;
  for (int r = threadIdx.x; r < n_runs; r += kThreads) s_runs[r] = runs[r];
  __syncthreads();

  // this thread's stretch: tile windows [j0, j0 + kStretch)
  const int j0 = threadIdx.x * kStretch;
  const long long i0 = start + j0;

  // validity: the invalid bases in the window, counted in and out
  int bad = 0;
  for (int k = 0; k < L - 1; ++k) bad += !(s_code[cpos(j0 + k)] & 4u);
  unsigned okbits = 0;
#pragma unroll
  for (int s = 0; s < kStretch; ++s) {
    bad += !(s_code[cpos(j0 + s + L - 1)] & 4u);
    okbits |= (bad == 0 ? 1u : 0u) << s;
    bad -= !(s_code[cpos(j0 + s)] & 4u);
  }
  if (!kTable) {
    if (i0 + kStretch <= n_win) {
      // 16 bytes at a 16-byte aligned offset: one wide store
      uint32_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned b4 = okbits >> (4 * k);
        q[k] = (b4 & 1u) | ((b4 >> 1) & 1u) << 8 | ((b4 >> 2) & 1u) << 16 |
               ((b4 >> 3) & 1u) << 24;
      }
      *reinterpret_cast<uint4*>(ok + i0) = make_uint4(q[0], q[1], q[2], q[3]);
    } else {
      for (int s = 0; s < kStretch && i0 + s < n_win; ++s)
        ok[i0 + s] = (uint8_t)((okbits >> s) & 1u);
    }
  }

  int r = 0;
  for (int w = 0; w < W; ++w) {
    uint32_t af[kStretch], ac[kStretch];
#pragma unroll
    for (int s = 0; s < kStretch; ++s) af[s] = ac[s] = 0u;
    for (; r < n_runs && s_runs[r].x == w; ++r) {
      const int p0 = s_runs[r].y, bit0 = s_runs[r].z, m = s_runs[r].w;
      const int lsh = 32 - bit0 - 2 * m;   // slot of window base p0 + m - 1
      const int hsh = 30 - bit0;           // slot of window base p0
      const uint32_t mask =
          (m == 16 ? 0xFFFFFFFFu : (1u << (2 * m)) - 1u) << lsh;
      // the base entering the forward run at window s of the stretch is
      // staged byte fp + s; the one entering the reverse run is cp + s
      const int fp = j0 + p0 + m - 1, cp = j0 + L - 1 - p0;
      uint32_t f = 0, c = 0;
      for (int s = 1 - m; s < 0; ++s) {    // prime with m - 1 bases
        f = ((f << 2) & mask) | (uint32_t)(s_code[cpos(fp + s)] & 3u) << lsh;
        c = ((c >> 2) & mask) |
            (uint32_t)(3u - (s_code[cpos(cp + s)] & 3u)) << hsh;
      }
#pragma unroll
      for (int s = 0; s < kStretch; ++s) {
        f = ((f << 2) & mask) | (uint32_t)(s_code[cpos(fp + s)] & 3u) << lsh;
        c = ((c >> 2) & mask) |
            (uint32_t)(3u - (s_code[cpos(cp + s)] & 3u)) << hsh;
        af[s] |= f;
        ac[s] |= c;
      }
    }
    if (kTable) {
#pragma unroll
      for (int s = 0; s < kStretch; ++s) {
        if (w == fword) {
          af[s] |= fvalue;
          ac[s] |= fvalue;
        }
        if (!((okbits >> s) & 1u)) af[s] = ac[s] = 0xFFFFFFFFu;
      }
    }
#pragma unroll
    for (int s = 0; s < kStretch; ++s) {
      s_f[threadIdx.x * kPitch + s] = af[s];
      s_c[threadIdx.x * kPitch + s] = ac[s];
    }
    __syncthreads();
    uint32_t* of = kTable ? fwd + w * row_stride : fwd + w * n_win;
    uint32_t* oc = kTable ? fwd + w * row_stride + n_win : rc + w * n_win;
    for (int x = threadIdx.x; x < kTile && start + x < n_win; x += kThreads) {
      const int a = (x / kStretch) * kPitch + x % kStretch;
      of[start + x] = s_f[a];
      oc[start + x] = s_c[a];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int krisp_window_keys_max_runs() { return kMaxRuns; }
extern "C" int krisp_window_keys_max_len() { return kMaxL; }

// (ok, fwd, rc), genome-id field zero.  Launches on ``stream``; returns the
// cudaError_t of the launch.
extern "C" int krisp_window_keys(int device, void* stream, const void* buf,
                                 long long P, int L, int W, const void* runs,
                                 int n_runs, int omit_soft, void* ok,
                                 void* fwd, void* rc) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || L > kMaxL || n_runs > kMaxRuns)
    return (int)cudaErrorInvalidValue;
  const long long n_win = P - L + 1;
  if (n_win <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((n_win + kTile - 1) / kTile);
  window_keys_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, P, n_win, L, W, (const int4*)runs, n_runs,
      omit_soft, (uint8_t*)ok, (uint32_t*)fwd, (uint32_t*)rc, 0, -1, 0u);
  return (int)cudaGetLastError();
}

// The table of both strands into ``out``: word w of window i at
// out[w * row_stride + i] (forward) and out[w * row_stride + n_win + i]
// (reverse), ``fvalue`` OR'd into word ``fword``, all-ones where the window
// is not valid.  Launches on ``stream``; returns the cudaError_t.
extern "C" int krisp_window_keys_table(int device, void* stream,
                                       const void* buf, long long P, int L,
                                       int W, const void* runs, int n_runs,
                                       int omit_soft, void* out,
                                       long long row_stride, int fword,
                                       unsigned fvalue) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_win = P - L + 1;
  if (L < 1 || L > kMaxL || n_runs > kMaxRuns || fword < 0 || fword >= W ||
      (n_win > 0 && row_stride < 2 * n_win))
    return (int)cudaErrorInvalidValue;
  if (n_win <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((n_win + kTile - 1) / kTile);
  window_keys_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, P, n_win, L, W, (const int4*)runs, n_runs,
      omit_soft, nullptr, (uint32_t*)out, nullptr, row_stride, fword,
      fvalue);
  return (int)cudaGetLastError();
}
