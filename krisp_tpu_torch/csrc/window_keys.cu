// Window keys for one genome buffer, both strands, in one pass (sm_90a).
//
// Replaces krisp_tpu/ops/pallas_pack.py:pallas_window_keys_both (kernel
// _tree_kernel).  For every window start i of a uint8 buffer of P bytes
// (n_win = P - L + 1 windows) it writes
//   ok[i]       1 when all L bases are A/C/G/T (and, under omit_soft, none
//               is lowercase), else 0;
//   fwd[w][i]   word w of the forward-strand KeyLayout key;
//   rc[w][i]    word w of the reverse-complement key,
// with the genome-id field left zero.  Codes come from arithmetic on the
// byte, exactly as pallas_pack.py:_codes_and_valid does.
//
// What bounds it: memory.  Each window reads one byte and writes
// 1 + 8W bytes (W = 2 at 25/1/2: 17 bytes out per byte in), so the stores
// dominate.  The design keeps them to one coalesced 4-byte store per word
// and strand: a block stages its tile of the buffer plus an (L-1)-byte
// halo in shared memory once, converts each byte to (code, validity) once,
// and each thread then builds its windows' words in registers from shared
// memory, writing structure-of-arrays rows so neighbouring threads store
// neighbouring addresses.
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
constexpr int kTile = 2048;      // windows per block
constexpr int kMaxL = 1024;
constexpr int kMaxRuns = 256;

__global__ void __launch_bounds__(kThreads)
window_keys_kernel(const uint8_t* __restrict__ buf, long long P,
                   long long n_win, int L, int W,
                   const int4* __restrict__ runs, int n_runs, int omit_soft,
                   uint8_t* __restrict__ ok, uint32_t* __restrict__ fwd,
                   uint32_t* __restrict__ rc) {
  // bits 0-1: 2-bit code (A0 C1 G2 T3), bit 2: base is valid
  __shared__ uint8_t s_code[kTile + kMaxL];
  __shared__ int4 s_runs[kMaxRuns];

  const long long start = (long long)blockIdx.x * kTile;
  const long long rest = P - start;
  const int span = (int)(rest < kTile + L - 1 ? rest : kTile + L - 1);
  for (int j = threadIdx.x; j < span; j += kThreads) {
    const uint32_t b = buf[start + j];
    const uint32_t upper = b & 0xDFu;          // fold a..z onto A..Z
    const uint32_t y = (upper >> 1) & 3u;      // A0 C1 T2 G3
    const uint32_t code = y ^ (y >> 1);        // swap 2 <-> 3
    bool valid = upper == 'A' || upper == 'C' || upper == 'G' ||
                 upper == 'T';
    if (omit_soft && (b & 0x20u)) valid = false;
    s_code[j] = (uint8_t)(code | (valid ? 4u : 0u));
  }
  for (int r = threadIdx.x; r < n_runs; r += kThreads) s_runs[r] = runs[r];
  __syncthreads();

  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const long long i = start + j;
    if (i >= n_win) break;
    uint32_t all_valid = 4u;
    for (int k = 0; k < L; ++k) all_valid &= s_code[j + k];
    ok[i] = all_valid ? 1 : 0;

    int r = 0;
    for (int w = 0; w < W; ++w) {
      uint32_t f = 0, c = 0;
      for (; r < n_runs && s_runs[r].x == w; ++r) {
        const int p0 = s_runs[r].y, bit0 = s_runs[r].z, m = s_runs[r].w;
        for (int k = 0; k < m; ++k) {
          const int sh = 30 - bit0 - 2 * k;
          f |= (uint32_t)(s_code[j + p0 + k] & 3u) << sh;
          c |= (uint32_t)(3u - (s_code[j + L - 1 - p0 - k] & 3u)) << sh;
        }
      }
      fwd[(long long)w * n_win + i] = f;
      rc[(long long)w * n_win + i] = c;
    }
  }
}

}  // namespace

extern "C" int krisp_window_keys_max_runs() { return kMaxRuns; }
extern "C" int krisp_window_keys_max_len() { return kMaxL; }

// Launches on ``stream``; returns the cudaError_t of the launch.
extern "C" int krisp_window_keys(int device, void* stream, const void* buf,
                                 long long P, int L, int W, const void* runs,
                                 int n_runs, int omit_soft, void* ok,
                                 void* fwd, void* rc) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || L > kMaxL || n_runs > kMaxRuns) return (int)cudaErrorInvalidValue;
  const long long n_win = P - L + 1;
  if (n_win <= 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((n_win + kTile - 1) / kTile);
  window_keys_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, P, n_win, L, W, (const int4*)runs, n_runs,
      omit_soft, (uint8_t*)ok, (uint32_t*)fwd, (uint32_t*)rc);
  return (int)cudaGetLastError();
}
