// Hand-written Hopper (sm_90a) kernel for the regex row matcher.
//
// srt_dfa_accept_rows <- dfa_accept_rows (spark_rapids_tpu/ops/regex.py:563).
//    Not a Pallas kernel: the reference composes packed 16-state
//    transition vectors along the whole byte pool with a segmented
//    lax.associative_scan, resetting at row starts. PyTorch has no
//    associative scan with a user combine, and a log-step composition in
//    torch ops would pass over the pool about 23 times.
//
// What it computes: out[i] = validity[i] && accept(i) for each row i of a
// string column (offsets (cap+1,) int32, a uint8 pool of nch bytes; each
// offset clamped to [0, nch]). accept(i) runs the DFA from state 0 over
// the row's bytes [offsets[i], offsets[i+1]) and accepts when the final
// state is in accept_mask; an empty row takes start_accept. When the DFA
// is not absorbing (the pattern ends in '$'), a row that ends in '\n' also
// accepts when the state before that byte accepts (Java's '$' before a
// final line terminator; a row that is just "\n" takes state 0's verdict,
// start_accept).
//
// Design for the H100 (simple first; no row search, no scan):
//  * One thread per row, grid-stride. The thread reads only its row's
//    bytes: a sliced column whose offsets start mid-pool and a pool padded
//    past its last offset need no special case, and no reset can land
//    on a byte of another row.
//  * The transition table is 256 x 16 next states of one byte each
//    (4 KB) in shared memory, unpacked at block start from the two packed
//    256-word tables the host compiler gives (a kernel argument, so a call
//    needs no copy to the card). A step is one dependent shared load.
//  * Bytes come four at a time from 4-byte-aligned loads (the row's
//    unaligned head and tail a byte at a time): a warp's rows lie next to
//    each other in the pool, so its loads share cache lines.
//  * An absorbing DFA keeps accepting once it accepts: the walk stops
//    there.
//
// What bounds it on an H100: bytes. Each byte of the live rows is read
// once, plus 4 bytes of offsets, 1 of validity and 1 of output a row.
// The walk is a chain of dependent shared loads per thread, so with rows
// of tens of bytes the card is expected to stay above that bound.
//
// Contract: chars 4-byte aligned (the wrapper copies a view that is not),
// offsets never falling. The kernel allocates nothing and never
// synchronizes; the entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define SRT_RX_THREADS 256
#define SRT_RX_MAX_BLOCKS 4096
#define SRT_RX_STATES 16

struct SrtDfaLuts {
  uint32_t lo[256];  // next state of states 0-7, 4 bits each
  uint32_t hi[256];  // next state of states 8-15
};

template <bool ABSORBING>
__global__ void __launch_bounds__(SRT_RX_THREADS)
dfa_accept_rows_kernel(const int32_t* __restrict__ offsets, int64_t cap,
                       const uint8_t* __restrict__ chars, int64_t nch,
                       const uint8_t* __restrict__ validity,
                       const SrtDfaLuts luts, uint32_t accept_mask,
                       int start_accept, uint8_t* __restrict__ out) {
  __shared__ uint8_t tbl[256 * SRT_RX_STATES];  // tbl[byte * 16 + state]
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    const uint32_t lo = luts.lo[b], hi = luts.hi[b];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      tbl[b * SRT_RX_STATES + s] = (uint8_t)((lo >> (4 * s)) & 15u);
      tbl[b * SRT_RX_STATES + 8 + s] = (uint8_t)((hi >> (4 * s)) & 15u);
    }
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < cap;
       i += stride) {
    if (!validity[i]) {
      out[i] = 0;
      continue;
    }
    int64_t lo = offsets[i], hi = offsets[i + 1];
    lo = lo < 0 ? 0 : (lo > nch ? nch : lo);
    hi = hi < lo ? lo : (hi > nch ? nch : hi);
    if (hi == lo) {
      out[i] = (uint8_t)(start_accept != 0);
      continue;
    }
    unsigned st = 0, prev = 0, last = 0;
    bool done = false;
    int64_t p = lo;
    // one step; an absorbing DFA stops at its first accept
#define SRT_RX_STEP(byte)                                   \
    {                                                       \
      const unsigned b_ = (byte);                           \
      prev = st;                                            \
      last = b_;                                            \
      st = tbl[(b_ << 4) | st];                             \
      if (ABSORBING && ((accept_mask >> st) & 1u)) {        \
        done = true;                                        \
      }                                                     \
    }
    for (; p < hi && (p & 3) && !done; ++p) SRT_RX_STEP(__ldg(chars + p));
    for (; p + 4 <= hi && !done; p += 4) {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(chars + p));
      SRT_RX_STEP(w & 0xFFu);
      if (!done) SRT_RX_STEP((w >> 8) & 0xFFu);
      if (!done) SRT_RX_STEP((w >> 16) & 0xFFu);
      if (!done) SRT_RX_STEP(w >> 24);
    }
    for (; p < hi && !done; ++p) SRT_RX_STEP(__ldg(chars + p));
#undef SRT_RX_STEP
    bool acc = (accept_mask >> st) & 1u;
    if (!ABSORBING && last == 0x0Au) acc = acc || ((accept_mask >> prev) & 1u);
    out[i] = (uint8_t)acc;
  }
}

extern "C" int srt_dfa_accept_rows(const int32_t* offsets, int64_t cap,
                                   const uint8_t* chars, int64_t nch,
                                   const uint8_t* validity,
                                   const uint32_t* lut_lo,
                                   const uint32_t* lut_hi,
                                   uint32_t accept_mask, int absorbing,
                                   int start_accept, uint8_t* out,
                                   void* stream) {
  if (cap <= 0) return (int)cudaSuccess;
  SrtDfaLuts luts;
  for (int b = 0; b < 256; ++b) {
    luts.lo[b] = lut_lo[b];
    luts.hi[b] = lut_hi[b];
  }
  int64_t blocks = (cap + SRT_RX_THREADS - 1) / SRT_RX_THREADS;
  if (blocks > SRT_RX_MAX_BLOCKS) blocks = SRT_RX_MAX_BLOCKS;
  cudaStream_t s = (cudaStream_t)stream;
  if (absorbing) {
    dfa_accept_rows_kernel<true><<<(unsigned)blocks, SRT_RX_THREADS, 0, s>>>(
        offsets, cap, chars, nch, validity, luts, accept_mask, start_accept,
        out);
  } else {
    dfa_accept_rows_kernel<false><<<(unsigned)blocks, SRT_RX_THREADS, 0, s>>>(
        offsets, cap, chars, nch, validity, luts, accept_mask, start_accept,
        out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* srt_regex_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
