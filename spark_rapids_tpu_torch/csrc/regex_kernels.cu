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
// final line terminator).
//
// What bounds it on an H100: bytes. Each byte of the live rows is read
// once, plus 4 bytes of offsets, 1 of validity and 1 of output a row;
// where the walk stops early (below) only the bytes up to the stop count.
// The walk is a dependent chain of shared-memory loads, one a byte, with
// the row's bytes streaming in from device memory behind it.
//
// Design (the fastest of ten variants measured at Q22's shape; PERF.md):
//  * The table is 16 states x 256 bytes of one-byte next states in
//    shared memory, laid out [state][byte] (4 KB, copied from a device
//    table the wrapper caches per DFA and device). A step is one byte
//    permute, which puts (state << 8) | byte in a register, and one
//    shared load. Its bank is byte / 4 mod 32: lanes in one state never
//    conflict over ASCII bytes (lanes on one 4-byte group read one word),
//    where the first design's [byte][state] layout put every byte of one
//    residue mod 8 on one bank group (about four ways for a warp of
//    letters).
//  * One thread walks one row, grid-stride over a persistent grid, so a
//    warp's loads cover 32 adjacent rows and the whole grid's frontier
//    moves through the pool together. Sorting a tile's rows by length
//    to even out the lanes, 2 or 4 rows a thread, a contiguous run of
//    rows a warp, and staging tiles into shared memory with cp.async all
//    measured slower.
//  * Bytes come in 16-byte windows that start at the row's first 4-byte
//    word (so a head wastes at most 3 steps), cut by selects from two
//    aligned 16-byte loads; the next chunk loads while a window is
//    walked, with an L2 hint to fetch the 256 bytes around it. Only a
//    row's first and last windows step under a mask of its bytes. Bytes
//    of a chunk outside the row are loaded but never stepped (a chunk
//    never crosses a page boundary, so the aligned loads at the pool's
//    two ends stay in its allocation). A pool whose pointer is not 16-byte
//    aligned is walked from the aligned address below it, every offset
//    shifted.
//  * The walk stops at a window's end once its state is a stop state
//    (stop_mask, from the host): a non-accepting state that every byte
//    leads back to (anchored patterns die there), and in an absorbing
//    DFA every accepting state (they never lead out of acceptance).
//  * '$': a non-absorbing DFA walks all but the row's last byte, then
//    steps that byte alone; the state before it gives Java's '\n' rule.
//    A dead state before the last byte stays dead through it, so it
//    still rejects.
//  * Long rows take the same path: one thread walks a row of any length
//    (int32 offsets) from device memory, at the pace of one dependent
//    step a byte.
//
// Contract: offsets never falling. The kernel allocates nothing and never
// synchronizes; the entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define SRT_RX_THREADS 256
#define SRT_RX_STATES 16
#define SRT_RX_MAX_DEVICES 64

// 16 steps over one 16-byte window; MASKED steps only the bytes whose bit
// is set in m. __byte_perm(w, st, 0x5540 | j) is (st << 8) | byte j of w.
template <bool MASKED>
__device__ __forceinline__ uint32_t srt_rx_step16(const uint8_t* tbl, uint4 v, uint32_t st,
                                                  uint32_t m) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t nx = tbl[__byte_perm(w[k >> 2], st, 0x5540u | (uint32_t)(k & 3))];
    st = (!MASKED || ((m >> k) & 1u)) ? nx : st;
  }
  return st;
}

// one aligned 16-byte chunk, the L2 fetching the 256 bytes around it
__device__ __forceinline__ uint4 srt_rx_load(const uint4* src, uint32_t i) {
  uint4 v;
  asm volatile("ld.global.nc.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(src + i));
  return v;
}

// words q..q+3 of the eight words of a then b
__device__ __forceinline__ uint4 srt_rx_window(uint4 a, uint4 b, uint32_t q) {
  const bool q2 = q & 2u, q1 = q & 1u;
  const uint32_t w0 = q2 ? a.z : a.x, w1 = q2 ? a.w : a.y, w2 = q2 ? b.x : a.z,
                 w3 = q2 ? b.y : a.w, w4 = q2 ? b.z : b.x;
  return make_uint4(q1 ? w1 : w0, q1 ? w2 : w1, q1 ? w3 : w2, q1 ? w4 : w3);
}

// The state after stepping bytes [lo, hi) (lo < hi) from st, in windows
// starting at lo's 4-byte word p (chunk c holds p, at word q); it returns
// at a window's end once the state is a stop state.
__device__ __forceinline__ uint32_t srt_rx_walk(const uint4* src, uint32_t lo, uint32_t hi,
                                                uint32_t st, const uint8_t* tbl,
                                                uint32_t stop_mask) {
  uint32_t p = lo & ~3u, c = lo & ~15u;
  const uint32_t q = (p >> 2) & 3u;
  uint4 a = srt_rx_load(src, c >> 4), b = a;  // the chunks at c and c + 16
  if (c + 16 < hi) b = srt_rx_load(src, (c >> 4) + 1);
  uint32_t m = (0xFFFFu << (lo - p)) & 0xFFFFu;
  if (hi - p < 16) m &= (1u << (hi - p)) - 1u;
  st = srt_rx_step16<true>(tbl, srt_rx_window(a, b, q), st, m);
  p += 16;
  c += 16;
  a = b;
  if (c + 16 < hi) b = srt_rx_load(src, (c >> 4) + 1);
  while (p + 16 <= hi && !((stop_mask >> st) & 1u)) {
    const uint4 v = srt_rx_window(a, b, q);
    p += 16;
    c += 16;
    a = b;
    if (c + 16 < hi) b = srt_rx_load(src, (c >> 4) + 1);
    st = srt_rx_step16<false>(tbl, v, st, 0u);
  }
  if (p < hi && !((stop_mask >> st) & 1u))
    st = srt_rx_step16<true>(tbl, srt_rx_window(a, b, q), st, (1u << (hi - p)) - 1u);
  return st;
}

// One non-empty row's verdict.
template <bool ABSORBING>
__device__ __forceinline__ uint8_t srt_rx_row(const uint8_t* __restrict__ chars, uint32_t lo,
                                              uint32_t hi, const uint8_t* tbl,
                                              uint32_t accept_mask, uint32_t stop_mask) {
  const uint4* src = reinterpret_cast<const uint4*>(chars);
  if (ABSORBING) return (uint8_t)((accept_mask >> srt_rx_walk(src, lo, hi, 0u, tbl, stop_mask)) & 1u);
  const uint32_t last = __ldg(chars + hi - 1);
  uint32_t st = 0;
  if (hi - 1 > lo) st = srt_rx_walk(src, lo, hi - 1, 0u, tbl, stop_mask);
  const uint32_t fin = tbl[(st << 8) | last];
  return (uint8_t)(((accept_mask >> fin) & 1u) | ((last == 0x0Au) & ((accept_mask >> st) & 1u)));
}

template <bool ABSORBING>
__global__ void __launch_bounds__(SRT_RX_THREADS)
dfa_accept_rows_kernel(const int32_t* __restrict__ offsets, int64_t cap,
                       const uint8_t* __restrict__ chars, uint32_t shift, int64_t nch,
                       const uint8_t* __restrict__ validity, const uint4* __restrict__ table,
                       uint32_t accept_mask, uint32_t stop_mask, int start_accept,
                       uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t tbl[SRT_RX_STATES * 256];  // tbl[state * 256 + byte]
  for (int i = threadIdx.x; i < SRT_RX_STATES * 256 / 16; i += SRT_RX_THREADS)
    reinterpret_cast<uint4*>(tbl)[i] = table[i];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * SRT_RX_THREADS;
  for (int64_t i = (int64_t)blockIdx.x * SRT_RX_THREADS + threadIdx.x; i < cap; i += stride) {
    uint8_t r = 0;
    if (validity[i]) {
      int64_t lo = offsets[i], hi = offsets[i + 1];
      lo = lo < 0 ? 0 : (lo > nch ? nch : lo);
      hi = hi < lo ? lo : (hi > nch ? nch : hi);
      r = hi == lo ? (uint8_t)(start_accept != 0)
                   : srt_rx_row<ABSORBING>(chars, (uint32_t)lo + shift, (uint32_t)hi + shift, tbl,
                                           accept_mask, stop_mask);
    }
    out[i] = r;
  }
}

extern "C" int srt_dfa_accept_rows(const int32_t* offsets, int64_t cap, const uint8_t* chars,
                                   int64_t nch, const uint8_t* validity, const void* table,
                                   uint32_t accept_mask, uint32_t stop_mask, int absorbing,
                                   int start_accept, uint8_t* out, void* stream) {
  // blocks a card holds at once, by instantiation (absorbing or not) and device
  static int resident[2][SRT_RX_MAX_DEVICES];
  if (cap <= 0) return (int)cudaSuccess;
  if (nch < 0 || nch > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int ab = absorbing ? 1 : 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= SRT_RX_MAX_DEVICES)) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && resident[ab][dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ab ? (const void*)dfa_accept_rows_kernel<true>
                    : (const void*)dfa_accept_rows_kernel<false>,
        SRT_RX_THREADS, 0);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) resident[ab][dev] = (per_sm < 1 ? 1 : per_sm) * sms;
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  int64_t grid = (cap + SRT_RX_THREADS - 1) / SRT_RX_THREADS;
  if (grid > resident[ab][dev]) grid = resident[ab][dev];
  const uint32_t shift = (uint32_t)((uintptr_t)chars & 15u);
  const uint8_t* base = chars - shift;
  cudaStream_t s = (cudaStream_t)stream;
  const uint4* tb = (const uint4*)table;
  if (absorbing) {
    dfa_accept_rows_kernel<true><<<(unsigned)grid, SRT_RX_THREADS, 0, s>>>(
        offsets, cap, base, shift, nch, validity, tb, accept_mask, stop_mask, start_accept, out);
  } else {
    dfa_accept_rows_kernel<false><<<(unsigned)grid, SRT_RX_THREADS, 0, s>>>(
        offsets, cap, base, shift, nch, validity, tb, accept_mask, stop_mask, start_accept, out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* srt_regex_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
