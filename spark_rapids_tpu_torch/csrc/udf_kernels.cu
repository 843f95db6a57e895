// Hand-written Hopper (sm_90a) kernel for the native string word count.
//
// K5 srt_word_counts <- _word_start_kernel (spark_rapids_tpu/udf/native.py,
//    launched by _word_starts_pallas), fused with the ragged row reduction
//    that consumes its flags there (_word_count_columnar: a prefix sum over
//    the whole pool, two gathers at the row offsets and a fix for rows that
//    start mid-pool). The in-tree native UDF string_word_count (the
//    reference's string_word_count.cu example).
//
// What it computes: out[r] = the number of words of row r of a string
// column (offsets (rows+1,) int32, chars uint8 of nch bytes; each offset
// clamped to [0, nch], as both packages clamp them). A word starts at byte
// i of row r when byte i is not ASCII whitespace (0x20, 0x09-0x0D) and i
// is the row's first byte or byte i-1 is whitespace.
//
// Design for the H100:
//  * Runs of rows, no search over the column: block b takes runs of
//    SRT_WC_ROWS rows (grid-stride). Its threads stage the run's offsets
//    in shared memory with coalesced loads (the next run's load while this
//    one counts) and read the run's bytes [offsets[R], offsets[R + ROWS])
//    in pieces of SRT_WC_PIECE 32-byte segments, SRT_WC_SPT segments a
//    thread, all of a piece's 16-byte loads in flight at once. Bytes past
//    offsets[rows] (the capacity padding) are never read.
//  * Flags in registers: a segment becomes a 32-bit whitespace mask by
//    per-byte arithmetic on its eight words (a multiply gathers the bits);
//    a word starts at a non-space byte after a space, the byte before a
//    segment coming from the neighbouring lane (__shfl_up_sync) or, for
//    lane 0, one byte load that the neighbouring warp already brought
//    into cache.
//  * Rows from prefix sums, no atomics: each segment's start bits, its
//    non-space bits and its start count go to shared memory, a block-wide
//    prefix sum turns the counts into the starts before each segment, and
//    each thread then reads its rows' counts as C(end) - C(start), where
//    C(x) is the prefix at x's segment plus a popcount of that segment's
//    bits below x, plus one when the row's first byte is a non-space byte
//    after a non-space byte (the row-start rule). Zero-length rows and
//    whitespace runs need no special path, and a row longer than a piece
//    adds up over the pieces it spans. Every row belongs to exactly one
//    run, so out needs no zero fill and no atomic.
//  * Measured and not kept (on a bench batch, where this takes about
//    0.042 ms): a binary search of each segment's row in the staged
//    offsets with a shared atomic per row piece (0.056 ms; its searches and
//    walks did not overlap the loads), the same with per-run segment marks
//    in place of the search or the next step's loads issued ahead (no
//    faster), and here the next piece's loads issued before the prefix sum
//    or pieces staged in shared memory by double-buffered cp.async (no
//    faster: the loads' latency is not what holds it).
//
// What bounds it on an H100: bytes. The live chars are read once, plus
// 4 bytes of offsets and 4 bytes of output per row: 76.8 MB, 0.023 ms, for
// a 2^20-row word-count batch of 68.4 MB of text at 3.35 TB/s. The flag
// array, the prefix sum over the pool and the gathers of the reference's
// chain are gone.
//
// Contract: chars 16-byte aligned (the wrapper copies a view that is not),
// offsets never falling. The kernel allocates nothing and never
// synchronizes; the entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define SRT_WC_THREADS 256
#define SRT_WC_SPT 4         // 32-byte segments per thread in a piece
#define SRT_WC_RPT 4         // rows per thread in a run
#define SRT_WC_MIN_BLOCKS 4  // blocks an SM: at most 64 registers a thread
#define SRT_WC_ROWS (SRT_WC_RPT * SRT_WC_THREADS)    // rows per run
#define SRT_WC_PIECE (SRT_WC_SPT * SRT_WC_THREADS)   // segments per piece
#define SRT_WC_WARPS (SRT_WC_THREADS / 32)

static_assert(SRT_WC_THREADS % 32 == 0 && SRT_WC_THREADS <= 1024, "whole warps");

__device__ __forceinline__ unsigned srt_is_space(unsigned b) {
  return b == 0x20u || (b >= 0x09u && b <= 0x0Du);
}

// High bit of each byte of x set where the byte is ASCII whitespace, by
// per-byte arithmetic: for a byte b below 0x80, b + 0x80 - n sets its high
// bit iff b >= n; a byte at or above 0x80 is never whitespace.
__device__ __forceinline__ unsigned srt_ws_bytes(unsigned x) {
  const unsigned lo7 = x & 0x7F7F7F7Fu;
  const unsigned ge9 = lo7 + 0x77777777u;                   // b >= 0x09
  const unsigned ge14 = lo7 + 0x72727272u;                  // b >= 0x0E
  const unsigned ne20 = (lo7 ^ 0x20202020u) + 0x7F7F7F7Fu;  // b != 0x20
  return ~x & ((ge9 & ~ge14) | ~ne20) & 0x80808080u;
}

// Bit j set where byte j of the eight bytes (x0, x1) is ASCII whitespace:
// the high bits of both words gathered by one multiply (the partial
// products land on distinct bits, so nothing carries).
__device__ __forceinline__ unsigned srt_ws8(unsigned x0, unsigned x1) {
  const unsigned m = (srt_ws_bytes(x0) >> 7) | (srt_ws_bytes(x1) >> 3);
  return ((m * 0x00204081u) >> 21) & 0xFFu;
}

// offsets[min(i, rows)] clamped to [0, nch]: rows past the column's end
// repeat its last offset, so they are empty.
__device__ __forceinline__ int srt_off(const int* __restrict__ offsets, long long rows,
                                       int nch, long long i) {
  const int o = __ldg(offsets + (i < rows ? i : rows));
  return o < 0 ? 0 : (o > nch ? nch : o);
}

// Segment g's 32 bytes as two 16-byte chunks (bytes at or past hi read as
// spaces; a chunk that ends past hi goes byte by byte), and the byte before
// it (pb, for lane 0 only: the other lanes take the neighbouring lane's).
__device__ __forceinline__ void srt_load_segment(const unsigned char* __restrict__ chars,
                                                 int g, int g0, int g1, int hi, int lane,
                                                 uint4 (&v)[2], unsigned& pb) {
  const int p0 = g * 32;
  const bool in = g < g1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = p0 + 16 * j;
    v[j] = make_uint4(0x20202020u, 0x20202020u, 0x20202020u, 0x20202020u);
    if (in && p + 16 <= hi) {
      v[j] = __ldg(reinterpret_cast<const uint4*>(chars + p));
    } else if (in && p < hi) {
      unsigned w[4] = {0x20202020u, 0x20202020u, 0x20202020u, 0x20202020u};
      for (int b = 0; p + b < hi; ++b)
        w[b >> 2] = (w[b >> 2] & ~(0xFFu << (8 * (b & 3)))) |
                    ((unsigned)chars[p + b] << (8 * (b & 3)));
      v[j] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  pb = lane == 0 && in && g > g0 ? __ldg(chars + p0 - 1) : 0x20u;
}

__global__ void __launch_bounds__(SRT_WC_THREADS, SRT_WC_MIN_BLOCKS)
    word_counts_kernel(const int* __restrict__ offsets, long long rows,
                       const unsigned char* __restrict__ chars, int nch,
                       int* __restrict__ out) {
  __shared__ int s_off[SRT_WC_ROWS + 1];
  __shared__ unsigned s_st[SRT_WC_PIECE + 1];   // per segment: word-start bits
  __shared__ unsigned s_nsp[SRT_WC_PIECE + 1];  // per segment: non-space bits
  __shared__ unsigned s_pre[SRT_WC_PIECE + 1];  // per segment: starts before it
  __shared__ unsigned s_wsum[SRT_WC_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long nruns = (rows + SRT_WC_ROWS - 1) / SRT_WC_ROWS;
  long long run = blockIdx.x;
  // this thread's staged offsets, rows tid + j * SRT_WC_THREADS of the run
  // (thread 0 also stages the run's end)
  int o[SRT_WC_RPT], oe = 0;
#pragma unroll
  for (int j = 0; j < SRT_WC_RPT; ++j)
    o[j] = run < nruns ? srt_off(offsets, rows, nch, run * SRT_WC_ROWS + tid + j * SRT_WC_THREADS)
                       : 0;
  if (tid == 0 && run < nruns) oe = srt_off(offsets, rows, nch, run * SRT_WC_ROWS + SRT_WC_ROWS);
  if (tid == 0) s_st[SRT_WC_PIECE] = s_nsp[SRT_WC_PIECE] = 0u;
  for (; run < nruns; run += gridDim.x) {
#pragma unroll
    for (int j = 0; j < SRT_WC_RPT; ++j) s_off[tid + j * SRT_WC_THREADS] = o[j];
    if (tid == 0) s_off[SRT_WC_ROWS] = oe;
    __syncthreads();
    const long long next = run + gridDim.x;
    if (next < nruns) {  // the next run's offsets load while this one counts
#pragma unroll
      for (int j = 0; j < SRT_WC_RPT; ++j)
        o[j] = srt_off(offsets, rows, nch, next * SRT_WC_ROWS + tid + j * SRT_WC_THREADS);
      if (tid == 0) oe = srt_off(offsets, rows, nch, next * SRT_WC_ROWS + SRT_WC_ROWS);
    }
    const int lo = s_off[0], hi = s_off[SRT_WC_ROWS];
    int rs[SRT_WC_RPT], re[SRT_WC_RPT], cnt[SRT_WC_RPT];  // this thread's rows
#pragma unroll
    for (int j = 0; j < SRT_WC_RPT; ++j) {
      rs[j] = s_off[tid + j * SRT_WC_THREADS];
      re[j] = s_off[tid + j * SRT_WC_THREADS + 1];
      cnt[j] = 0;
    }
    // the run's 32-byte segments [g0, g1), SRT_WC_PIECE a piece
    const int g0 = lo >> 5, g1 = (int)(((long long)hi + 31) >> 5);
    for (int piece = g0; piece < g1; piece += SRT_WC_PIECE) {
      // 1. each segment's word starts (global predecessor) and their count
      uint4 v[SRT_WC_SPT][2];
      unsigned pb[SRT_WC_SPT];
#pragma unroll
      for (int i = 0; i < SRT_WC_SPT; ++i)
        srt_load_segment(chars, piece + tid + i * SRT_WC_THREADS, g0, g1, hi, lane, v[i], pb[i]);
#pragma unroll
      for (int i = 0; i < SRT_WC_SPT; ++i) {
        const unsigned sp = srt_ws8(v[i][0].x, v[i][0].y) | (srt_ws8(v[i][0].z, v[i][0].w) << 8) |
                            (srt_ws8(v[i][1].x, v[i][1].y) << 16) |
                            (srt_ws8(v[i][1].z, v[i][1].w) << 24);
        unsigned prev = __shfl_up_sync(0xFFFFFFFFu, sp >> 31, 1);
        if (lane == 0) prev = srt_is_space(pb[i]);
        const bool in = piece + tid + i * SRT_WC_THREADS < g1;
        const unsigned nsp = in ? ~sp : 0u;
        const unsigned st = nsp & ((sp << 1) | prev);
        s_st[tid + i * SRT_WC_THREADS] = st;
        s_nsp[tid + i * SRT_WC_THREADS] = nsp;
        s_pre[tid + i * SRT_WC_THREADS] = __popc(st);
      }
      __syncthreads();
      // 2. exclusive prefix sum of the counts: thread t owns segments
      // [t * SRT_WC_SPT, (t + 1) * SRT_WC_SPT)
      unsigned c[SRT_WC_SPT], tsum = 0u;
#pragma unroll
      for (int i = 0; i < SRT_WC_SPT; ++i) {
        c[i] = tsum;
        tsum += s_pre[tid * SRT_WC_SPT + i];
      }
      unsigned x = tsum;  // inclusive scan over the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) s_wsum[warp] = x;
      __syncthreads();
      if (warp == 0) {
        const unsigned w = lane < SRT_WC_WARPS ? s_wsum[lane] : 0u;
        unsigned wx = w;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned y = __shfl_up_sync(0xFFFFFFFFu, wx, d);
          if (lane >= d) wx += y;
        }
        if (lane < SRT_WC_WARPS) s_wsum[lane] = wx - w;
      }
      __syncthreads();
      const unsigned base = s_wsum[warp] + x - tsum;
#pragma unroll
      for (int i = 0; i < SRT_WC_SPT; ++i) s_pre[tid * SRT_WC_SPT + i] = base + c[i];
      if (tid == SRT_WC_THREADS - 1) s_pre[SRT_WC_PIECE] = base + tsum;
      __syncthreads();
      // 3. each row's starts in this piece: C(b) - C(a), C(x) the starts
      // before byte x; the row's first byte starts a word if not a space
      const int P0 = piece * 32;
      const int P1 = (piece + SRT_WC_PIECE < g1 ? piece + SRT_WC_PIECE : g1) * 32;
#pragma unroll
      for (int j = 0; j < SRT_WC_RPT; ++j) {
        const int a = rs[j] > P0 ? rs[j] : P0, b = re[j] < P1 ? re[j] : P1;
        if (a < b) {
          const int ra = (a - P0) >> 5, rb = (b - P0) >> 5;
          const unsigned ma = (1u << (a & 31)) - 1u, mb = (1u << (b & 31)) - 1u;
          cnt[j] += (int)(s_pre[rb] + __popc(s_st[rb] & mb)) -
                    (int)(s_pre[ra] + __popc(s_st[ra] & ma));
          if (rs[j] >= P0)  // the row starts in this piece, at bit a & 31 of segment ra
            cnt[j] += (int)((s_nsp[ra] & ~s_st[ra]) >> (a & 31)) & 1;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < SRT_WC_RPT; ++j) {
      const long long r = run * SRT_WC_ROWS + tid + j * SRT_WC_THREADS;
      if (r < rows) out[r] = cnt[j];
    }
    __syncthreads();  // every thread has read this run's offsets
  }
}

extern "C" {

// One block per run of rows, at most as many as the card holds at once
// (the occupancy query, made once); returns the launch's cudaError_t.
int srt_word_counts(const int* offsets, long long rows, const void* chars, long long nch,
                    int* out, void* stream) {
  static int resident = 0;  // blocks the card holds at once
  if (rows <= 0) return (int)cudaSuccess;
  if (nch < 0 || nch > 0x7FFFFFFFLL - 4096) return (int)cudaErrorInvalidValue;
  if (resident == 0) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, word_counts_kernel,
                                                                  SRT_WC_THREADS, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return (int)e;
    }
    resident = (per_sm < 1 ? 1 : per_sm) * sms;  // past 1 the launch reports what does not fit
  }
  long long grid = resident;
  const long long nruns = (rows + SRT_WC_ROWS - 1) / SRT_WC_ROWS;
  if (nruns < grid) grid = nruns;
  word_counts_kernel<<<(unsigned)grid, SRT_WC_THREADS, 0, (cudaStream_t)stream>>>(
      offsets, rows, (const unsigned char*)chars, (int)nch, out);
  return (int)cudaGetLastError();
}

const char* srt_udf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
