// Hand-written Hopper (sm_90a) kernels for the hash-groupby update.
//
// Counterparts of the Pallas TPU kernels in spark_rapids_tpu/ops/pallas_groupby.py.
// Each kernel computes what the entry function of its TPU kernel computes;
// it does not copy the TPU's limb/one-hot blocks, which exist there only
// to feed the matrix unit:
//
//   K1 srt_bucket_sum      <- _sum_kernel    (pallas_bucket_reduce int/count cols)
//   K2 srt_bucket_fsum     <- _float_kernel  (pallas_bucket_reduce float cols)
//   K3 srt_bucket_winner   <- _winner_kernel (pallas_bucket_winner)
//   srt_ordered_segment_sum: the order-preserving exact float sum that
//      replaces XLA's serial segment_sum scatter (ops/groupby.py fsum_exact
//      and the sort fallback); no Pallas kernel exists for it.
//
// What bounds K1-K3 on an H100: bytes. Each reads its input stream once
// (seg int32 + the value and validity planes) and writes B x columns x 8
// bytes; there is no arithmetic to speak of. The design keeps the bucket
// table out of device memory while the stream passes: each block
// accumulates into a private copy in shared memory and flushes it once
// with global atomics, so the 2^26-row bench query with 64 groups does
// not serialize on 64 global addresses. K1 plans its table to fit (see
// its section); K2 accumulates with global atomics directly when
// B x columns x 8 bytes exceed 227 KB, K3 when B x 8 bytes do: a branch
// chosen by size, not a fallback. The ordered segment sum is bound by its
// chain of dependent f64 adds (see its section).
//
// Contract shared by all: rows with seg < 0 or seg >= B (dead rows,
// padding at seg == B) drop out. The kernels allocate nothing and never
// synchronize; outputs are pre-filled by the caller (zeros, or the
// winner's identity), except K2's, which its entry point zeroes on the
// stream. Every entry point returns the launch's cudaError_t, including a
// refused shared-memory request.

#include <cuda_runtime.h>
#include <stdint.h>

#define SRT_MAXC 16

struct SumCols {
  const long long* data[SRT_MAXC];
  const bool* valid[SRT_MAXC];
};

struct FloatCols {
  const double* data[SRT_MAXC];
  const bool* valid[SRT_MAXC];
};

static int srt_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// A runtime call failed before the launch: clear it from cudaGetLastError
// (so the next launch does not report it) and return it.
static int srt_fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

// ---------------------------------------------------------------------------
// K1: exact int64 sums (mod 2^64, Java wraparound) and counts per bucket.
// out is (L, B) row-major, L = nint + ncnt: column c's B sums are
// contiguous.
//
// Design for the H100:
//  * The table stays in shared memory: int sums as u64, counts as u32 (a
//    launch takes fewer than 2^27 rows, so a block's count cannot wrap;
//    counts widen to u64 when flushed). Q4's B = 8192 with one sum and
//    four counts is 192 KB, within the 227 KB a block may opt into.
//  * Passes: the wrapper plans the launch's columns into contiguous
//    passes whose tables each fit (ops/groupby_kernels.plan_bucket_sum);
//    blockIdx.y is the pass, so one launch runs them all and each pass
//    re-reads only seg and its own columns. A column whose table alone
//    exceeds the budget (one u64 column past 29,056 buckets) accumulates
//    with global atomics in its pass: a branch chosen by size.
//  * Atomics: a valid row adds with one native 32-bit shared atomic (a
//    count) or two (a sum: a 64-bit shared atomic add is a compare-and-
//    swap loop on sm_90, ATOMS.CAST.SPIN.64, so the u64 is added as two
//    32-bit words with the carry, k1_add_u64). The card combines adds to
//    one address within a warp: warp aggregation (__match_any_sync, or a
//    whole-warp sum for a warp on one bucket) measured slower at every
//    shape tried, a one-bucket input included.
//  * Bytes in flight: each thread takes four consecutive rows at a time
//    with 16-byte loads (int4 of seg, two longlong2 of data) and one
//    32-bit load of four validity bytes per column. Seg, the first
//    K1_PREFETCH columns' validity words and the first int column's
//    values are issued before the first is used, and an int column's
//    values load one column ahead; unaligned planes and the ragged tail
//    take scalar loads. 1024 threads a block, so at most 64 registers each: more
//    columns ahead spill. The grid is one wave at the occupancy the table
//    leaves.
// ---------------------------------------------------------------------------
#define K1_THREADS 1024
#define K1_PREFETCH 2  // columns whose validity words load ahead of use

struct SumPlan {
  int lo[SRT_MAXC + 1];  // pass p covers columns [lo[p], lo[p + 1])
  unsigned global_mask;  // bit p: pass p accumulates in device memory
};

// Four rows' validity bytes as one word (byte j = row r0 + j), and four
// rows' int64 values: one 32-bit or two 16-byte loads when the quad is
// whole and aligned, else per row with the rows past n left 0.
__device__ __forceinline__ unsigned load_valid4(const bool* __restrict__ v, long long r0,
                                                long long n, bool full) {
  if (full) return __ldg(reinterpret_cast<const unsigned*>(v + r0));
  unsigned w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (r0 + j < n) w |= (v[r0 + j] ? 1u : 0u) << (8 * j);
  return w;
}

__device__ __forceinline__ void load_data4(const long long* __restrict__ d, long long r0,
                                           long long n, bool full,
                                           unsigned long long (&x)[4]) {
  if (full) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(d + r0));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(d + r0 + 2));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = r0 + j < n ? (unsigned long long)__ldg(d + r0 + j) : 0ULL;
  }
}

// x added to a u64 table entry, mod 2^64. A 64-bit atomic add on shared
// memory is a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN.64), so
// there it is two native 32-bit adds: the low word's old value gives the
// carry into the high word, and a high word of 0 (a small value, or a
// small negative one that carries) is not added. Exact: the table is read
// only after the block's last add.
template <bool SMEM>
__device__ __forceinline__ void k1_add_u64(unsigned long long* a, unsigned long long x) {
  if (SMEM) {
    unsigned* h = reinterpret_cast<unsigned*>(a);
    const unsigned lo = (unsigned)x;
    const unsigned old = atomicAdd(h, lo);
    const unsigned hi = (unsigned)(x >> 32) + (old + lo < old ? 1u : 0u);
    if (hi != 0u) atomicAdd(h + 1, hi);
  } else {
    atomicAdd(a, x);
  }
}

// One int column's four rows into the table, one atomic per valid row.
template <bool SMEM>
__device__ __forceinline__ void k1_add_ints(unsigned long long* sums, const int (&s)[4],
                                            unsigned vw, const unsigned long long (&x)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (s[j] >= 0 && ((vw >> (8 * j)) & 0xFFu) && x[j] != 0ULL) k1_add_u64<SMEM>(sums + s[j], x[j]);
}

// One count column's four rows.
template <bool SMEM>
__device__ __forceinline__ void k1_add_counts(unsigned* cnt32, unsigned long long* cnt64,
                                              const int (&s)[4], unsigned vw) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (s[j] >= 0 && ((vw >> (8 * j)) & 0xFFu)) {
      if (SMEM) atomicAdd(cnt32 + s[j], 1u);
      else atomicAdd(cnt64 + s[j], 1ULL);
    }
  }
}

template <bool SMEM>
__device__ __forceinline__ void bucket_sum_pass(const int* __restrict__ seg, long long n,
                                                int B, int nint, int c0, int c1,
                                                const SumCols& cols, bool vec,
                                                unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  const int i0 = c0, ni = max(0, min(c1, nint) - c0);  // int columns [i0, i0 + ni)
  const int k0 = max(c0, nint), nk = max(0, c1 - k0);  // count columns [k0, k0 + nk)
  const int L = ni + nk;  // the pass's columns: c0 + [0, L)
  unsigned long long* sums = SMEM ? (unsigned long long*)k1_smem : out + (long long)i0 * B;
  unsigned* cnt32 = (unsigned*)(k1_smem + (size_t)ni * B * sizeof(unsigned long long));
  unsigned long long* cnt64 = out + (long long)k0 * B;
  if (SMEM) {
    const int words = (ni * B * 8 + nk * B * 4) / 4;
    for (int i = threadIdx.x; i < words; i += blockDim.x) ((unsigned*)k1_smem)[i] = 0u;
    __syncthreads();
  }
  const long long nq = (n + 3) >> 2;  // quads of four rows
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < nq; q += stride) {
    const long long r0 = q * 4;
    const bool full = vec && r0 + 3 < n;
    // issued before the first is used: seg, the validity words of the
    // first K1_PREFETCH columns (loops unrolled so vw stays in registers)
    // and the first int column's values
    int s[4];
    if (full) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(seg + r0));
      s[0] = t.x; s[1] = t.y; s[2] = t.z; s[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = r0 + j < n ? __ldg(seg + r0 + j) : -1;
    }
    unsigned vw[K1_PREFETCH > 0 ? K1_PREFETCH : 1];
#pragma unroll
    for (int c = 0; c < K1_PREFETCH; ++c)
      vw[c] = c < L ? load_valid4(cols.valid[c0 + c], r0, n, full) : 0u;
    unsigned long long x[4] = {0ULL, 0ULL, 0ULL, 0ULL};
    if (ni > 0) load_data4(cols.data[i0], r0, n, full, x);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (s[j] < 0 || s[j] >= B) s[j] = -1;
    unsigned long long xn[4] = {0ULL, 0ULL, 0ULL, 0ULL};
#pragma unroll
    for (int c = 0; c < K1_PREFETCH; ++c) {
      if (c < ni) {
        if (c + 1 < ni) load_data4(cols.data[i0 + c + 1], r0, n, full, xn);
        k1_add_ints<SMEM>(sums + (long long)c * B, s, vw[c], x);
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = xn[j];
      }
    }
    for (int c = K1_PREFETCH; c < ni; ++c) {
      if (c + 1 < ni) load_data4(cols.data[i0 + c + 1], r0, n, full, xn);
      const unsigned v = load_valid4(cols.valid[c0 + c], r0, n, full);
      k1_add_ints<SMEM>(sums + (long long)c * B, s, v, x);
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = xn[j];
    }
#pragma unroll
    for (int c = 0; c < K1_PREFETCH; ++c)
      if (c >= ni && c < L)
        k1_add_counts<SMEM>(cnt32 + (c - ni) * B, cnt64 + (long long)(c - ni) * B, s, vw[c]);
    for (int c = max(ni, K1_PREFETCH); c < L; ++c)
      k1_add_counts<SMEM>(cnt32 + (c - ni) * B, cnt64 + (long long)(c - ni) * B, s,
                          load_valid4(cols.valid[c0 + c], r0, n, full));
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < ni * B; i += blockDim.x) {
      const unsigned long long w = sums[i];
      if (w != 0ULL) atomicAdd(out + (long long)i0 * B + i, w);
    }
    for (int i = threadIdx.x; i < nk * B; i += blockDim.x) {
      const unsigned w = cnt32[i];
      if (w != 0u) atomicAdd(cnt64 + i, (unsigned long long)w);
    }
  }
}

__global__ void __launch_bounds__(K1_THREADS, 1)
    bucket_sum_kernel(const int* __restrict__ seg, long long n, int B, int nint,
                      SumCols cols, SumPlan plan, int vec,
                      unsigned long long* __restrict__ out) {
  const int p = blockIdx.y;
  if ((plan.global_mask >> p) & 1u)
    bucket_sum_pass<false>(seg, n, B, nint, plan.lo[p], plan.lo[p + 1], cols, vec != 0, out);
  else
    bucket_sum_pass<true>(seg, n, B, nint, plan.lo[p], plan.lo[p + 1], cols, vec != 0, out);
}

extern "C" int srt_bucket_sum(const int* seg, long long n, int B, int nint, int ncnt,
                              const void* const* data, const void* const* valid,
                              const int* pass_lo, int npass, unsigned global_mask,
                              long long* out, void* stream) {
  const int L = nint + ncnt;
  if (L > SRT_MAXC || L <= 0 || nint < 0 || ncnt < 0 || B < 0 || npass <= 0 || npass > L ||
      pass_lo[0] != 0 || pass_lo[npass] != L)
    return (int)cudaErrorInvalidValue;
  SumCols cols;
  bool vec = ((uintptr_t)seg & 15u) == 0;
  for (int c = 0; c < nint; ++c) {
    cols.data[c] = (const long long*)data[c];
    vec = vec && ((uintptr_t)data[c] & 15u) == 0;
  }
  for (int c = 0; c < L; ++c) {
    cols.valid[c] = (const bool*)valid[c];
    vec = vec && ((uintptr_t)valid[c] & 3u) == 0;
  }
  SumPlan plan;
  plan.global_mask = global_mask;
  size_t smem = 0;
  for (int p = 0; p <= npass; ++p) plan.lo[p] = pass_lo[p];
  for (int p = 0; p < npass; ++p) {
    const int lo = pass_lo[p], hi = pass_lo[p + 1];
    if (hi <= lo) return (int)cudaErrorInvalidValue;
    if ((global_mask >> p) & 1u) continue;
    const int ni = lo < nint ? (hi < nint ? hi : nint) - lo : 0;
    const size_t bytes = (size_t)B * (8 * ni + 4 * (hi - lo - ni));
    if (bytes > smem) smem = bytes;
  }
  cudaError_t e = cudaFuncSetAttribute(bucket_sum_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return srt_fail(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_sum_kernel, K1_THREADS,
                                                    smem);
  if (e != cudaSuccess) return srt_fail(e);
  if (per_sm < 1) per_sm = 1;  // the launch then reports what does not fit
  long long gx = (long long)per_sm * srt_sm_count() / npass;
  const long long need = ((n + 3) / 4 + K1_THREADS - 1) / K1_THREADS;
  if (need < gx) gx = need;
  if (gx < 1) gx = 1;
  bucket_sum_kernel<<<dim3((unsigned)gx, (unsigned)npass), K1_THREADS, smem,
                      (cudaStream_t)stream>>>(seg, n, B, nint, cols, plan, vec ? 1 : 0,
                                              (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: f64 sums per bucket. Order is run-dependent: the order-insensitive
// variableFloatAgg family, as the reference's f32 hi/lo kernel is. NaN/inf
// stay in their own bucket by construction. out is (B, F) row-major.
//
// Design for the H100:
//  * Bytes in flight, as K3: 1024-thread blocks, four consecutive rows per
//    thread, seg as one int4 and each column's four validity bytes as one
//    u32 (the next quad's seg and first validity word load while this
//    quad's values do), the values as two double2 loads issued whatever
//    seg and validity say, so they do not wait on them: that reads the
//    value planes whole, and measured faster than loading only the pairs
//    a live valid row needs. Misaligned planes and the ragged tail go one
//    row at a time.
//  * No contended compare-and-swap loop: an f64 atomicAdd on shared memory
//    is a CAS loop on sm_90 (ATOMS.CAST.SPIN.64), and in the bench query
//    every block sends all its rows into the 64 live buckets of one table.
//    Each block therefore keeps `reps` replicas of the (B, F) table, warp w
//    adding into replica w % reps, so a retry mostly happens between lanes
//    of one warp on one address. The kernel's registers hold an SM to one
//    block, so the wrapper's planner (ops/groupby_kernels.plan_bucket_fsum)
//    gives it as many replicas as 227 KB holds, up to one per warp. At the
//    flush the replicas are summed in shared memory and each nonzero entry
//    goes out with one global f64 atomicAdd (NaN != 0.0, so NaN flushes).
//    Combining a warp's same-bucket adds first (__match_any_sync and a
//    shuffle tree) measured slower at the bench query's 64 live buckets and
//    was removed; it won only with every row in one bucket.
//  * A table that does not fit a block even once accumulates with global
//    atomics (native on sm_90): a branch chosen by size, by the planner.
// ---------------------------------------------------------------------------
#define K2_THREADS 1024

template <bool SMEM>
__global__ void __launch_bounds__(K2_THREADS)
    bucket_fsum_kernel(const int* __restrict__ seg, long long n, int B, int nf, FloatCols cols,
                       int reps, int vec, double* __restrict__ out) {
  extern __shared__ double k2_smem[];
  const int table = B * nf;
  double* acc = out;
  if (SMEM) {
    for (int i = threadIdx.x; i < reps * table; i += blockDim.x) k2_smem[i] = 0.0;
    __syncthreads();
    acc = k2_smem + (size_t)((threadIdx.x >> 5) % reps) * table;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nq = vec ? n >> 2 : 0;  // whole quads of four rows
  // seg and the first validity word of a thread's next quad load while
  // the current one's values do
  int4 tn = make_int4(-1, -1, -1, -1);
  unsigned vn = 0u;
  if (tid < nq) {
    tn = __ldg(reinterpret_cast<const int4*>(seg) + tid);
    vn = __ldg(reinterpret_cast<const unsigned*>(cols.valid[0]) + tid);
  }
  // warp-uniform loops (q runs over the warp's quads): measured faster than
  // a per-thread loop over the same quads
  const long long wtid = tid & ~31LL;
  for (long long qw = wtid; qw < nq; qw += stride) {
    const long long q = tid - wtid + qw;
    const bool live = q < nq;
    const long long r0 = q * 4;
    const int4 t = tn;
    unsigned vw = vn;
    if (q + stride < nq) {
      tn = __ldg(reinterpret_cast<const int4*>(seg) + q + stride);
      vn = __ldg(reinterpret_cast<const unsigned*>(cols.valid[0]) + q + stride);
    }
    const int s[4] = {t.x, t.y, t.z, t.w};
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = live && (unsigned)s[j] < (unsigned)B;
    for (int c = 0; c < nf; ++c) {
      if (c > 0 && live) vw = __ldg(reinterpret_cast<const unsigned*>(cols.valid[c]) + q);
      bool use[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) use[j] = ok[j] && ((vw >> (8 * j)) & 0xFFu);
      // both value pairs load whatever seg and validity say, so the loads
      // do not wait on them
      double2 a = make_double2(0.0, 0.0), b = a;
      if (live) {
        a = __ldg(reinterpret_cast<const double2*>(cols.data[c] + r0));
        b = __ldg(reinterpret_cast<const double2*>(cols.data[c] + r0 + 2));
      }
      const double x[4] = {a.x, a.y, b.x, b.y};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (use[j]) atomicAdd(acc + (long long)s[j] * nf + c, x[j]);
    }
  }
  for (long long rw = nq * 4 + wtid; rw < n; rw += stride) {  // the tail
    const long long r = tid - wtid + rw;
    const int s = r < n ? seg[r] : -1;
    const bool ok = (unsigned)s < (unsigned)B;
    for (int c = 0; c < nf; ++c) {
      const bool use = ok && cols.valid[c][r];
      if (use) atomicAdd(acc + (long long)s * nf + c, cols.data[c][r]);
    }
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < table; i += blockDim.x) {
      double v = 0.0;
      for (int k = 0; k < reps; ++k) v += k2_smem[(size_t)k * table + i];
      if (v != 0.0) atomicAdd(out + i, v);  // NaN != 0.0, so NaN flushes
    }
  }
}

template <bool SMEM>
static int k2_launch(const int* seg, long long n, int B, int nf, const FloatCols& cols,
                     int reps, int vec, double* out, cudaStream_t st) {
  void (*kern)(const int*, long long, int, int, FloatCols, int, int, double*) =
      bucket_fsum_kernel<SMEM>;
  // the shared-memory opt-in and the occupancy query, made once per size
  static size_t opted = 0, queried = (size_t)-1;
  static int per_sm = 0;
  const size_t smem = SMEM ? (size_t)reps * B * nf * sizeof(double) : 0;
  cudaError_t e;
  if (smem > opted) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return srt_fail(e);
    opted = smem;
  }
  if (smem != queried) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, K2_THREADS, smem);
    if (e != cudaSuccess) return srt_fail(e);
    if (per_sm < 1) per_sm = 1;  // the launch then reports what does not fit
    queried = smem;
  }
  long long grid = (long long)per_sm * srt_sm_count();
  const long long need = ((n + 3) / 4 + K2_THREADS - 1) / K2_THREADS;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;
  kern<<<(unsigned)grid, K2_THREADS, smem, st>>>(seg, n, B, nf, cols, reps, vec, out);
  return (int)cudaGetLastError();
}

// reps: the wrapper's plan (ops/groupby_kernels.plan_bucket_fsum), the
// shared-memory replicas of the table per block, 0 for global atomics.
// out need not be zeroed: the entry point zeroes it on the stream.
extern "C" int srt_bucket_fsum(const int* seg, long long n, int B, int nf,
                               const void* const* data, const void* const* valid, int reps,
                               double* out, void* stream) {
  if (nf > SRT_MAXC || nf <= 0 || B < 0 || reps < 0 || reps > K2_THREADS / 32)
    return (int)cudaErrorInvalidValue;
  FloatCols cols;
  int vec = ((uintptr_t)seg & 15u) == 0;
  for (int c = 0; c < nf; ++c) {
    cols.data[c] = (const double*)data[c];
    cols.valid[c] = (const bool*)valid[c];
    vec = vec && ((uintptr_t)data[c] & 15u) == 0 && ((uintptr_t)valid[c] & 3u) == 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  // out starts at zero: the blocks add into it
  const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * nf * sizeof(double), st);
  if (e != cudaSuccess) return srt_fail(e);
  if (reps > 0) return k2_launch<true>(seg, n, B, nf, cols, reps, vec, out, st);
  return k2_launch<false>(seg, n, B, nf, cols, 0, vec, out, st);
}

// ---------------------------------------------------------------------------
// K3: per-bucket lexicographic min or max of the (hi, lo) u32 word pair,
// packed as one u64 word hi<<32|lo: the lexicographic order of the pair is
// the unsigned order of the packed word, so one 64-bit atomicMin/atomicMax
// decides it. Excluded rows carry the identity (all ones for min, 0 for
// max) and are skipped; out is pre-filled with the identity, so empty
// buckets return it.
//
// Design for the H100:
//  * Bytes in flight: each thread takes four consecutive rows at a time,
//    seg as one int4 and the words as two longlong2, a pair's load issued
//    only where one of its rows is in range, every load before the first
//    compare; the next quad's seg loads while this quad's words do. The
//    ragged tail (n % 4, or every row when a plane is not 16-byte
//    aligned) goes one row at a time. Loading every pair whatever seg
//    says measured no faster.
//  * The table stays in shared memory up to the 227 KB a block may opt
//    into (29 056 buckets); larger B accumulates with global atomics: a
//    branch chosen by size, by the wrapper's planner. A table the card
//    refuses surfaces as the launch's error.
//  * The CAS loop: a 64-bit shared atomicMin/Max is a compare-and-swap
//    loop on sm_90 (ATOMS.CAST.SPIN.64). A plain read of the running
//    winner first skips every row that cannot improve it (min and max
//    are idempotent, so a stale read only costs an atomic). A per-thread
//    running winner over the four rows before the atomic measured no
//    faster at B = 128 or 8192.
//  * 1024-thread blocks, as many per SM as the table leaves room for, in
//    one wave.
// ---------------------------------------------------------------------------
#define K3_THREADS 1024

template <bool MIN>
__device__ __forceinline__ void k3_update(unsigned long long* w, int s, unsigned long long v) {
  // a plain read first: most rows cannot improve the running winner
  if (MIN) {
    if (v < w[s]) atomicMin(w + s, v);
  } else {
    if (v > w[s]) atomicMax(w + s, v);
  }
}

template <bool SMEM, bool MIN>
__global__ void __launch_bounds__(K3_THREADS)
    bucket_winner_kernel(const int* __restrict__ seg, long long n, int B,
                         const unsigned long long* __restrict__ word, int vec,
                         unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long swin[];
  const unsigned long long ident = MIN ? ~0ULL : 0ULL;
  unsigned long long* w = SMEM ? swin : out;
  if (SMEM) {
    for (int i = threadIdx.x; i < B; i += blockDim.x) swin[i] = ident;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nq = vec ? n >> 2 : 0;  // whole quads of four rows
  // seg of a thread's next quad loads while the current one's words do
  int4 tn = make_int4(-1, -1, -1, -1);
  if (tid < nq) tn = __ldg(reinterpret_cast<const int4*>(seg) + tid);
  for (long long q = tid; q < nq; q += stride) {
    const long long r0 = q * 4;
    const int4 t = tn;
    if (q + stride < nq) tn = __ldg(reinterpret_cast<const int4*>(seg) + q + stride);
    int s[4] = {t.x, t.y, t.z, t.w};
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = (unsigned)s[j] < (unsigned)B;
    longlong2 a = make_longlong2((long long)ident, (long long)ident), b = a;
    if (ok[0] || ok[1]) a = __ldg(reinterpret_cast<const longlong2*>(word + r0));
    if (ok[2] || ok[3]) b = __ldg(reinterpret_cast<const longlong2*>(word + r0 + 2));
    unsigned long long v[4] = {(unsigned long long)a.x, (unsigned long long)a.y,
                               (unsigned long long)b.x, (unsigned long long)b.y};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ok[j] && v[j] != ident) k3_update<MIN>(w, s[j], v[j]);
  }
  for (long long r = nq * 4 + tid; r < n; r += stride) {  // the tail
    const int s = seg[r];
    if ((unsigned)s >= (unsigned)B) continue;
    const unsigned long long v = word[r];
    if (v != ident) k3_update<MIN>(w, s, v);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < B; i += blockDim.x) {
      const unsigned long long v = swin[i];
      if (v == ident) continue;
      if (MIN) atomicMin(out + i, v);
      else atomicMax(out + i, v);
    }
  }
}

template <bool SMEM, bool MIN>
static int k3_launch(const int* seg, long long n, int B, const unsigned long long* word,
                     unsigned long long* out, cudaStream_t st) {
  void (*kern)(const int*, long long, int, const unsigned long long*, int,
               unsigned long long*) = bucket_winner_kernel<SMEM, MIN>;
  const size_t smem = SMEM ? (size_t)B * sizeof(unsigned long long) : 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return srt_fail(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, K3_THREADS, smem);
  if (e != cudaSuccess) return srt_fail(e);
  if (per_sm < 1) per_sm = 1;  // the launch then reports what does not fit
  long long grid = (long long)per_sm * srt_sm_count();
  const long long need = ((n + 3) / 4 + K3_THREADS - 1) / K3_THREADS;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;
  const int vec = ((uintptr_t)seg & 15u) == 0 && ((uintptr_t)word & 15u) == 0 ? 1 : 0;
  kern<<<(unsigned)grid, K3_THREADS, smem, st>>>(seg, n, B, word, vec, out);
  return (int)cudaGetLastError();
}

// shared: the wrapper's plan (ops/groupby_kernels.plan_bucket_winner),
// 1 for a table in shared memory, 0 for global atomics.
extern "C" int srt_bucket_winner(const int* seg, long long n, int B, int is_min,
                                 const long long* word, int shared, long long* out,
                                 void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned long long* w = (const unsigned long long*)word;
  unsigned long long* o = (unsigned long long*)out;
  if (shared)
    return is_min ? k3_launch<true, true>(seg, n, B, w, o, st)
                  : k3_launch<true, false>(seg, n, B, w, o, st);
  return is_min ? k3_launch<false, true>(seg, n, B, w, o, st)
                : k3_launch<false, false>(seg, n, B, w, o, st);
}

// ---------------------------------------------------------------------------
// Ordered segment sum: rows arrive sorted by segment (a stable sort keeps
// row order inside each segment); each segment is summed serially in row
// order from 0.0, so the result is the serial row-order sum — exact-mode
// float sums stay order-preserving and deterministic, which atomics and
// tree reductions are not. bounds has nseg + 1 entries: segment s is
// [bounds[s], bounds[s+1]).
//
// What bounds it: the chain of dependent f64 adds of the longest segment
// (its length x the card's DADD latency), not bytes. No reduction that
// splits a segment keeps the serial result, so a segment holding most of
// the rows is bound by its own chain. The design keeps that chain fed:
// one warp per segment, so the segments run on warps spread over the SMs;
// the warp streams its segment in chunks of 256 rows with coalesced
// 16-byte loads, OSS_DEPTH chunks in flight in registers, stages each
// chunk in shared memory, and lane 0 folds it into the accumulator in row
// order while the next chunks' loads are outstanding.
// ---------------------------------------------------------------------------
#define OSS_WARPS 4  // segments (warps) per block
#define OSS_PAIRS 4  // 16-byte pairs per lane per chunk
#define OSS_DEPTH 3  // chunks in flight per warp
#define OSS_CHUNK (32 * OSS_PAIRS * 2)  // rows per chunk

// chunk k of a segment covers rows [base + k * OSS_CHUNK, ...); base is
// even, so with vals 16-byte aligned every pair is one aligned load. Rows
// at or past hi are not read; rows before lo are read and not folded.
__device__ __forceinline__ void oss_load(const double* __restrict__ vals, long long first,
                                         long long hi, bool vec, unsigned lane,
                                         double2 (&r)[OSS_PAIRS]) {
  if (vec && first + OSS_CHUNK <= hi) {  // a whole chunk: no per-pair test
#pragma unroll
    for (int i = 0; i < OSS_PAIRS; ++i)
      r[i] = __ldcs(reinterpret_cast<const double2*>(vals + first) + i * 32 + lane);
    return;
  }
#pragma unroll
  for (int i = 0; i < OSS_PAIRS; ++i) {
    const long long row = first + 2 * (i * 32 + (int)lane);
    if (vec && row + 1 < hi) {
      r[i] = __ldcs(reinterpret_cast<const double2*>(vals + row));
    } else {
      r[i].x = row < hi ? vals[row] : 0.0;
      r[i].y = row + 1 < hi ? vals[row + 1] : 0.0;
    }
  }
}

__global__ void __launch_bounds__(OSS_WARPS * 32)
    ordered_segment_sum_kernel(const double* __restrict__ vals,
                               const long long* __restrict__ bounds, int nseg, int vec,
                               double* __restrict__ out) {
  __shared__ __align__(16) double stage[OSS_WARPS][OSS_CHUNK];
  const unsigned lane = threadIdx.x & 31u;
  const int s = blockIdx.x * OSS_WARPS + (int)(threadIdx.x >> 5);
  if (s >= nseg) return;  // warp-uniform
  const long long lo = bounds[s], hi = bounds[s + 1];
  const long long base = lo & ~1LL;
  const long long nchunks = hi > lo ? (hi - base + OSS_CHUNK - 1) / OSS_CHUNK : 0;
  double* buf = stage[threadIdx.x >> 5];
  double2* buf2 = reinterpret_cast<double2*>(buf);
  double2 r[OSS_DEPTH][OSS_PAIRS];
#pragma unroll
  for (int d = 0; d < OSS_DEPTH; ++d)
    if (d < nchunks) oss_load(vals, base + (long long)d * OSS_CHUNK, hi, vec != 0, lane, r[d]);
  double acc = 0.0;
  for (long long k = 0; k < nchunks; k += OSS_DEPTH) {
#pragma unroll
    for (int d = 0; d < OSS_DEPTH; ++d) {
      const long long kk = k + d;
      if (kk < nchunks) {
        __syncwarp();  // lane 0 has folded the chunk before
#pragma unroll
        for (int i = 0; i < OSS_PAIRS; ++i) buf2[i * 32 + lane] = r[d][i];
        __syncwarp();
        if (kk + OSS_DEPTH < nchunks)
          oss_load(vals, base + (kk + OSS_DEPTH) * OSS_CHUNK, hi, vec != 0, lane, r[d]);
        if (lane == 0) {
          const long long c0 = base + kk * OSS_CHUNK;
          if (c0 >= lo && c0 + OSS_CHUNK <= hi) {
#pragma unroll
            for (int j = 0; j < OSS_CHUNK; ++j) acc += buf[j];
          } else {
            const int j0 = (int)(lo > c0 ? lo - c0 : 0);
            const int j1 = (int)(hi - c0 < OSS_CHUNK ? hi - c0 : OSS_CHUNK);
            for (int j = j0; j < j1; ++j) acc += buf[j];
          }
        }
      }
    }
  }
  if (lane == 0) out[s] = acc;
}

extern "C" int srt_ordered_segment_sum(const double* vals, const long long* bounds,
                                       int nseg, double* out, void* stream) {
  if (nseg <= 0) return 0;
  const int vec = ((uintptr_t)vals & 15u) == 0 ? 1 : 0;
  ordered_segment_sum_kernel<<<(nseg + OSS_WARPS - 1) / OSS_WARPS, OSS_WARPS * 32, 0,
                               (cudaStream_t)stream>>>(vals, bounds, nseg, vec, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Probe (not a kernel of any path): one thread runs a dependent chain of
// nadds f64 adds in registers, so its time over nadds is the card's DADD
// latency, the floor of the ordered segment sum per row of its longest
// segment. x holds the start value and the two addends.
// ---------------------------------------------------------------------------
__global__ void dadd_chain_kernel(const double* __restrict__ x, long long nadds,
                                  double* __restrict__ out) {
  double a = x[0];
  const double b = x[1], c = x[2];
  for (long long i = 0; i < nadds; i += 2) {
    a += b;
    a += c;
  }
  out[0] = a;
}

extern "C" int srt_dadd_chain(const double* x, long long nadds, double* out, void* stream) {
  dadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(x, nadds, out);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
