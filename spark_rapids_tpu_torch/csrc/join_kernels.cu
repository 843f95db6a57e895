// Hand-written Hopper (sm_90a) kernel for the hash-join probe.
//
// K4 srt_probe_ranges <- _probe_kernel (spark_rapids_tpu/ops/pallas_join.py,
//    driver pallas_probe_ranges): the PALLAS tier of ops/join.probe_ranges.
//
// What it computes, per probe row i: the first index and the number of
// build rows in [0, build_count) whose key equals the probe's key, as
// lo = count > 0 ? first : 0 and hi = lo + count; a dead probe row
// (live[i] == 0) gives (0, 0). A key is one or two order-preserving u32
// radix words; both sides pack them into one u64 (hi << 32 | lo), whose
// unsigned order is the words' lexicographic order.
//
// Contract (the join exec guarantees it): build rows [0, build_count) are
// sorted ascending by their packed key, so equal keys are contiguous;
// rows past build_count are garbage and never read.
//
// The TPU kernel holds a (probe block x build tile) equality mask in VMEM
// and accumulates (min index, count) over build tiles: O(m * nb) compares.
// Here each probe looks its key up in the sorted build.
//
// What bounds it on an H100. The bytes the function needs are small (the
// probe's key words, liveness and two int32s out per row, the build once).
// A binary search over the build in L2 is bound instead by its ~log2(nb)
// dependent loads per row, and a search over a table of splitters in
// shared memory by its ~log2(nb / S) shared loads per row, which share the
// load/store pipe with the probe's own loads (measured: see PERF.md). The
// design replaces the search by one lookup:
//  * One launch, two phases split by a grid barrier (a cooperative launch,
//    so every block is resident). Phase 1 packs the live build prefix's
//    int64 words into u64 keys in a scratch array (no torch pass over the
//    build) and builds a bucket index beside it: the live keys' span
//    [kmin, kmax] cut into 2^r buckets of equal width (r from the
//    wrapper's planner ops/join_kernels.plan_probe), index[b] = the first
//    row whose key lies in bucket b or above. Rows are sorted, so bucket b
//    holds exactly the rows [index[b], index[b + 1]), and every key equal
//    to a probe's lies in the probe's own bucket.
//  * Phase 2: each block copies the index (2^15 + 1 u32, 128 KB at most)
//    into shared memory; a probe computes its bucket, reads its two bounds
//    there and counts the keys below and equal to its own among the
//    bucket's rows, read from L2 as aligned 16-byte pairs. A key outside
//    [kmin, kmax], or an empty bucket, reads nothing. The bench join's
//    2^17-row build of dense keys holds about 3 rows a bucket.
//  * A bucket of more than K4_FAST_ROWS rows (skewed keys: many rows of
//    one key, or a few far outliers) is searched in L2 instead: a binary
//    search for the first row >= the key and a gallop for the run's end.
//    That is slower, not different: the result is the same.
//  * Four probe rows per thread, loaded as 16-byte vectors.
//
// The kernel allocates nothing and never synchronizes with the host; the
// wrapper allocates the scratch keys and index and the zeroed barrier
// word. The entry point returns the launch's cudaError_t (a refused
// shared-memory request or an oversized cooperative grid included).

#include <cuda_runtime.h>
#include <stdint.h>

#define K4_THREADS 1024
#define K4_FAST_ROWS 8

typedef unsigned long long u64;

__device__ __forceinline__ u64 k4_pack(long long w0, long long w1, bool two) {
  const u64 k = (u64)w0 & 0xFFFFFFFFull;
  return two ? (k << 32) | ((u64)w1 & 0xFFFFFFFFull) : k;
}

// Every block of the (cooperative, all-resident) grid arrives before any
// leaves; *count starts at 0 and is used once. The fences make phase 1's
// stores visible to phase 2's plain loads.
__device__ __forceinline__ void k4_grid_sync(unsigned* count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (*(volatile unsigned*)count < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// The keys of rows [a, b) below and equal to k, b - a <= K4_FAST_ROWS:
// aligned 16-byte pairs, all issued before the first compare.
__device__ __forceinline__ void k4_count_rows(const u64* __restrict__ keys, int a, int b, u64 k,
                                              int& less, int& eq) {
  less = 0;
  eq = 0;
  const int p0 = a >> 1;
  const int np = ((b + 1) >> 1) - p0;  // pairs touching [a, b)
  ulonglong2 w[K4_FAST_ROWS / 2 + 1];
#pragma unroll
  for (int j = 0; j < K4_FAST_ROWS / 2 + 1; ++j)
    if (j < np) w[j] = reinterpret_cast<const ulonglong2*>(keys)[p0 + j];
#pragma unroll
  for (int j = 0; j < K4_FAST_ROWS / 2 + 1; ++j) {
    if (j < np) {
      const int r = 2 * (p0 + j);
      const bool in0 = r >= a && r < b, in1 = r + 1 >= a && r + 1 < b;
      less += (in0 && w[j].x < k) + (in1 && w[j].y < k);
      eq += (in0 && w[j].x == k) + (in1 && w[j].y == k);
    }
  }
}

// [first, end) of k's run among rows [a, b), by a binary search for the
// first row >= k and a gallop from it for the first row > k (a big bucket).
__device__ __forceinline__ void k4_search_rows(const u64* __restrict__ keys, int a, int b, u64 k,
                                               int& first, int& end) {
  int lo = a, hi = b;
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (keys[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  first = lo;
  if (lo >= b || keys[lo] != k) {
    end = lo;
    return;
  }
  lo = first + 1;
  hi = b;
  for (long long step = 1; first + step < b; step <<= 1) {
    const int at = (int)(first + step);
    if (keys[at] != k) {
      hi = at;
      break;
    }
    lo = at + 1;
  }
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (keys[mid] <= k) lo = mid + 1;
    else hi = mid;
  }
  end = lo;
}

__global__ void __launch_bounds__(K4_THREADS, 1)
    probe_ranges_kernel(const long long* __restrict__ pw0, const long long* __restrict__ pw1,
                        const bool* __restrict__ plive, long long m,
                        const long long* __restrict__ bw0, const long long* __restrict__ bw1,
                        long long nb, int nwords, const int* __restrict__ bcount_ptr,
                        long long bcount_val, int log2_buckets, u64* __restrict__ keys,
                        unsigned* __restrict__ index, unsigned* __restrict__ barrier, int vec,
                        int* __restrict__ out_lo, int* __restrict__ out_hi) {
  extern __shared__ __align__(16) unsigned k4_index[];
  const long long bc = bcount_ptr != nullptr ? (long long)__ldg(bcount_ptr) : bcount_val;
  const int n = (int)(bc < 0 ? 0 : (bc > nb ? nb : bc));
  const bool two = nwords == 2;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int buckets = 1 << log2_buckets;
  // the live keys' span, cut into buckets of 2^shift keys
  u64 kmin = 0, span = 0;
  int shift = 0;
  if (n > 0) {
    kmin = k4_pack(__ldg(bw0), two ? __ldg(bw1) : 0LL, two);
    span = k4_pack(__ldg(bw0 + n - 1), two ? __ldg(bw1 + n - 1) : 0LL, two) - kmin;
    const int bits = span == 0 ? 0 : 64 - __clzll((long long)span);
    shift = bits > log2_buckets ? bits - log2_buckets : 0;
  }
  const int last = (int)(span >> shift);  // the last key's bucket

  // phase 1: pack the live prefix; row i sets index[b] = i for the buckets
  // b in (bucket of row i - 1, bucket of row i]; buckets past the last
  // key's get n
  for (long long i = tid; i < n; i += nthreads) {
    const u64 key = k4_pack(__ldg(bw0 + i), two ? __ldg(bw1 + i) : 0LL, two);
    keys[i] = key;
    const int p = (int)((key - kmin) >> shift);
    const int prev =
        i == 0 ? -1
               : (int)((k4_pack(__ldg(bw0 + i - 1), two ? __ldg(bw1 + i - 1) : 0LL, two) - kmin) >>
                       shift);
    for (int b = prev + 1; b <= p; ++b) index[b] = (unsigned)i;
  }
  for (long long b = (n > 0 ? last + 1 : 0) + tid; b <= buckets; b += nthreads)
    index[b] = (unsigned)n;
  k4_grid_sync(barrier);

  // phase 2: the index into shared memory, then the probes
  for (int b = threadIdx.x; b <= buckets; b += blockDim.x) k4_index[b] = index[b];
  __syncthreads();
  const long long nq = (m + 3) >> 2;
  for (long long q = tid; q < nq; q += nthreads) {
    const long long r0 = q * 4;
    const bool full = vec && r0 + 3 < m;
    u64 k[4];
    bool lv[4];
    if (full) {
      const longlong2 a0 = __ldg(reinterpret_cast<const longlong2*>(pw0 + r0));
      const longlong2 a1 = __ldg(reinterpret_cast<const longlong2*>(pw0 + r0 + 2));
      long long x[4] = {a0.x, a0.y, a1.x, a1.y};
      long long y[4] = {0, 0, 0, 0};
      if (two) {
        const longlong2 b0 = __ldg(reinterpret_cast<const longlong2*>(pw1 + r0));
        const longlong2 b1 = __ldg(reinterpret_cast<const longlong2*>(pw1 + r0 + 2));
        y[0] = b0.x; y[1] = b0.y; y[2] = b1.x; y[3] = b1.y;
      }
      const unsigned lw = __ldg(reinterpret_cast<const unsigned*>(plive + r0));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        k[j] = k4_pack(x[j], y[j], two);
        lv[j] = ((lw >> (8 * j)) & 0xFFu) != 0u;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long r = r0 + j;
        lv[j] = r < m && plive[r];
        k[j] = r < m ? k4_pack(__ldg(pw0 + r), two ? __ldg(pw1 + r) : 0LL, two) : 0ULL;
      }
    }
    int lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const u64 off = k[j] - kmin;  // wraps for keys below kmin
      int a = 0, b = 0;
      if (lv[j] && n > 0 && off <= span) {
        const int p = (int)(off >> shift);
        a = (int)k4_index[p];
        b = (int)k4_index[p + 1];
      }
      int first = 0, cnt = 0;
      if (b - a > K4_FAST_ROWS) {
        int end;
        k4_search_rows(keys, a, b, k[j], first, end);
        cnt = end - first;
      } else if (b > a) {
        int less;
        k4_count_rows(keys, a, b, k[j], less, cnt);
        first = a + less;
      }
      lo[j] = cnt > 0 ? first : 0;
      hi[j] = cnt > 0 ? first + cnt : 0;
    }
    if (full) {
      *reinterpret_cast<int4*>(out_lo + r0) = make_int4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<int4*>(out_hi + r0) = make_int4(hi[0], hi[1], hi[2], hi[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r0 + j < m) {
          out_lo[r0 + j] = lo[j];
          out_hi[r0 + j] = hi[j];
        }
      }
    }
  }
}

static int k4_sm_count() {
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
static int k4_fail(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}

extern "C" {

// nwords: 1 or 2 key words (pw1 and bw1 are read only for 2). build_count
// is bcount_val, or when bcount_ptr is not NULL the device int32 there (a
// count that never left the device). log2_buckets: the planner's r (at
// most 15, a 128 KB index; a larger one is the card's to refuse); keys: a
// scratch array of nb + 2 u64 (16-byte aligned); index: a scratch array
// of 2^r + 1 u32; barrier: one zeroed u32.
int srt_probe_ranges(const void* pw0, const void* pw1, const void* plive, long long m,
                     const void* bw0, const void* bw1, long long nb, int nwords,
                     const void* bcount_ptr, long long bcount_val, int log2_buckets,
                     void* keys, void* index, void* barrier, void* out_lo, void* out_hi,
                     void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  if (log2_buckets < 1 || log2_buckets > 24 || nwords < 1 || nwords > 2 ||
      ((uintptr_t)keys & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (((size_t)1 << log2_buckets) + 1) * sizeof(unsigned);
  cudaError_t e = cudaFuncSetAttribute(probe_ranges_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return k4_fail(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_ranges_kernel, K4_THREADS,
                                                    smem);
  if (e != cudaSuccess) return k4_fail(e);
  if (per_sm < 1) per_sm = 1;  // the launch then reports what does not fit
  long long grid = (long long)per_sm * k4_sm_count();
  const long long need = ((m + 3) / 4 + K4_THREADS - 1) / K4_THREADS;
  if (need < grid) grid = need;
  if (grid < 1) grid = 1;
  int vec = ((uintptr_t)pw0 & 15u) == 0 && (nwords == 1 || ((uintptr_t)pw1 & 15u) == 0) &&
                    ((uintptr_t)plive & 3u) == 0 && ((uintptr_t)out_lo & 15u) == 0 &&
                    ((uintptr_t)out_hi & 15u) == 0
                ? 1
                : 0;
  void* args[] = {(void*)&pw0,        (void*)&pw1,          (void*)&plive,  (void*)&m,
                  (void*)&bw0,        (void*)&bw1,          (void*)&nb,     (void*)&nwords,
                  (void*)&bcount_ptr, (void*)&bcount_val,   (void*)&log2_buckets,
                  (void*)&keys,       (void*)&index,        (void*)&barrier, (void*)&vec,
                  (void*)&out_lo,     (void*)&out_hi};
  e = cudaLaunchCooperativeKernel((const void*)probe_ranges_kernel, dim3((unsigned)grid),
                                  dim3(K4_THREADS), args, smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return k4_fail(e);
  return (int)cudaGetLastError();
}

const char* srt_join_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
