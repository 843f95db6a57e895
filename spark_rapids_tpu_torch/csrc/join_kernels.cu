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
// Design: the TPU kernel holds a (probe block x build tile) equality mask
// in VMEM and accumulates (min index, count) over build tiles, which is
// O(m * nb) compares (about 1.1e12 at the bench shape, m = 2^23 probe
// rows against nb = 2^17 build rows). Here one thread per probe row runs
// a lower-bound binary search over the sorted build keys and, only when
// that lands on an equal key, a galloping upper-bound search from there
// (a key's run of duplicates is short: a unique key costs one more load,
// not a second full search): O(m log nb). The build keys (8 bytes x nb:
// 1 MB at the bench shape) stay in the 50 MB L2 after the first probes
// touch them.
//
// What bounds it on an H100: bytes. Each probe row needs its u32 key
// words (4 bytes each) and its liveness byte and writes two int32s; the
// build's packed keys are read at least once. As called, the kernel reads
// 8 bytes per word: the port's words ride in int64. The search's log2(nb) dependent L2 loads per row are latency that
// enough resident warps hide.
//
// The kernel allocates nothing and never synchronizes. The entry point
// returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define SRT_PROBE_THREADS 256

__global__ void probe_ranges_kernel(const long long* __restrict__ pw0,
                                    const long long* __restrict__ pw1,
                                    const bool* __restrict__ plive, long long m,
                                    const unsigned long long* __restrict__ bkeys,
                                    long long nb, const int* __restrict__ bcount_ptr,
                                    long long bcount_val, int* __restrict__ out_lo,
                                    int* __restrict__ out_hi) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int lo = 0, cnt = 0;
  if (plive[i]) {
    unsigned long long key = (unsigned long long)__ldg(pw0 + i) & 0xFFFFFFFFull;
    if (pw1 != nullptr) {
      key = (key << 32) | ((unsigned long long)__ldg(pw1 + i) & 0xFFFFFFFFull);
    }
    long long bc = bcount_ptr != nullptr ? (long long)__ldg(bcount_ptr) : bcount_val;
    int n = (int)(bc < 0 ? 0 : (bc > nb ? nb : bc));
    int a = 0, b = n;
    while (a < b) {  // first build row with key >= probe key
      int mid = (int)(((unsigned)a + (unsigned)b) >> 1);
      if (__ldg(bkeys + mid) < key) a = mid + 1; else b = mid;
    }
    if (a < n && __ldg(bkeys + a) == key) {
      int first = a;
      // the run's end: gallop from first (steps 1, 2, 4, ...) until a
      // key differs, then search the last step. Rows before a are equal
      // to the key, row b (if < n) is above it.
      a = first + 1;
      b = n;
      for (long long step = 1; first + step < n; step <<= 1) {
        int at = (int)(first + step);
        if (__ldg(bkeys + at) != key) { b = at; break; }
        a = at + 1;
      }
      while (a < b) {  // first build row with key > probe key
        int mid = (int)(((unsigned)a + (unsigned)b) >> 1);
        if (__ldg(bkeys + mid) <= key) a = mid + 1; else b = mid;
      }
      lo = first;
      cnt = a - first;
    }
  }
  out_lo[i] = lo;
  out_hi[i] = lo + cnt;
}

extern "C" {

// pw1 == NULL for one-word keys. bkeys: nb packed build keys. build_count
// is bcount_val, or when bcount_ptr is not NULL the device int32 there (a
// count that never left the device).
int srt_probe_ranges(const void* pw0, const void* pw1, const void* plive,
                     long long m, const void* bkeys, long long nb,
                     const void* bcount_ptr, long long bcount_val,
                     void* out_lo, void* out_hi, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  long long blocks = (m + SRT_PROBE_THREADS - 1) / SRT_PROBE_THREADS;
  probe_ranges_kernel<<<(unsigned)blocks, SRT_PROBE_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const long long*)pw0, (const long long*)pw1, (const bool*)plive, m,
      (const unsigned long long*)bkeys, nb, (const int*)bcount_ptr, bcount_val,
      (int*)out_lo, (int*)out_hi);
  return (int)cudaGetLastError();
}

const char* srt_join_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
