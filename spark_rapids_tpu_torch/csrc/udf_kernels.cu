// Hand-written Hopper (sm_90a) kernel for the native string word count.
//
// K5 srt_word_starts <- _word_start_kernel (spark_rapids_tpu/udf/native.py,
//    launched by _word_starts_pallas): the per-byte pass of the in-tree native
//    UDF string_word_count (the reference's string_word_count.cu example).
//
// What it computes, per byte i of the chars pool: out[i] = 1 iff byte i is
// not ASCII whitespace (0x20, 0x09-0x0D) and byte i-1 is; byte -1 counts as
// whitespace. The flags are int32, as the TPU kernel writes them; the word
// count per row is a prefix-sum difference at the row offsets, in PyTorch
// (spark_rapids_tpu_torch/udf/native.py).
//
// Design: the TPU kernel pads the pool with spaces to a multiple of its
// 1024-byte block and streams a shifted copy of the pool ("prev") beside
// it, so that blocks stay independent. Here each thread reads four bytes
// as one 32-bit load and their predecessor directly (chars[4t - 1], a byte
// the neighbouring thread's load brought into L1/L2), and writes its four
// flags as one 16-byte store; the last n % 4 bytes go one per thread. No
// padding and no shifted copy are made.
//
// What bounds it on an H100: bytes. Each byte is read once (the
// predecessor re-read hits cache) and four flag bytes are written: 5 bytes
// per char, 0.11 ms for the 71 MB of one 2^20-row word-count batch at
// 3.35 TB/s. There is no arithmetic to speak of.
//
// Contract: chars 4-byte aligned and out 16-byte aligned (the wrapper
// guarantees both). The kernel allocates nothing and never synchronizes;
// the entry point returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#define SRT_WS_THREADS 256

__device__ __forceinline__ int srt_is_space(unsigned int b) {
  return b == 0x20u || (b >= 0x09u && b <= 0x0Du);
}

__global__ void word_starts_kernel(const unsigned char* __restrict__ chars,
                                   long long n, int* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long nvec = n >> 2;
  if (t < nvec) {
    unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(chars) + t);
    unsigned int prev = t == 0 ? 0x20u : (unsigned int)__ldg(chars + 4 * t - 1);
    unsigned int b0 = w & 0xFFu, b1 = (w >> 8) & 0xFFu;
    unsigned int b2 = (w >> 16) & 0xFFu, b3 = w >> 24;
    int4 f;
    f.x = !srt_is_space(b0) && srt_is_space(prev);
    f.y = !srt_is_space(b1) && srt_is_space(b0);
    f.z = !srt_is_space(b2) && srt_is_space(b1);
    f.w = !srt_is_space(b3) && srt_is_space(b2);
    reinterpret_cast<int4*>(out)[t] = f;
  }
  // the last n % 4 bytes, one per thread of the first threads
  long long i = 4 * nvec + t;
  if (t < (n & 3)) {
    unsigned int b = chars[i];
    unsigned int p = i == 0 ? 0x20u : (unsigned int)chars[i - 1];
    out[i] = !srt_is_space(b) && srt_is_space(p);
  }
}

extern "C" {

int srt_word_starts(const void* chars, long long n, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  long long nvec = n >> 2;
  long long threads = nvec > 3 ? nvec : 3;
  long long blocks = (threads + SRT_WS_THREADS - 1) / SRT_WS_THREADS;
  word_starts_kernel<<<(unsigned)blocks, SRT_WS_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const unsigned char*)chars, n, (int*)out);
  return (int)cudaGetLastError();
}

const char* srt_udf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
