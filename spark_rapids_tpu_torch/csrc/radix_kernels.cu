// The RADIX tier's segment reduction, written by hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference reduces the radix-sorted order
// with an XLA lax.fori_loop over tiles (spark_rapids_tpu/ops/radix_bin.py
// :221 tiled_segment_groupby), and no torch call computes a segmented
// scan that restarts at every segment. Its plain version is that loop in
// torch ops (ops/radix_bin.py); ops/radix_kernels.py wraps this file.
//
// Input: the stable radix sort's permutation `perm` (int64, sorted
// position -> original row) and the NONDECREASING segment id of every
// sorted position `seg` (int32; dead rows come last with an id outside
// [0, n)). Per stream and segment:
//   COUNT  u32 count of considered rows (validity, or every live row)
//   ISUM   wrapping u64 sum of an int32/int64 column's valid rows
//   FSUM   a float32/float64 column split in registers into its NORMAL
//          sum (|x| <= 2^500), its BIG sum (x * 2^-600 for larger finite
//          x) and +inf/-inf/NaN presence bits; the running sum restarts
//          at every segment
//   POS    first ('min') or last ('max') considered sorted position
//   WIN    the winner of a u64 order word over the considered rows: min
//          takes the first tied row; max the last tied row of the FIRST
//          reference tile (`ref_tile` sorted rows) that holds one, the
//          reference's rule, whatever this kernel's own tiles are
// POS and WIN write the original row (perm) or -1. Outputs are indexed by
// segment id, which is compacted from 0.
//
// Design. Kernel 1: each warp owns WARP_TILE consecutive sorted rows and
// walks them 32 at a time; a warp-shuffle segmented scan reduces each
// chunk and a carry joins the chunk to the previous one. A segment that
// starts and ends inside the warp's tile (other than its first) is
// written directly; the tile's FIRST segment (HEAD) and a LAST segment
// that runs on into the next tile (TAIL) go to per-tile partials. Kernel
// 2: one thread per (tile, stream) that owns a segment, the tile where
// it starts, folds the HEAD partials of the following tiles in tile
// order and writes it. Bound on an H100: bytes -- perm and seg once, each
// stream's column and validity once, the outputs once; the column reads
// are gathers at perm, which touch a 32-byte sector a row where rows are
// scattered, so this first design sits well above that bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define SRT_MAXS 32
#define WARP_TILE 1024
#define WARPS 8

enum { K_COUNT = 0, K_ISUM = 1, K_FSUM = 2, K_POS = 3, K_WIN = 4 };

struct Stream {
  int kind;
  int is_min;
  int esize;              // bytes per value of `data`
  const void* data;       // ISUM: int32/int64; FSUM: float/double; WIN: u64
  const uint8_t* valid;   // considered rows; null: every live row
  void* out0;             // COUNT/ISUM int64; FSUM normal f64; POS/WIN int32
  void* out1;             // FSUM big f64
  void* out2;             // FSUM flags u8
};

struct Streams {
  int n;
  Stream s[SRT_MAXS];
};

typedef unsigned long long u64;

// ---------------------------------------------------------------------------
// per-kind state: identity, row load, combine (a before b), store
// ---------------------------------------------------------------------------
struct SAdd {  // COUNT and ISUM: wrapping u64 adds
  u64 v;
};
struct SFsum {
  double nrm, big;
  unsigned int flags;
};
struct SPos {
  long long p;  // sorted position, -1 none
};
struct SWin {
  u64 w;
  long long p;  // sorted position, -1 none
};

__device__ __forceinline__ bool considered(const Stream& s, long long row) {
  return s.valid == nullptr || s.valid[row] != 0;
}

__device__ __forceinline__ SAdd ident_add() { return SAdd{0ull}; }
__device__ __forceinline__ SAdd load_add(const Stream& s, long long row) {
  if (!considered(s, row)) return SAdd{0ull};
  if (s.kind == K_COUNT) return SAdd{1ull};
  long long v = s.esize == 8 ? ((const long long*)s.data)[row]
                             : (long long)((const int*)s.data)[row];
  return SAdd{(u64)v};
}
__device__ __forceinline__ SAdd comb(const SAdd& a, const SAdd& b, int, int) {
  return SAdd{a.v + b.v};
}
__device__ __forceinline__ SAdd shfl_up(const SAdd& a, int d) {
  return SAdd{__shfl_up_sync(0xffffffffu, a.v, d)};
}
__device__ __forceinline__ SAdd shfl_idx(const SAdd& a, int l) {
  return SAdd{__shfl_sync(0xffffffffu, a.v, l)};
}

__device__ __forceinline__ SFsum ident_fsum() { return SFsum{0.0, 0.0, 0u}; }
__device__ __forceinline__ SFsum load_fsum(const Stream& s, long long row) {
  SFsum r{0.0, 0.0, 0u};
  if (!considered(s, row)) return r;
  double d = s.esize == 8 ? ((const double*)s.data)[row]
                          : (double)((const float*)s.data)[row];
  if (d != d) {
    r.flags = 4u;
  } else if (d == __longlong_as_double(0x7ff0000000000000ll)) {
    r.flags = 1u;
  } else if (d == __longlong_as_double(0xfff0000000000000ll)) {
    r.flags = 2u;
  } else if (fabs(d) > 0x1p500) {
    r.big = d * 0x1p-600;
  } else {
    r.nrm = d;
  }
  return r;
}
__device__ __forceinline__ SFsum comb(const SFsum& a, const SFsum& b, int,
                                      int) {
  return SFsum{a.nrm + b.nrm, a.big + b.big, a.flags | b.flags};
}
__device__ __forceinline__ SFsum shfl_up(const SFsum& a, int d) {
  return SFsum{__shfl_up_sync(0xffffffffu, a.nrm, d),
               __shfl_up_sync(0xffffffffu, a.big, d),
               __shfl_up_sync(0xffffffffu, a.flags, d)};
}
__device__ __forceinline__ SFsum shfl_idx(const SFsum& a, int l) {
  return SFsum{__shfl_sync(0xffffffffu, a.nrm, l),
               __shfl_sync(0xffffffffu, a.big, l),
               __shfl_sync(0xffffffffu, a.flags, l)};
}

__device__ __forceinline__ SPos ident_pos() { return SPos{-1}; }
__device__ __forceinline__ SPos comb(const SPos& a, const SPos& b,
                                     int is_min, int) {
  if (a.p < 0) return b;
  if (b.p < 0) return a;
  return SPos{is_min ? min(a.p, b.p) : max(a.p, b.p)};
}
__device__ __forceinline__ SPos shfl_up(const SPos& a, int d) {
  return SPos{__shfl_up_sync(0xffffffffu, a.p, d)};
}
__device__ __forceinline__ SPos shfl_idx(const SPos& a, int l) {
  return SPos{__shfl_sync(0xffffffffu, a.p, l)};
}

__device__ __forceinline__ SWin ident_win() { return SWin{0ull, -1}; }
// min: smaller word, then earlier position. max: larger word, then the
// earlier reference tile, then the later position within it.
__device__ __forceinline__ SWin comb(const SWin& a, const SWin& b,
                                     int is_min, int ref_tile) {
  if (a.p < 0) return b;
  if (b.p < 0) return a;
  if (is_min) {
    if (a.w != b.w) return a.w < b.w ? a : b;
    return a.p < b.p ? a : b;
  }
  if (a.w != b.w) return a.w > b.w ? a : b;
  long long ta = a.p / ref_tile, tb = b.p / ref_tile;
  if (ta != tb) return ta < tb ? a : b;
  return a.p > b.p ? a : b;
}
__device__ __forceinline__ SWin shfl_up(const SWin& a, int d) {
  return SWin{__shfl_up_sync(0xffffffffu, a.w, d),
              __shfl_up_sync(0xffffffffu, a.p, d)};
}
__device__ __forceinline__ SWin shfl_idx(const SWin& a, int l) {
  return SWin{__shfl_sync(0xffffffffu, a.w, l),
              __shfl_sync(0xffffffffu, a.p, l)};
}

// loads at sorted position r (original row `row`)
__device__ __forceinline__ void load_at(const Stream& s, long long r,
                                        long long row, SAdd* v) {
  *v = load_add(s, row);
}
__device__ __forceinline__ void load_at(const Stream& s, long long r,
                                        long long row, SFsum* v) {
  *v = load_fsum(s, row);
}
__device__ __forceinline__ void load_at(const Stream& s, long long r,
                                        long long row, SPos* v) {
  *v = SPos{considered(s, row) ? r : -1};
}
__device__ __forceinline__ void load_at(const Stream& s, long long r,
                                        long long row, SWin* v) {
  *v = considered(s, row)
           ? SWin{((const u64*)s.data)[row], r}
           : SWin{0ull, -1};
}
__device__ __forceinline__ void ident_of(SAdd* v) { *v = ident_add(); }
__device__ __forceinline__ void ident_of(SFsum* v) { *v = ident_fsum(); }
__device__ __forceinline__ void ident_of(SPos* v) { *v = ident_pos(); }
__device__ __forceinline__ void ident_of(SWin* v) { *v = ident_win(); }

__device__ __forceinline__ void store_out(const Stream& s, int sg,
                                          const SAdd& v, const long long*) {
  ((u64*)s.out0)[sg] = v.v;
}
__device__ __forceinline__ void store_out(const Stream& s, int sg,
                                          const SFsum& v, const long long*) {
  ((double*)s.out0)[sg] = v.nrm;
  ((double*)s.out1)[sg] = v.big;
  ((uint8_t*)s.out2)[sg] = (uint8_t)v.flags;
}
__device__ __forceinline__ void store_out(const Stream& s, int sg,
                                          const SPos& v,
                                          const long long* perm) {
  ((int*)s.out0)[sg] = v.p < 0 ? -1 : (int)perm[v.p];
}
__device__ __forceinline__ void store_out(const Stream& s, int sg,
                                          const SWin& v,
                                          const long long* perm) {
  ((int*)s.out0)[sg] = v.p < 0 ? -1 : (int)perm[v.p];
}

// partial records: 3 u64 slots each
__device__ __forceinline__ void put(u64* at, const SAdd& v) { at[0] = v.v; }
__device__ __forceinline__ void put(u64* at, const SFsum& v) {
  at[0] = (u64)__double_as_longlong(v.nrm);
  at[1] = (u64)__double_as_longlong(v.big);
  at[2] = v.flags;
}
__device__ __forceinline__ void put(u64* at, const SPos& v) {
  at[0] = (u64)v.p;
}
__device__ __forceinline__ void put(u64* at, const SWin& v) {
  at[0] = v.w;
  at[1] = (u64)v.p;
}
__device__ __forceinline__ void get(const u64* at, SAdd* v) {
  v->v = at[0];
}
__device__ __forceinline__ void get(const u64* at, SFsum* v) {
  v->nrm = __longlong_as_double((long long)at[0]);
  v->big = __longlong_as_double((long long)at[1]);
  v->flags = (unsigned int)at[2];
}
__device__ __forceinline__ void get(const u64* at, SPos* v) {
  v->p = (long long)at[0];
}
__device__ __forceinline__ void get(const u64* at, SWin* v) {
  v->w = at[0];
  v->p = (long long)at[1];
}

__device__ __forceinline__ bool dead(int sg, long long n) {
  return sg < 0 || (long long)sg >= n;
}

// the partial records of stream `si`, tile `w`: HEAD at [0], TAIL at [3]
__device__ __forceinline__ u64* rec(u64* scratch, int si, long long ntiles,
                                    long long w) {
  return scratch + ((long long)si * ntiles + w) * 6;
}

// ---------------------------------------------------------------------------
// kernel 1: one warp per WARP_TILE sorted rows
// ---------------------------------------------------------------------------
template <class S>
__device__ void warp_tile(const Stream& s, int si, const long long* perm,
                          const int* seg, long long n, int ref_tile,
                          long long w, long long ntiles, u64* scratch,
                          int lane) {
  const long long start = w * WARP_TILE;
  const long long end = min(start + (long long)WARP_TILE, n);
  const int f_w = seg[start];
  if (dead(f_w, n)) return;
  S carry;
  ident_of(&carry);
  for (long long base = start; base < end; base += 32) {
    const long long r = base + lane;
    const bool in = r < end;
    const int sg = in ? seg[r] : -1;
    const bool live = in && !dead(sg, n);
    int prev = __shfl_up_sync(0xffffffffu, sg, 1);
    if (lane == 0) prev = base > start ? seg[base - 1] : -2;
    int next = __shfl_down_sync(0xffffffffu, sg, 1);
    if (lane == 31 || r + 1 >= end) next = r + 1 < n ? seg[r + 1] : -1;
    const bool head = !live || lane == 0 || prev != sg;
    S v;
    if (live) {
      load_at(s, r, perm[r], &v);
    } else {
      ident_of(&v);
    }
    // segmented inclusive scan over the chunk: lanes from the segment's
    // first lane in this chunk
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    const unsigned le = lane == 31 ? 0xffffffffu : ((2u << lane) - 1u);
    const int first = 31 - __clz(heads & le);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      S o = shfl_up(v, d);
      if (lane - d >= first) v = comb(o, v, s.is_min, ref_tile);
    }
    // the chunk's first segment continues the previous chunk's
    const bool cont0 = __shfl_sync(0xffffffffu,
                                   (int)(live && lane == 0 && prev == sg),
                                   0) != 0;
    if (cont0 && first == 0 && live) v = comb(carry, v, s.is_min, ref_tile);
    const bool tail = live && (r == end - 1 || next != sg);
    if (tail) {
      const bool runs_on = r == end - 1 && next == sg;
      if (sg == f_w) {
        put(rec(scratch, si, ntiles, w), v);
      } else if (runs_on) {
        put(rec(scratch, si, ntiles, w) + 3, v);
      } else {
        store_out(s, sg, v, perm);
      }
    }
    carry = shfl_idx(v, 31);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    radix_tiles_kernel(Streams ss, const long long* perm, const int* seg,
                       long long n, int ref_tile, long long ntiles,
                       u64* scratch) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= ntiles) return;
  for (int si = 0; si < ss.n; ++si) {
    const Stream& s = ss.s[si];
    switch (s.kind) {
      case K_COUNT:
      case K_ISUM:
        warp_tile<SAdd>(s, si, perm, seg, n, ref_tile, w, ntiles, scratch,
                        lane);
        break;
      case K_FSUM:
        warp_tile<SFsum>(s, si, perm, seg, n, ref_tile, w, ntiles, scratch,
                         lane);
        break;
      case K_POS:
        warp_tile<SPos>(s, si, perm, seg, n, ref_tile, w, ntiles, scratch,
                        lane);
        break;
      default:
        warp_tile<SWin>(s, si, perm, seg, n, ref_tile, w, ntiles, scratch,
                        lane);
        break;
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 2: fold the partials of segments that span tiles, in tile order
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool runs_past(const int* seg, long long n,
                                          long long t, int s) {
  const long long end = min((t + 1) * WARP_TILE, n);
  return end < n && seg[end] == s;
}

template <class S>
__device__ void fold_from(const Stream& st, int si, const long long* perm,
                          const int* seg, long long n, int ref_tile,
                          long long w, long long ntiles, const u64* scratch,
                          int s, S v) {
  long long t = w;
  while (runs_past(seg, n, t, s)) {
    ++t;
    S h;
    get(rec((u64*)scratch, si, ntiles, t), &h);
    v = comb(v, h, st.is_min, ref_tile);
  }
  store_out(st, s, v, perm);
}

template <class S>
__device__ void fold_tile(const Stream& st, int si, const long long* perm,
                          const int* seg, long long n, int ref_tile,
                          long long w, long long ntiles,
                          const u64* scratch) {
  const long long start = w * WARP_TILE;
  const long long end = min(start + (long long)WARP_TILE, n);
  const int f_w = seg[start];
  if (dead(f_w, n)) return;
  const u64* r = rec((u64*)scratch, si, ntiles, w);
  if (w == 0 || seg[start - 1] != f_w) {  // f_w starts in this tile
    S v;
    get(r, &v);
    fold_from<S>(st, si, perm, seg, n, ref_tile, w, ntiles, scratch, f_w, v);
  }
  const int l = seg[end - 1];
  if (!dead(l, n) && l != f_w && runs_past(seg, n, w, l)) {
    S v;
    get(r + 3, &v);
    fold_from<S>(st, si, perm, seg, n, ref_tile, w, ntiles, scratch, l, v);
  }
}

__global__ void radix_fold_kernel(Streams ss, const long long* perm,
                                  const int* seg, long long n, int ref_tile,
                                  long long ntiles, const u64* scratch) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int si = blockIdx.y;
  if (w >= ntiles || si >= ss.n) return;
  const Stream& s = ss.s[si];
  switch (s.kind) {
    case K_COUNT:
    case K_ISUM:
      fold_tile<SAdd>(s, si, perm, seg, n, ref_tile, w, ntiles, scratch);
      break;
    case K_FSUM:
      fold_tile<SFsum>(s, si, perm, seg, n, ref_tile, w, ntiles, scratch);
      break;
    case K_POS:
      fold_tile<SPos>(s, si, perm, seg, n, ref_tile, w, ntiles, scratch);
      break;
    default:
      fold_tile<SWin>(s, si, perm, seg, n, ref_tile, w, ntiles, scratch);
      break;
  }
}

extern "C" {

// scratch: (nstreams, ceil(n / WARP_TILE), 6) u64, written before read
int srt_radix_segment_reduce(const long long* perm, const int* seg,
                             long long n, int ref_tile, int nstreams,
                             const int* kinds, const int* is_min,
                             const int* esizes, void** data, void** valid,
                             void** out0, void** out1, void** out2,
                             void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || nstreams <= 0) return 0;
  if (ref_tile <= 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + WARP_TILE - 1) / WARP_TILE;
  for (int lo = 0; lo < nstreams; lo += SRT_MAXS) {
    Streams ss;
    ss.n = std::min(SRT_MAXS, nstreams - lo);
    for (int i = 0; i < ss.n; ++i) {
      const int k = lo + i;
      ss.s[i] = Stream{kinds[k], is_min[k], esizes[k], data[k],
                       (const uint8_t*)valid[k], out0[k], out1[k], out2[k]};
    }
    u64* scr = (u64*)scratch + (long long)lo * ntiles * 6;
    const unsigned blocks1 = (unsigned)((ntiles + WARPS - 1) / WARPS);
    radix_tiles_kernel<<<blocks1, WARPS * 32, 0, st>>>(ss, perm, seg, n,
                                                       ref_tile, ntiles, scr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 grid2((unsigned)((ntiles + 255) / 256), (unsigned)ss.n);
    radix_fold_kernel<<<grid2, 256, 0, st>>>(ss, perm, seg, n, ref_tile,
                                             ntiles, scr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* srt_radix_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
