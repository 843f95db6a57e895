// The RADIX tier's segment reduction, written by hand for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference reduces the radix-sorted order
// with an XLA lax.fori_loop over tiles (spark_rapids_tpu/ops/radix_bin.py
// :221 tiled_segment_groupby), and no torch call computes a segmented
// scan that restarts at every segment. Its plain version is that loop in
// torch ops (ops/radix_bin.py); ops/radix_kernels.py wraps this file.
//
// Input: the stable radix sort's permutation `perm` (int64, sorted
// position -> original row), the NONDECREASING segment id of every sorted
// position `seg` (int32; dead rows come last with an id outside [0, n)),
// a table of the DISTINCT inputs (each column and validity once) and the
// streams, each naming its data and validity by their index in that
// table (-1: none). Per stream and segment:
//   COUNT  u64 count of considered rows (validity, or every live row)
//   ISUM   wrapping u64 sum of an int32/int64 column's valid rows
//   FSUM   a float32/float64 column split in registers into its NORMAL
//          sum (|x| <= 2^500), its BIG sum (x * 2^-600 for larger finite
//          x) and +inf/-inf/NaN presence bits
//   POS    first ('min') or last ('max') considered sorted position
//   WIN    the winner of a u64 order word over the considered rows: min
//          takes the first tied row; max the last tied row of the FIRST
//          reference tile (`ref_tile` sorted rows) that holds one, the
//          reference's rule, whatever this kernel's own tiles are
// POS and WIN write the original row (perm) or -1. Outputs are indexed by
// segment id, which is compacted from 0; only the ids the live rows reach
// are written.
//
// Bound on an H100: bytes -- perm and seg once, each distinct input at the
// live rows once, the outputs once. The inputs are gathered at perm, so a
// row whose neighbours in the sorted order lie elsewhere in the original
// order costs a DRAM access per input: where the keys are random (Q4's
// shape) the gathers alone take most of the time.
//
// Design.
//  Kernel 1 (tiles): a block of THREADS threads owns TILE = THREADS * RPT
//  consecutive sorted rows. It loads their perm and seg once, then gathers
//  every distinct input at those rows -- GATHER inputs' loads in flight at
//  a time, consecutive threads on consecutive sorted rows -- into shared
//  memory (the stage). Every stream then reduces from the stage. A tile
//  inside one segment (it continues in and runs on: most tiles where
//  groups are few) is a plain block reduction: each warp's total of every
//  stream goes to shared memory, one barrier, and a warp a stream combines
//  them into the tile's IN record. Any other tile takes a segmented
//  reduction per stream: a thread folds its RPT consecutive rows serially
//  in registers, writing any segment that starts and ends among them; a
//  block-wide segmented scan of the threads' carries (warp shuffles, then
//  the warps' totals through shared memory) completes the segments that
//  cross threads. A segment that continues in from the previous tile
//  leaves its partial in the tile's IN record; one that starts here and
//  runs on into the next tile leaves it in the RUN record; every other
//  segment is written here.
//  Kernel 2 (fold): one warp per (tile, stream). The warp of the tile
//  where a segment that runs on starts combines its RUN record with the
//  IN records of the following tiles that begin inside the segment, 32 x
//  FOLD_UNROLL tiles a step, and writes it. Every combine is associative
//  and, for all kinds, commutative (max's ties order by reference tile,
//  then position: a total order), so integers, positions and winners are
//  exact in any order; float sums re-associate.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <vector>

#define THREADS 256
#define RPT 4  // consecutive sorted rows a thread reduces
#define TILE (THREADS * RPT)
#define WARPS (THREADS / 32)
#define SRT_MAXS 32  // streams a launch takes
#define SRT_MAXI 64  // distinct inputs a launch takes
#define ROW_BYTES 96  // staged bytes a row (sum of the inputs' sizes)
#define BLOCKS_PER_SM 3  // registers capped for 3 blocks of THREADS an SM
#define GATHER 4  // distinct inputs whose loads a thread keeps in flight
#define FOLD_WARPS 8
#define FOLD_UNROLL 4

enum { K_COUNT = 0, K_ISUM = 1, K_FSUM = 2, K_POS = 3, K_WIN = 4 };

struct Stream {
  int kind;
  int is_min;
  int di;  // data: input index, or -1
  int vi;  // validity: input index, or -1 (every live row)
  void* out0;  // COUNT/ISUM int64; FSUM normal f64; POS/WIN int32
  void* out1;  // FSUM big f64
  void* out2;  // FSUM flags u8
};

struct Input {
  const void* ptr;
  int esize;  // 1 (validity), 4 or 8
  int off;    // byte offset of its stage in the dynamic shared memory
};

struct Group {
  int ns, ni;
  Stream s[SRT_MAXS];
  Input in[SRT_MAXI];
};

typedef unsigned long long u64;

// Stage layout: element k of thread t's rows (sorted row t * RPT + k of the
// tile) sits at k * stride + t, so a thread's reads in the reduce are
// conflict-free; the pad makes the gather's writes (consecutive threads on
// consecutive rows) conflict-free for 8- and 4-byte elements.
__host__ __device__ constexpr int stage_stride(int esize) {
  return THREADS + (esize == 8 ? 16 : 32) / RPT;
}
__device__ __forceinline__ int sidx(int L, int stride) {
  return (L % RPT) * stride + L / RPT;
}

// ---------------------------------------------------------------------------
// per-kind state: identity, combine (a before b), shuffles, store, records
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

__device__ __forceinline__ void ident_of(SAdd* v) { v->v = 0ull; }
__device__ __forceinline__ void ident_of(SFsum* v) {
  *v = SFsum{0.0, 0.0, 0u};
}
__device__ __forceinline__ void ident_of(SPos* v) { v->p = -1; }
__device__ __forceinline__ void ident_of(SWin* v) { *v = SWin{0ull, -1}; }

__device__ __forceinline__ SAdd comb(const SAdd& a, const SAdd& b, int, int) {
  return SAdd{a.v + b.v};
}
__device__ __forceinline__ SFsum comb(const SFsum& a, const SFsum& b, int,
                                      int) {
  return SFsum{a.nrm + b.nrm, a.big + b.big, a.flags | b.flags};
}
__device__ __forceinline__ SPos comb(const SPos& a, const SPos& b,
                                     int is_min, int) {
  if (a.p < 0) return b;
  if (b.p < 0) return a;
  return SPos{is_min ? min(a.p, b.p) : max(a.p, b.p)};
}
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

#define FULL 0xffffffffu
__device__ __forceinline__ SAdd shfl_up(const SAdd& a, int d) {
  return SAdd{__shfl_up_sync(FULL, a.v, d)};
}
__device__ __forceinline__ SFsum shfl_up(const SFsum& a, int d) {
  return SFsum{__shfl_up_sync(FULL, a.nrm, d),
               __shfl_up_sync(FULL, a.big, d),
               __shfl_up_sync(FULL, a.flags, d)};
}
__device__ __forceinline__ SPos shfl_up(const SPos& a, int d) {
  return SPos{__shfl_up_sync(FULL, a.p, d)};
}
__device__ __forceinline__ SWin shfl_up(const SWin& a, int d) {
  return SWin{__shfl_up_sync(FULL, a.w, d), __shfl_up_sync(FULL, a.p, d)};
}
__device__ __forceinline__ SAdd shfl_xor(const SAdd& a, int m) {
  return SAdd{__shfl_xor_sync(FULL, a.v, m)};
}
__device__ __forceinline__ SFsum shfl_xor(const SFsum& a, int m) {
  return SFsum{__shfl_xor_sync(FULL, a.nrm, m),
               __shfl_xor_sync(FULL, a.big, m),
               __shfl_xor_sync(FULL, a.flags, m)};
}
__device__ __forceinline__ SPos shfl_xor(const SPos& a, int m) {
  return SPos{__shfl_xor_sync(FULL, a.p, m)};
}
__device__ __forceinline__ SWin shfl_xor(const SWin& a, int m) {
  return SWin{__shfl_xor_sync(FULL, a.w, m), __shfl_xor_sync(FULL, a.p, m)};
}

// every lane's value combined, on every lane (all kinds commute)
template <class S>
__device__ __forceinline__ S warp_all(S v, int is_min, int ref_tile) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = comb(v, shfl_xor(v, m), is_min, ref_tile);
  return v;
}

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

// records (tile partials, shared-memory warp totals): 3 u64 slots each
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
__device__ __forceinline__ void get(const u64* at, SAdd* v) { v->v = at[0]; }
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

// calls fn with a value of the state type of stream kind `kind`
template <class F>
__device__ __forceinline__ void by_kind(int kind, F fn) {
  switch (kind) {
    case K_COUNT:
    case K_ISUM:
      fn(SAdd{});
      break;
    case K_FSUM:
      fn(SFsum{});
      break;
    case K_POS:
      fn(SPos{});
      break;
    default:
      fn(SWin{});
      break;
  }
}

__device__ __forceinline__ bool dead(int sg, long long n) {
  return sg < 0 || (long long)sg >= n;
}

// the records of stream `si`, tile `w`: IN at [0], RUN at [3]
__device__ __forceinline__ u64* rec(u64* scratch, int si, long long ntiles,
                                    long long w) {
  return scratch + ((long long)si * ntiles + w) * 6;
}

// ---------------------------------------------------------------------------
// a staged row's value for one stream (row k of thread t)
// ---------------------------------------------------------------------------
struct View {
  const unsigned char* data;  // the data's stage, or null
  const uint8_t* valid;       // the validity's stage, or null
  int esize;
  int stride;                 // the data's stage stride
};

__device__ __forceinline__ View view_of(const Group& g, const Stream& s,
                                        const unsigned char* smem) {
  View v;
  v.data = s.di >= 0 ? smem + g.in[s.di].off : nullptr;
  v.valid = s.vi >= 0 ? smem + g.in[s.vi].off : nullptr;
  v.esize = s.di >= 0 ? g.in[s.di].esize : 0;
  v.stride = stage_stride(v.esize);
  return v;
}

__device__ __forceinline__ bool considered(const View& v, int t, int k) {
  return v.valid == nullptr || v.valid[k * stage_stride(1) + t] != 0;
}
__device__ __forceinline__ void load_row(const View& v, int kind, int t,
                                         int k, long long, SAdd* out) {
  if (!considered(v, t, k)) {
    out->v = 0ull;
  } else if (kind == K_COUNT) {
    out->v = 1ull;
  } else {
    const int i = k * v.stride + t;
    out->v = v.esize == 8 ? ((const u64*)v.data)[i]
                          : (u64)(long long)((const int*)v.data)[i];
  }
}
__device__ __forceinline__ void load_row(const View& v, int, int t, int k,
                                         long long, SFsum* r) {
  *r = SFsum{0.0, 0.0, 0u};
  if (!considered(v, t, k)) return;
  const int i = k * v.stride + t;
  const double d = v.esize == 8 ? ((const double*)v.data)[i]
                                : (double)((const float*)v.data)[i];
  if (d != d) {
    r->flags = 4u;
  } else if (d == __longlong_as_double(0x7ff0000000000000ll)) {
    r->flags = 1u;
  } else if (d == __longlong_as_double(0xfff0000000000000ll)) {
    r->flags = 2u;
  } else if (fabs(d) > 0x1p500) {
    r->big = d * 0x1p-600;
  } else {
    r->nrm = d;
  }
}
__device__ __forceinline__ void load_row(const View& v, int, int t, int k,
                                         long long p, SPos* out) {
  out->p = considered(v, t, k) ? p : -1;
}
__device__ __forceinline__ void load_row(const View& v, int, int t, int k,
                                         long long p, SWin* out) {
  if (considered(v, t, k)) {
    *out = SWin{((const u64*)v.data)[k * v.stride + t], p};
  } else {
    *out = SWin{0ull, -1};
  }
}

// ---------------------------------------------------------------------------
// kernel 1: one block per TILE sorted rows, every stream
// ---------------------------------------------------------------------------
// Exclusive segmented scan over the block's threads of (f: a segment
// starts among the thread's rows, v: its last segment's partial). The
// caller alternates `wv` and `wf` between streams, so one barrier a stream
// suffices.
template <class S>
__device__ __forceinline__ void block_exscan(bool f, S v, int is_min,
                                             int ref_tile, u64 (*wv)[3],
                                             int* wf, bool* f_ex, S* v_ex) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S o = shfl_up(v, d);
    const int of = __shfl_up_sync(FULL, (int)f, d);
    if (lane >= d) {
      if (!f) v = comb(o, v, is_min, ref_tile);
      f = f || of;
    }
  }
  if (lane == 31) {
    put(wv[warp], v);
    wf[warp] = (int)f;
  }
  S e = shfl_up(v, 1);
  int ef = __shfl_up_sync(FULL, (int)f, 1);
  if (lane == 0) {
    ident_of(&e);
    ef = 0;
  }
  __syncthreads();
  S p;
  ident_of(&p);
  bool pf = false;
  for (int w = 0; w < warp; ++w) {
    S x;
    get(wv[w], &x);
    if (wf[w]) {
      p = x;
      pf = true;
    } else {
      p = comb(p, x, is_min, ref_tile);
    }
  }
  *v_ex = ef ? e : comb(p, e, is_min, ref_tile);
  *f_ex = pf || ef;
}

// the rows' flags, one bit each for k < RPT
struct RowBits {
  unsigned live, head, end;
  int seg[RPT];
};

template <class S>
__device__ __forceinline__ void reduce_stream(
    const Group& g, int si, const RowBits& rb, bool runs_on, long long w,
    const long long* perm, long long ntiles, int ref_tile, u64* scratch,
    const unsigned char* smem, u64 (*wv)[3], int* wf) {
  const Stream& s = g.s[si];
  const int t = threadIdx.x;
  const View v = view_of(g, s, smem);
  S acc, fpart;
  ident_of(&acc);
  ident_of(&fpart);
  bool hh = false, fend = false;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (!((rb.live >> k) & 1u)) break;
    S x;
    load_row(v, s.kind, t, k, w * TILE + t * RPT + k, &x);
    if ((rb.head >> k) & 1u) {
      acc = x;
      hh = true;
    } else {
      acc = comb(acc, x, s.is_min, ref_tile);
    }
    if ((rb.end >> k) & 1u) {
      if (!hh) {
        fpart = acc;
        fend = true;
      } else {
        store_out(s, rb.seg[k], acc, perm);
      }
    }
  }
  bool f_ex;
  S v_ex;
  block_exscan(hh, acc, s.is_min, ref_tile, wv, wf, &f_ex, &v_ex);
  u64* r = rec(scratch, si, ntiles, w);
  if (fend) {  // the thread's first segment started before its rows
    const S tot = comb(v_ex, fpart, s.is_min, ref_tile);
    if (f_ex) {
      store_out(s, rb.seg[0], tot, perm);
    } else {
      put(r, tot);  // it continues in from the previous tile
    }
  }
  if (runs_on) {  // the tile's last row, whose segment runs on
    const S tot = hh ? acc : comb(v_ex, acc, s.is_min, ref_tile);
    put(hh || f_ex ? r + 3 : r, tot);
  }
}

// A tile inside one segment that continues in and runs on: a plain block
// reduction into the tile's IN record, for every stream with one barrier.
// First each warp's total of stream `si` into shared memory ...
template <class S>
__device__ __forceinline__ void warp_inside(const Group& g, int si,
                                            long long w, int ref_tile,
                                            const unsigned char* smem,
                                            u64 (*tot)[WARPS][3]) {
  const Stream& s = g.s[si];
  const int t = threadIdx.x;
  const View v = view_of(g, s, smem);
  S acc;
  load_row(v, s.kind, t, 0, w * TILE + t * RPT, &acc);
#pragma unroll
  for (int k = 1; k < RPT; ++k) {
    S x;
    load_row(v, s.kind, t, k, w * TILE + t * RPT + k, &x);
    acc = comb(acc, x, s.is_min, ref_tile);
  }
  acc = warp_all(acc, s.is_min, ref_tile);
  if ((t & 31) == 0) put(tot[si][t >> 5], acc);
}

// ... then, after the barrier, one warp combines a stream's warp totals
template <class S>
__device__ __forceinline__ void finish_inside(const Group& g, int si,
                                              long long w, long long ntiles,
                                              int ref_tile, u64* scratch,
                                              u64 (*tot)[WARPS][3]) {
  const Stream& s = g.s[si];
  const int lane = threadIdx.x & 31;
  S acc;
  if (lane < WARPS) {
    get(tot[si][lane], &acc);
  } else {
    ident_of(&acc);
  }
  acc = warp_all(acc, s.is_min, ref_tile);
  if (lane == 0) put(rec(scratch, si, ntiles, w), acc);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    radix_staged_tiles_kernel(const __grid_constant__ Group g,
                              const long long* __restrict__ perm,
                              const int* __restrict__ seg, long long n,
                              int ref_tile, long long ntiles,
                              u64* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ u64 wv[2][WARPS][3];
  __shared__ int wf[2][WARPS];
  __shared__ u64 tot[SRT_MAXS][WARPS][3];
  const long long w = blockIdx.x;
  const long long start = w * TILE;
  if (dead(seg[start], n)) return;  // dead rows come last
  const int t = threadIdx.x;
  const long long stop = min(start + (long long)TILE, n);
  const int rows = (int)(stop - start);
  int* seg_s = (int*)smem;
  constexpr int SS = stage_stride(4);

  // 1. perm and seg once; then every distinct input at those rows
  long long row[RPT];
  unsigned live = 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int L = i * THREADS + t;
    int sg = -1;
    if (L < rows) sg = seg[start + L];
    const bool lv = L < rows && !dead(sg, n);
    seg_s[sidx(L, SS)] = lv ? sg : -1;
    row[i] = lv ? perm[start + L] : 0;
    live |= (unsigned)lv << i;
  }
  // GATHER inputs' loads in flight before their stores
  for (int i0 = 0; i0 < g.ni; i0 += GATHER) {
    u64 x[GATHER][RPT];
#pragma unroll
    for (int j = 0; j < GATHER; ++j) {
      if (i0 + j >= g.ni) break;
      const Input in = g.in[i0 + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        u64 y = 0ull;
        if ((live >> i) & 1u) {
          if (in.esize == 8) {
            y = ((const u64*)in.ptr)[row[i]];
          } else if (in.esize == 4) {
            y = ((const unsigned*)in.ptr)[row[i]];
          } else {
            y = ((const uint8_t*)in.ptr)[row[i]];
          }
        }
        x[j][i] = y;
      }
    }
#pragma unroll
    for (int j = 0; j < GATHER; ++j) {
      if (i0 + j >= g.ni) break;
      const Input in = g.in[i0 + j];
      unsigned char* st = smem + in.off;
      const int ss = stage_stride(in.esize);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int at = sidx(i * THREADS + t, ss);
        if (in.esize == 8) {
          ((u64*)st)[at] = x[j][i];
        } else if (in.esize == 4) {
          ((unsigned*)st)[at] = (unsigned)x[j][i];
        } else {
          st[at] = (uint8_t)x[j][i];
        }
      }
    }
  }
  __syncthreads();

  // 2. this thread's RPT consecutive rows: live, head and end flags
  const int before = start > 0 ? seg[start - 1] : -1;
  const int after = stop < n ? seg[stop] : -1;
  RowBits rb{0u, 0u, 0u, {}};
  int prev = t > 0 ? seg_s[(RPT - 1) * SS + t - 1] : before;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int sg = seg_s[k * SS + t];
    int next;
    if (k + 1 < RPT) {
      next = seg_s[(k + 1) * SS + t];
    } else {
      next = t + 1 < THREADS ? seg_s[t + 1] : after;
    }
    rb.seg[k] = sg;
    if (sg >= 0) {
      rb.live |= 1u << k;
      rb.head |= (unsigned)(prev != sg) << k;
      rb.end |= (unsigned)(next != sg) << k;
    }
    prev = sg;
  }
  // the tile's last row's segment runs on into the next tile
  const bool runs_on = t == THREADS - 1 && rows == TILE &&
                       ((rb.live >> (RPT - 1)) & 1u) &&
                       !((rb.end >> (RPT - 1)) & 1u);

  // 3. every stream; a tile inside one segment (it continues in and runs
  // on) takes a plain block reduction
  const int s0 = seg_s[0];
  if (rows == TILE && before == s0 && after == s0 &&
      seg_s[sidx(TILE - 1, SS)] == s0) {
    for (int si = 0; si < g.ns; ++si) {
      by_kind(g.s[si].kind, [&](auto z) {
        warp_inside<decltype(z)>(g, si, w, ref_tile, smem, tot);
      });
    }
    __syncthreads();
    for (int si = t >> 5; si < g.ns; si += WARPS) {
      by_kind(g.s[si].kind, [&](auto z) {
        finish_inside<decltype(z)>(g, si, w, ntiles, ref_tile, scratch, tot);
      });
    }
    return;
  }
  for (int si = 0; si < g.ns; ++si) {
    by_kind(g.s[si].kind, [&](auto z) {
      reduce_stream<decltype(z)>(g, si, rb, runs_on, w, perm, ntiles,
                                 ref_tile, scratch, smem, wv[si & 1],
                                 wf[si & 1]);
    });
  }
}

// ---------------------------------------------------------------------------
// kernel 2: one warp per (tile, stream); the tile where a segment that runs
// on starts folds the IN records of the tiles that begin inside it
// ---------------------------------------------------------------------------
template <class S>
__device__ void fold_segment(const Stream& st, int si,
                             const long long* perm, const int* seg,
                             long long ntiles, int ref_tile,
                             const u64* scratch, long long a, int s) {
  const int lane = threadIdx.x & 31;
  S acc;
  ident_of(&acc);
  for (long long base = a + 1;; base += 32 * FOLD_UNROLL) {
    bool in[FOLD_UNROLL];
#pragma unroll
    for (int u = 0; u < FOLD_UNROLL; ++u) {
      const long long c = base + u * 32 + lane;
      in[u] = c < ntiles && seg[c * TILE] == s;
    }
    bool out = false;
#pragma unroll
    for (int u = 0; u < FOLD_UNROLL; ++u) {
      out = out || !in[u];
      if (in[u]) {
        S h;
        get(rec((u64*)scratch, si, ntiles, base + u * 32 + lane), &h);
        acc = comb(acc, h, st.is_min, ref_tile);
      }
    }
    if (__any_sync(FULL, out)) break;
  }
  acc = warp_all(acc, st.is_min, ref_tile);
  if (lane == 0) {
    S r;
    get(rec((u64*)scratch, si, ntiles, a) + 3, &r);
    store_out(st, s, comb(r, acc, st.is_min, ref_tile), perm);
  }
}

__global__ void __launch_bounds__(FOLD_WARPS * 32)
    radix_span_fold_kernel(const __grid_constant__ Group g,
                           const long long* __restrict__ perm,
                           const int* __restrict__ seg, long long n,
                           int ref_tile, long long ntiles,
                           const u64* scratch) {
  const long long a =
      (long long)blockIdx.x * FOLD_WARPS + (threadIdx.x >> 5);
  const int si = blockIdx.y;
  if (a >= ntiles) return;
  const long long last = min((a + 1) * TILE, n) - 1;
  if (last + 1 >= n) return;
  const int s = seg[last];
  if (dead(s, n) || seg[last + 1] != s) return;  // does not run on
  if (a > 0 && seg[a * TILE - 1] == s) return;   // started in an earlier tile
  by_kind(g.s[si].kind, [&](auto z) {
    fold_segment<decltype(z)>(g.s[si], si, perm, seg, ntiles, ref_tile,
                              scratch, a, s);
  });
}

// the inputs' stage offsets after the segment ids; the bytes in all
static int place_stages(Group* g) {
  int off = 4 * RPT * stage_stride(4);
  for (int i = 0; i < g->ni; ++i) {
    g->in[i].off = off;
    off += (RPT * stage_stride(g->in[i].esize) * g->in[i].esize + 15) & ~15;
  }
  return off;
}

// the tiles kernel's static shared memory (wv, wf, tot), bytes
#define STATIC_SMEM (2 * WARPS * 28 + SRT_MAXS * WARPS * 24)
// the dynamic shared memory each device's tiles kernel is opted into
static int opted[64];

// The streams a launch pair takes from `lo`, in order: up to SRT_MAXS of
// them and ROW_BYTES of distinct inputs a row. Fills `g`.
static void take_group(int lo, int nstreams, const int* sargs,
                      void* const* outs, int ninputs, void* const* in_ptrs,
                      const int* in_esizes, Group* g) {
  std::vector<int> local(ninputs, -1);  // call input -> group input
  int row_bytes = 0;
  g->ns = 0;
  g->ni = 0;
  while (lo + g->ns < nstreams && g->ns < SRT_MAXS) {
    const int* a = sargs + 4 * (lo + g->ns);
    int need = 0, add = 0;
    for (int j = 2; j < 4; ++j) {
      if (a[j] >= 0 && local[a[j]] < 0) {
        need += in_esizes[a[j]];
        ++add;
      }
    }
    if (g->ns > 0 &&
        (row_bytes + need > ROW_BYTES || g->ni + add > SRT_MAXI))
      break;
    Stream& s = g->s[g->ns];
    s.kind = a[0];
    s.is_min = a[1];
    for (int j = 2; j < 4; ++j) {
      int idx = -1;
      if (a[j] >= 0) {
        if (local[a[j]] < 0) {
          local[a[j]] = g->ni;
          g->in[g->ni] = Input{in_ptrs[a[j]], in_esizes[a[j]], 0};
          ++g->ni;
        }
        idx = local[a[j]];
      }
      (j == 2 ? s.di : s.vi) = idx;
    }
    s.out0 = outs[3 * (lo + g->ns)];
    s.out1 = outs[3 * (lo + g->ns) + 1];
    s.out2 = outs[3 * (lo + g->ns) + 2];
    row_bytes += need;
    ++g->ns;
  }
}

extern "C" {

int srt_radix_tile_rows() { return TILE; }

// sargs: per stream (kind, is_min, data input, validity input), -1 none;
// outs: per stream (out0, out1, out2); the inputs' pointers and element
// sizes; scratch: (nstreams, ceil(n / TILE), 6) u64, written before read.
// Each group of streams (take_group) is two launches: tiles, then fold.
int srt_radix_segment_reduce(const long long* perm, const int* seg,
                             long long n, int ref_tile, int nstreams,
                             const int* sargs, void* const* outs,
                             int ninputs, void* const* in_ptrs,
                             const int* in_esizes, void* scratch,
                             void* stream) {
  cudaStream_t cs = (cudaStream_t)stream;
  if (n <= 0 || nstreams <= 0) return 0;
  if (ref_tile <= 0) return (int)cudaErrorInvalidValue;
  const long long ntiles = (n + TILE - 1) / TILE;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  Group g;
  for (int lo = 0; lo < nstreams; lo += g.ns) {
    take_group(lo, nstreams, sargs, outs, ninputs, in_ptrs, in_esizes, &g);
    const int smem = place_stages(&g);
    // past 48 KB with the static shared memory: opt in, once per device
    // and size
    if (smem + STATIC_SMEM > 48 * 1024 && smem > opted[dev & 63]) {
      e = cudaFuncSetAttribute(radix_staged_tiles_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
      opted[dev & 63] = smem;
    }
    u64* scr = (u64*)scratch + (long long)lo * ntiles * 6;
    radix_staged_tiles_kernel<<<(unsigned)ntiles, THREADS, smem, cs>>>(
        g, perm, seg, n, ref_tile, ntiles, scr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dim3 grid2((unsigned)((ntiles + FOLD_WARPS - 1) / FOLD_WARPS),
               (unsigned)g.ns);
    radix_span_fold_kernel<<<grid2, FOLD_WARPS * 32, 0, cs>>>(
        g, perm, seg, n, ref_tile, ntiles, scr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* srt_radix_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
