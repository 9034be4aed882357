// lex_select: per lane b, the kk lexicographically smallest (d, id) pairs
// of the scores S[b, :] against the shared ids [R], sorted by (d, id); a
// slot whose id is negative counts as (inf, id), so the -1 slots come out
// as (inf, -1). Any 1 <= kk <= R. Precondition (as for the reference):
// real ids are distinct, so only the masked key repeats.
//
// Replaces the selection stage of src/repro/kernels/topk.py
// (lex_min_select: kk rounds of lexicographic min-extraction in VMEM),
// shared, as there, by K4 (topk.cu scores) and K6 (pq_adc.cu scores).
// Bound on the H100: bytes. Each call reads S once, kk keys a lane
// written. Where S comes from depends on its size: at B = 100, R =
// 25,600 (10 MB) the score pass has just written it and it is read from
// L2, staged whole; at the search cell's B = 256, R = 1,001,472 (1 GB) it
// is read from HBM, once, and the score of a masked slot not at all
// (0.25 ms at 3.35 TB/s; the split path takes ~0.51 ms on an H100).
//
// Every path runs one exact radix select on a 64-bit key: the float's
// bits in sign-aware order (a negative value has all its bits flipped,
// a non-negative one its sign bit; -0 is folded into +0), then the id
// with its sign bit flipped, so unsigned key order is (d, id) order for
// any finite d.
//   Staging: the keys' high halves go to shared memory (16-byte loads),
//     and the block finds the least key and the greatest key that can
//     be the kk-th. The high bits those two share are the starting
//     prefix, so the first digit already splits the range of distances.
//   Passes: each histograms the next 11-bit digit of the keys that still
//     share the prefix (a shared-memory atomic a key, one a warp when
//     the warp's digits are equal; __match_any_sync folded equal digits
//     too but cost more than the contention it saves), a block-wide scan
//     finds the bin that holds the kk-th key, and the prefix grows by
//     that bin. A pass ends the search when the bin holds exactly the
//     keys still needed. Once the bin holds at most kCap keys, one sweep
//     moves the rows below it to the selection and the bin's rows to a
//     list, and later passes walk only the list. At most 6 passes; 2 at
//     the main path's shapes (one over the keys, one over ~10 rows).
//   If all 64 bits are fixed and the bin still holds more keys than
//     needed, those keys all equal the prefix (the repeated masked key),
//     and the prefix fills the rest.
//
// The paths, by R and kk (kernels/lex_select.py's plan):
//   lane, R <= kStageMax: one 1024-thread block a lane stages the whole
//     lane (192 KiB at most, one block an SM).
//   split, R > kStageMax and kk <= kMaxKK: a lane too long to stage is
//     cut into P chunks of kChunk rows, one block a (lane, chunk), two
//     blocks an SM. Stage 1 first runs the first chunk of every lane: it
//     keeps the chunk's kk smallest keys and leaves the lane's bound, the
//     high half of the kk-th of them (the lane's kk smallest keys are no
//     higher). Then the other chunks: the ids are read first and no score
//     of a group of four masked slots is loaded (K4 leaves a masked tile
//     unwritten), and only the keys at or below the bound are kept and
//     listed as they are staged (~kk a chunk at the search cell), so the
//     select walks the list, not the chunk. Each chunk's kk
//     smallest kept keys go unsorted to a scratch [B, P, kk]: the repeated
//     masked key fills a chunk with fewer below it, kPast one with fewer
//     kept. Stage 2, one block a lane, selects the kk smallest of its P kk
//     keys (staged, 8 bytes a key, when they fit). The lane's kk smallest
//     keys are among the union of its chunks' kk smallest kept keys, so
//     the answer is the lane path's.
//   lane, R > kStageMax and kk > kMaxKK: one block a lane reads S from
//     device memory in every pass.
//   Sort, kk <= 1024: the selected rows' keys (ids read once, here), one
//     a thread, go through a bitonic network: shuffles for strides below
//     32, shared memory above.
//   Sort, kk > 1024: the block writes the selected keys to a scratch
//     [B, kk] in device memory that the caller allocates (the selection
//     itself is the same). Then one block a run of kRun keys sorts it
//     with a bitonic network in dynamic shared memory (64 KiB), and
//     merge-path passes merge pairs of runs through a second scratch
//     until one sorted run a lane is left; the last step writes (d, id).
//     Equal keys are the one repeated masked key, so every sort order
//     writes the same bits.
#include <climits>

#include "common.cuh"

namespace {
constexpr int kThreads = 1024;
constexpr int kMaxKK = 1024;
constexpr int kDigit = 11;            // bits a pass
constexpr int kBins = 1 << kDigit;
constexpr int kCap = 4096;            // candidate list, rows
constexpr int kStageMax = 48 * 1024;  // staged rows a lane, 192 KiB
constexpr int kChunk = 16 * 1024;     // rows a block of stage 1, 64 KiB
constexpr int kKeyStageMax = kStageMax / 2;  // stage 2's keys, 192 KiB
constexpr unsigned kInfHi = 0xff800000u;  // ordered bits of +inf
constexpr unsigned kNone = 0xffffffffu;
constexpr int kRun = 8192;        // keys a run, 64 KiB of shared memory
constexpr int kMergeThreads = 256;
constexpr int kItems = 8;         // merged keys a thread
typedef unsigned long long Key;  // (ordered d bits, id bits)
constexpr Key kPast = ~0ull;     // above every key a slot has
// histogram (reused as the sort's exchange buffer), selected rows, list
constexpr size_t kSmemFixed =
    kBins * sizeof(unsigned) + kMaxKK * sizeof(int) + kCap * sizeof(int);
static_assert(kBins * sizeof(unsigned) == kMaxKK * sizeof(Key),
              "the sort exchanges kMaxKK keys through the histogram");

__device__ __forceinline__ unsigned ordered(float d) {
  unsigned u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0;  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned h) {
  return __uint_as_float((h & 0x80000000u) ? (h ^ 0x80000000u) : ~h);
}

__device__ __forceinline__ unsigned id_bits(int id) {
  return (unsigned)id ^ 0x80000000u;
}

__device__ __forceinline__ void write_pair(float* out_d, int* out_i,
                                           long long o, Key v) {
  out_d[o] = unordered((unsigned)(v >> 32));
  out_i[o] = (int)((unsigned)v ^ 0x80000000u);
}

// A block's scalars, in static shared memory.
struct Tally {
  unsigned warp_sum[kThreads / 32];
  unsigned bin, below, cnt;
  int nsel, ncand;
  unsigned min, max_real, max, real, bound;
};

// A block's dynamic shared memory: the histogram (the sort's exchange
// buffer after the passes), the selected rows, the list, then what the
// kernel stages.
struct Smem {
  unsigned* hist;
  int* sel;
  int* cand;
  void* staged;
  __device__ explicit Smem(unsigned char* p)
      : hist(reinterpret_cast<unsigned*>(p)),
        sel(reinterpret_cast<int*>(hist + kBins)),
        cand(sel + kMaxKK),
        staged(cand + kCap) {}
};

__device__ __forceinline__ void begin(Tally& t) {
  if (threadIdx.x == 0) {
    t.nsel = 0;
    t.ncand = 0;
    t.min = kNone;
    t.max_real = 0;
    t.max = 0;
    t.real = 0;
    t.bound = 0;
  }
  __syncthreads();
}

// A thread's share of the range the kk-th key lies in: the least high
// half, the greatest, the greatest of a real key and the real keys.
struct Range {
  unsigned hmin = kNone, hmax = 0, hmax_real = 0, real = 0;
  __device__ __forceinline__ void note(unsigned h, bool is_real) {
    hmin = min(hmin, h);
    hmax = max(hmax, h);
    if (is_real) {
      hmax_real = max(hmax_real, h);
      ++real;
    }
  }
  // the block's, into t
  __device__ __forceinline__ void finish(Tally& t) {
    hmin = __reduce_min_sync(rt::kFull, hmin);
    hmax = __reduce_max_sync(rt::kFull, hmax);
    hmax_real = __reduce_max_sync(rt::kFull, hmax_real);
    real = __reduce_add_sync(rt::kFull, real);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&t.min, hmin);
      atomicMax(&t.max, hmax);
      atomicMax(&t.max_real, hmax_real);
      atomicAdd(&t.real, real);
    }
    __syncthreads();
  }
};

// The n rows of srow against ids staged as their keys' high halves, the
// range noted. kUnroll 16-byte loads of each in flight a thread; with
// kSkipMasked the ids are read first and no score of a group of four
// masked slots is loaded (it may be unwritten). With kBounded only the
// keys whose high half is at most bound are noted, and their rows are
// listed in list (as many as kCap; *nlist counts them all).
template <int kUnroll, bool kSkipMasked, bool kBounded>
__device__ __forceinline__ void stage_scores(const float* __restrict__ srow,
                                             const int* __restrict__ ids,
                                             int n, unsigned* staged,
                                             Range& rg, unsigned bound,
                                             int* list, int* nlist) {
  const int tid = threadIdx.x;
  const int nv = rt::aligned16(srow) && rt::aligned16(ids) ? n / 4 : 0;
  const float4* s4 = reinterpret_cast<const float4*>(srow);
  const int4* i4 = reinterpret_cast<const int4*>(ids);
  uint4* st4 = reinterpret_cast<uint4*>(staged);
  auto keeps = [&](unsigned h) { return !kBounded || h <= bound; };
  for (int v0 = tid; v0 < nv; v0 += kUnroll * kThreads) {
    float4 sv[kUnroll];
    unsigned live = 0;  // a bit a slot whose id is not negative
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < nv) {
        if (!kSkipMasked) sv[u] = s4[v];
        const int4 iv = i4[v];
        live |= ((iv.x >= 0) | (iv.y >= 0) << 1 | (iv.z >= 0) << 2 |
                 (iv.w >= 0) << 3) << 4 * u;
      }
    }
    if (kSkipMasked) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + u * kThreads;
        sv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v < nv && (live >> 4 * u & 15)) sv[u] = s4[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      const unsigned l = live >> 4 * u;
      unsigned m = 0;  // the group's kept keys, a bit each
      if (v < nv) {
        const uint4 h = make_uint4((l & 1) ? ordered(sv[u].x) : kInfHi,
                                   (l & 2) ? ordered(sv[u].y) : kInfHi,
                                   (l & 4) ? ordered(sv[u].z) : kInfHi,
                                   (l & 8) ? ordered(sv[u].w) : kInfHi);
        st4[v] = h;
        m = keeps(h.x) | keeps(h.y) << 1 | keeps(h.z) << 2 |
            keeps(h.w) << 3;
        if (m & 1) rg.note(h.x, l & 1);
        if (m & 2) rg.note(h.y, l & 2);
        if (m & 4) rg.note(h.z, l & 4);
        if (m & 8) rg.note(h.w, l & 8);
      }
      if (kBounded && m) {  // the group's kept rows to the list
        int pos = atomicAdd(nlist, __popc(m));
        for (int j = 0; j < 4; ++j) {
          if ((m >> j & 1) && pos < kCap) list[pos] = 4 * v + j;
          pos += m >> j & 1;
        }
      }
    }
  }
  for (int r = 4 * nv + tid; r < n; r += kThreads) {
    const int id = ids[r];
    staged[r] = id < 0 ? kInfHi : ordered(srow[r]);
    if (keeps(staged[r])) {
      rg.note(staged[r], id >= 0);
      if (kBounded) {
        const int pos = atomicAdd(nlist, 1);
        if (pos < kCap) list[pos] = r;
      }
    }
  }
}

// The exact select of the kk smallest of n keys: hi_of(i) is key i's
// high half, key_of(i) the whole key. The keys below the kk-th one's
// final bin, and the bin when it is exact, go to take(pos, i); t.nsel
// counts them. Returns the prefix, the key that fills the rest. Needs
// the range in t (Range::finish); every thread of the block calls it.
// With nlisted >= 0 the search walks only the nlisted rows of sm.cand,
// which hold the kk smallest.
template <class HiF, class KeyF, class TakeF>
__device__ __forceinline__ Key radix_select(int n, int kk, const Smem& sm,
                                            Tally& t, HiF hi_of,
                                            KeyF key_of, TakeF take,
                                            int nlisted = -1) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* hist = sm.hist;
  int* cand = sm.cand;
  // the key where only bits >= 32 matter, without reading the id
  auto key_hi = [&](int r, int shift) -> Key {
    return shift >= 32 ? ((Key)hi_of(r) << 32) : key_of(r);
  };
  // the high bits the range shares are the prefix every candidate has;
  // keys above the range (masked ones, when enough keys are real) fail
  // that prefix and are never counted
  const unsigned lo_h = t.min;
  const unsigned hi_h = t.real >= (unsigned)kk ? t.max_real : t.max;
  const int common = __clz(lo_h ^ hi_h);  // 32 when lo_h == hi_h
  const unsigned keep = common == 32 ? kNone : ~(kNone >> common);
  Key prefix = (Key)(lo_h & keep) << 32;
  int fixed = 64 - common;  // bits >= fixed of a live key equal prefix's
  unsigned need = (unsigned)kk;
  bool listed = nlisted >= 0, exact = false;
  int ncand = max(nlisted, 0);
  while (fixed > 0 && !exact) {
    const int sh = max(fixed - kDigit, 0);
    const unsigned dmask = (1u << (fixed - sh)) - 1;
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    const int m = listed ? ncand : n;
    for (int base = 0; base < m; base += kThreads) {
      const int i = base + tid;
      unsigned dg = kNone;
      if (i < m) {
        const Key k = key_hi(listed ? cand[i] : i, sh);
        if (fixed == 64 || (k >> fixed) == (prefix >> fixed))
          dg = (unsigned)(k >> sh) & dmask;
      }
      // one atomic when the whole warp shares a digit (ties, masked
      // keys), else one a thread
      const unsigned d0 = __shfl_sync(rt::kFull, dg, 0);
      if (__all_sync(rt::kFull, dg == d0)) {
        if (lane == 0 && d0 != kNone) atomicAdd(&hist[d0], 32u);
      } else if (dg != kNone) {
        atomicAdd(&hist[dg], 1u);
      }
    }
    __syncthreads();
    // thread t owns bins 2t and 2t + 1; a block-wide scan of their sums
    const unsigned h0 = hist[2 * tid], h1 = hist[2 * tid + 1];
    const unsigned own = h0 + h1;
    unsigned incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(rt::kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) t.warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      unsigned v = t.warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(rt::kFull, v, o);
        if (lane >= o) v += u;
      }
      t.warp_sum[lane] = v;
    }
    __syncthreads();
    const unsigned excl = incl - own + (warp ? t.warp_sum[warp - 1] : 0u);
    if (excl < need && need <= excl + own) {
      const bool first = need <= excl + h0;
      t.bin = 2 * tid + (first ? 0 : 1);
      t.below = first ? excl : excl + h0;
      t.cnt = first ? h0 : h1;
    }
    __syncthreads();
    need -= t.below;
    prefix |= (Key)t.bin << sh;
    fixed = sh;
    exact = t.cnt == need;
    if (!exact && !listed && t.cnt <= (unsigned)kCap) {
      // keys below the bin are selected; the bin's rows become the list
      // (rows, not keys: ids are read once, by the sort)
      const Key pt = prefix >> sh;
      for (int r = tid; r < n; r += kThreads) {
        const Key k = key_hi(r, sh) >> sh;
        if (k < pt)
          take(atomicAdd(&t.nsel, 1), r);
        else if (k == pt)
          cand[atomicAdd(&t.ncand, 1)] = r;
      }
      __syncthreads();
      ncand = t.ncand;
      listed = true;
    }
  }

  // the keys below the final bin, and the bin itself when it is exact
  const Key pt = prefix >> fixed;
  const int m = listed ? ncand : n;
  for (int i = tid; i < m; i += kThreads) {
    const int r = listed ? cand[i] : i;
    const Key k = key_hi(r, fixed) >> fixed;
    if (k < pt || (exact && k == pt)) {
      const int pos = atomicAdd(&t.nsel, 1);
      if (pos < kk) take(pos, r);
    }
  }
  __syncthreads();
  return prefix;
}

// The selection sorted and written as (d, id) at out[o .. o + kk), kk <=
// kMaxKK: sm.sel's rows, the prefix from t.nsel on (all 64 bits fixed
// and the bin not exact: the rest repeat it). A bitonic sort of kp =
// 2^ceil(log2 kk) keys, thread t holding key t: strides below 32
// exchange by shuffles, larger ones through the histogram.
template <class KeyF>
__device__ __forceinline__ void sort_out(int kk, const Smem& sm,
                                         const Tally& t, Key prefix,
                                         KeyF key_of, float* out_d,
                                         int* out_i, long long o) {
  const int tid = threadIdx.x;
  int* sel = sm.sel;
  Key* xchg = reinterpret_cast<Key*>(sm.hist);
  for (int j = min(t.nsel, kk) + tid; j < kk; j += kThreads) sel[j] = -1;
  __syncthreads();
  int kp = 1;
  while (kp < kk) kp <<= 1;
  Key v = kPast;
  if (tid < kk) v = sel[tid] < 0 ? prefix : key_of(sel[tid]);
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      Key other;
      if (stride >= 32) {
        __syncthreads();
        if (tid < kp) xchg[tid] = v;
        __syncthreads();
        other = tid < kp ? xchg[tid ^ stride] : v;
      } else {
        other = __shfl_xor_sync(rt::kFull, v, stride);
      }
      const bool keep_min = ((tid & stride) == 0) == ((tid & size) == 0);
      v = keep_min == (other < v) ? other : v;
    }
  }
  if (tid < kk) write_pair(out_d, out_i, o + tid, v);
}

// The whole lane of one block. kLarge: kk > kMaxKK, the selected keys go
// to keys [B, kk] unsorted.
template <bool kStaged, bool kLarge>
__global__ void __launch_bounds__(kThreads)
lex_select_kernel(const float* __restrict__ S, const int* __restrict__ ids,
                  float* __restrict__ out_d, int* __restrict__ out_i, int R,
                  int kk, Key* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tally t;
  const Smem sm(smem);
  unsigned* staged = static_cast<unsigned*>(sm.staged);
  const float* srow = S + (long long)blockIdx.x * R;
  begin(t);
  auto hi_of = [&](int r) -> unsigned {
    if constexpr (kStaged) {
      return staged[r];
    } else {
      return ids[r] < 0 ? kInfHi : ordered(srow[r]);
    }
  };
  auto key_of = [&](int r) -> Key {
    return ((Key)hi_of(r) << 32) | id_bits(ids[r]);
  };
  Range rg;
  if constexpr (kStaged) {
    stage_scores<4, false, false>(srow, ids, R, staged, rg, kNone, nullptr,
                                  nullptr);
  } else {
    for (int r = threadIdx.x; r < R; r += kThreads)
      rg.note(hi_of(r), ids[r] >= 0);
  }
  rg.finish(t);
  // a selected row: to the shared list, or its key to the lane's scratch
  Key* lane_keys = kLarge ? keys + (long long)blockIdx.x * kk : nullptr;
  const Key prefix = radix_select(
      R, kk, sm, t, hi_of, key_of, [&](int pos, int r) {
        if constexpr (kLarge) {
          lane_keys[pos] = key_of(r);
        } else {
          sm.sel[pos] = r;
        }
      });
  if constexpr (kLarge) {
    for (int j = min(t.nsel, kk) + threadIdx.x; j < kk; j += kThreads)
      lane_keys[j] = prefix;
    return;  // sorted by lex_select_sort_runs and lex_select_merge_runs
  } else {
    sort_out(kk, sm, t, prefix, key_of, out_d, out_i,
             (long long)blockIdx.x * kk);
  }
}

// Stage 1 of the split path: block i takes chunk p = p0 + i / B of lane
// b = i % B, rows [p kChunk, min(R, (p + 1) kChunk)), staged, and writes
// the kk smallest of the keys it keeps to keys[b, p, :], unsorted: the
// prefix fills a chunk with fewer below it, kPast a chunk with fewer
// kept. The first chunk (launched alone, p0 = 0) keeps every key and
// leaves its lane's bound in bounds[b]: the high half of its kk-th key,
// so that the lane's kk smallest keys all lie at or below it. Every other chunk keeps only the keys at or below its lane's bound.
// They are listed as they are staged; when the list holds them all (a
// chunk of the search cell keeps ~kk) the select walks only the list, or
// is not needed when they are at most kk, and else it walks the chunk.
__global__ void __launch_bounds__(kThreads, 2)
lex_select_chunk_kernel(const float* __restrict__ S,
                        const int* __restrict__ ids, int R, int B, int kk,
                        int p0, Key* __restrict__ keys,
                        unsigned* __restrict__ bounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tally t;
  const Smem sm(smem);
  unsigned* staged = static_cast<unsigned*>(sm.staged);
  const int P = (R + kChunk - 1) / kChunk;
  const int b = blockIdx.x % B, p = p0 + blockIdx.x / B;
  const int c0 = p * kChunk, n = min(kChunk, R - c0);
  const int* cid = ids + c0;
  const float* srow = S + (long long)b * R + c0;
  Key* out = keys + ((long long)b * P + p) * kk;
  begin(t);
  Range rg;
  int kept = n;
  if (p == 0) {
    stage_scores<1, true, false>(srow, cid, n, staged, rg, kNone, nullptr,
                                 nullptr);
    rg.finish(t);
  } else {
    stage_scores<1, true, true>(srow, cid, n, staged, rg, bounds[b],
                                sm.cand, &t.ncand);
    rg.finish(t);
    kept = t.ncand;
    if (kept <= kk) {  // every kept key is selected
      for (int j = threadIdx.x; j < kk; j += kThreads)
        out[j] = j < kept ? ((Key)staged[sm.cand[j]] << 32) |
                                id_bits(cid[sm.cand[j]])
                          : kPast;
      return;
    }
    if (kept > kCap) {  // the select's sweep lists the rows anew
      __syncthreads();
      if (threadIdx.x == 0) t.ncand = 0;
      __syncthreads();
    }
  }
  const int kc = min(kk, kept);
  auto hi_of = [&](int r) -> unsigned { return staged[r]; };
  auto key_of = [&](int r) -> Key {
    return ((Key)staged[r] << 32) | id_bits(cid[r]);
  };
  const Key prefix = radix_select(
      n, kc, sm, t, hi_of, key_of,
      [&](int pos, int r) { out[pos] = key_of(r); },
      p > 0 && kept <= kCap ? kept : -1);
  for (int j = min(t.nsel, kc) + threadIdx.x; j < kk; j += kThreads)
    out[j] = j < kc ? prefix : kPast;
  if (p == 0) {  // the lane's bound: the greatest high half written
    __syncthreads();
    unsigned hb = 0;
    for (int j = threadIdx.x; j < kk; j += kThreads)
      hb = max(hb, (unsigned)(out[j] >> 32));
    hb = __reduce_max_sync(rt::kFull, hb);
    if ((threadIdx.x & 31) == 0) atomicMax(&t.bound, hb);
    __syncthreads();
    if (threadIdx.x == 0) bounds[b] = t.bound;
  }
}

// Stage 2 of the split path: one block a lane selects the kk smallest of
// its n = P kk keys in keys[b, :, :], staged when they fit, and writes
// them sorted as (d, id).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
lex_select_keys_kernel(const Key* __restrict__ keys,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int n, int kk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Tally t;
  const Smem sm(smem);
  const Key* src = keys + (long long)blockIdx.x * n;
  Key* staged = static_cast<Key*>(sm.staged);
  begin(t);
  Range rg;
  if constexpr (kStaged) {
    // two keys a 16-byte load where the lane's keys are 16-byte aligned
    const int nv = rt::aligned16(src) ? n / 2 : 0;
    const ulonglong2* s2 = reinterpret_cast<const ulonglong2*>(src);
    ulonglong2* st2 = reinterpret_cast<ulonglong2*>(staged);
    for (int v = threadIdx.x; v < nv; v += kThreads) {
      const ulonglong2 k = s2[v];
      st2[v] = k;
      rg.note((unsigned)(k.x >> 32), (unsigned)(k.x >> 32) < kInfHi);
      rg.note((unsigned)(k.y >> 32), (unsigned)(k.y >> 32) < kInfHi);
    }
    for (int i = 2 * nv + threadIdx.x; i < n; i += kThreads) {
      staged[i] = src[i];
      rg.note((unsigned)(src[i] >> 32), (unsigned)(src[i] >> 32) < kInfHi);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads)
      rg.note((unsigned)(src[i] >> 32), (unsigned)(src[i] >> 32) < kInfHi);
  }
  rg.finish(t);
  const Key* k = kStaged ? staged : src;
  auto key_of = [&](int i) -> Key { return k[i]; };
  auto hi_of = [&](int i) -> unsigned { return (unsigned)(k[i] >> 32); };
  const Key prefix = radix_select(
      n, kk, sm, t, hi_of, key_of,
      [&](int pos, int i) { sm.sel[pos] = i; });
  sort_out(kk, sm, t, prefix, key_of, out_d, out_i,
           (long long)blockIdx.x * kk);
}

// One block per (lane, run): keys[b, j*kRun : (j+1)*kRun) sorted in
// place in shared memory; with one run a lane (last), written as (d, id).
__global__ void __launch_bounds__(kThreads)
lex_select_sort_runs(Key* __restrict__ keys, float* __restrict__ out_d,
                     int* __restrict__ out_i, int kk, bool last) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* run = reinterpret_cast<Key*>(smem);
  const int nruns = (kk + kRun - 1) / kRun;
  for (int j = blockIdx.y; j < nruns; j += gridDim.y) {
    const long long base = (long long)blockIdx.x * kk + (long long)j * kRun;
    const int n = min(kRun, kk - j * kRun);
    int p = 2;
    while (p < n) p <<= 1;
    __syncthreads();  // the previous run's writes have read run[]
    for (int i = threadIdx.x; i < p; i += kThreads)
      run[i] = i < n ? keys[base + i] : kPast;
    for (int size = 2; size <= p; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        __syncthreads();
        // pair t: i = its lower index, the partner stride above it
        for (int t = threadIdx.x; t < p / 2; t += kThreads) {
          const int i = 2 * t - (t & (stride - 1));
          const Key a = run[i], c = run[i + stride];
          if ((a > c) == ((i & size) == 0)) {
            run[i] = c;
            run[i + stride] = a;
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      if (last)
        write_pair(out_d, out_i, base + i, run[i]);
      else
        keys[base + i] = run[i];
    }
  }
}

// Merge path: the sorted runs of width w in src [B, kk] merge in pairs
// into dst; each thread writes kItems consecutive outputs of its lane,
// from where a binary search on its diagonal puts it. The last pass
// writes (d, id) instead.
__global__ void __launch_bounds__(kMergeThreads)
lex_select_merge_runs(const Key* __restrict__ src, Key* __restrict__ dst,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int kk, int w, bool last) {
  const long long lane = (long long)blockIdx.x * kk;
  const long long step = (long long)gridDim.y * kMergeThreads * kItems;
  for (long long o0 =
           ((long long)blockIdx.y * kMergeThreads + threadIdx.x) * kItems;
       o0 < kk; o0 += step) {
    const long long s = o0 / (2LL * w) * (2LL * w);  // the pair's start
    const Key* a = src + lane + s;
    const int la = (int)min((long long)w, kk - s);
    const Key* bb = a + la;
    const int lb = (int)max(0LL, min((long long)w, kk - s - w));
    const int diag = (int)(o0 - s);
    int lo = max(0, diag - lb), hi = min(diag, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a[mid] <= bb[diag - 1 - mid])
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = diag - lo;
    const int n = (int)min((long long)kItems, kk - o0);
    for (int t = 0; t < n; ++t) {
      const bool take_a = j >= lb || (i < la && a[i] <= bb[j]);
      const Key v = take_a ? a[i++] : bb[j++];
      if (last)
        write_pair(out_d, out_i, lane + o0 + t, v);
      else
        dst[lane + o0 + t] = v;
    }
  }
}

// Dynamic shared memory above 48 KiB for kernel (the most it is
// launched with); callers set it once for the process.
template <class F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
}  // namespace

// The limits kernels/lex_select.py plans by: 0 the rows a lane the lane
// path stages (kStageMax), 1 the largest kk sorted in shared memory
// (kMaxKK), 2 the rows of a chunk of the split path (kChunk).
extern "C" int lex_select_limit(int which) {
  return which == 0 ? kStageMax : which == 1 ? kMaxKK : kChunk;
}

// S [B, R] f32, ids [R] int32, out_d [B, kk] f32, out_i [B, kk] int32;
// scratch, in 64-bit keys: 2 B kk when kk > kMaxKK, B P kk + B on the
// split path (R > kStageMax, P = ceil(R / kChunk): the chunks' keys, a
// word a lane for its bound), else none.
extern "C" int lex_select_f32(const void* S, const void* ids, void* out_d,
                              void* out_i, int B, long long R, int kk,
                              void* scratch, void* stream) {
  if (B == 0) return 0;
  const bool large = kk > kMaxKK;
  const bool split = !large && R > kStageMax;
  if (kk < 1 || kk > R || R > 0x7fffffffLL ||
      ((large || split) && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(S);
  const int* i = static_cast<const int*>(ids);
  float* d = static_cast<float*>(out_d);
  int* o = static_cast<int*>(out_i);
  Key* keys = static_cast<Key*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t staged_smem = kSmemFixed + (size_t)R * sizeof(unsigned);
  const size_t max_staged = kSmemFixed + kStageMax * sizeof(unsigned);
  if (split) {
    const long long P = (R + kChunk - 1) / kChunk;
    if ((long long)B * P > INT_MAX) return (int)cudaErrorInvalidValue;
    const size_t chunk_smem = kSmemFixed + kChunk * sizeof(unsigned);
    // two blocks an SM: all of its shared memory, none as L1
    static const cudaError_t chunk_attr = [chunk_smem] {
      const cudaError_t e = allow_smem(lex_select_chunk_kernel, chunk_smem);
      return e != cudaSuccess
                 ? e
                 : cudaFuncSetAttribute(
                       lex_select_chunk_kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
    }();
    if (chunk_attr != cudaSuccess) return (int)chunk_attr;
    // the first chunk of every lane, then the rest by the lane's bound
    unsigned* bounds = reinterpret_cast<unsigned*>(keys + B * P * kk);
    lex_select_chunk_kernel<<<B, kThreads, chunk_smem, st>>>(
        s, i, (int)R, B, kk, 0, keys, bounds);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    lex_select_chunk_kernel<<<(unsigned)(B * (P - 1)), kThreads, chunk_smem,
                              st>>>(s, i, (int)R, B, kk, 1, keys, bounds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long n = P * kk;
    if (n <= kKeyStageMax) {
      static const cudaError_t keys_attr = allow_smem(
          lex_select_keys_kernel<true>,
          kSmemFixed + kKeyStageMax * sizeof(Key));
      if (keys_attr != cudaSuccess) return (int)keys_attr;
      lex_select_keys_kernel<true>
          <<<B, kThreads, kSmemFixed + n * sizeof(Key), st>>>(keys, d, o,
                                                              (int)n, kk);
    } else {
      lex_select_keys_kernel<false><<<B, kThreads, kSmemFixed, st>>>(
          keys, d, o, (int)n, kk);
    }
    return (int)cudaGetLastError();
  }
  if (!large) {
    static const cudaError_t attr =
        allow_smem(lex_select_kernel<true, false>, max_staged);
    if (attr != cudaSuccess) return (int)attr;
    lex_select_kernel<true, false><<<B, kThreads, staged_smem, st>>>(
        s, i, d, o, (int)R, kk, nullptr);
    return (int)cudaGetLastError();
  }
  if (R <= kStageMax) {
    static const cudaError_t attr =
        allow_smem(lex_select_kernel<true, true>, max_staged);
    if (attr != cudaSuccess) return (int)attr;
    lex_select_kernel<true, true><<<B, kThreads, staged_smem, st>>>(
        s, i, d, o, (int)R, kk, keys);
  } else {
    lex_select_kernel<false, true><<<B, kThreads, kSmemFixed, st>>>(
        s, i, d, o, (int)R, kk, keys);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // sort the runs, then merge pairs until one run a lane is left
  static const cudaError_t run_attr =
      allow_smem(lex_select_sort_runs, kRun * sizeof(Key));
  if (run_attr != cudaSuccess) return (int)run_attr;
  const int nruns = (kk + kRun - 1) / kRun;
  const dim3 run_grid(B, min(nruns, 65535));
  lex_select_sort_runs<<<run_grid, kThreads, kRun * sizeof(Key), st>>>(
      keys, d, o, kk, nruns == 1);
  err = cudaGetLastError();
  Key* src = keys;
  Key* dst = keys + (long long)B * kk;
  const long long chunks =
      ((long long)kk + kMergeThreads * kItems - 1) / (kMergeThreads * kItems);
  const dim3 merge_grid(B, (unsigned)min(chunks, 65535LL));
  for (long long w = kRun; w < kk && err == cudaSuccess; w *= 2) {
    lex_select_merge_runs<<<merge_grid, kMergeThreads, 0, st>>>(
        src, dst, d, o, kk, (int)w, 2 * w >= kk);
    err = cudaGetLastError();
    Key* t = src;
    src = dst;
    dst = t;
  }
  return (int)err;
}
