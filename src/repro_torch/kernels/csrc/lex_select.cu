// lex_select: per lane b, the kk lexicographically smallest (d, id) pairs
// of the scores S[b, :] against the shared ids [R], sorted by (d, id); a
// slot whose id is negative counts as (inf, id), so the -1 slots come out
// as (inf, -1). Any 1 <= kk <= R. Precondition (as for the reference):
// real ids are distinct, so only the masked key repeats.
//
// Replaces the selection stage of src/repro/kernels/topk.py
// (lex_min_select: kk rounds of lexicographic min-extraction in VMEM),
// shared, as there, by K4 (topk.cu scores) and K6 (pq_adc.cu scores).
// Bound on the H100: bytes (S is read once, kk keys a lane written),
// and S comes from L2 when the score pass has just written it.
//
// One block per lane runs an exact radix select on a 64-bit key: the
// float's bits in sign-aware order (a negative value has all its bits
// flipped, a non-negative one its sign bit; -0 is folded into +0), then
// the id with its sign bit flipped, so unsigned key order is (d, id)
// order for any finite d.
//   Staging: the lane's R high halves go to shared memory when
//     R <= kStageMax (16-byte loads, four in flight; otherwise every
//     pass reads S again), and the block finds the least key and the
//     greatest key that can be the kk-th. The high bits those two share
//     are the starting prefix, so the first digit already splits the
//     lane's range of distances.
//   Passes: each histograms the next 11-bit digit of the keys that still
//     share the prefix (a shared-memory atomic a key, one a warp when
//     the warp's digits are equal; __match_any_sync folded equal digits
//     too but cost more than the contention it saves), a block-wide scan
//     finds the bin that holds the kk-th key, and the prefix grows by
//     that bin. A pass ends the search when the bin holds exactly the
//     keys still needed. Once the bin holds at most kCap keys, one sweep
//     moves the rows below it to the selection and the bin's rows to a
//     list, and later passes walk only the list. At most 6 passes; 2 at
//     the main path's shapes (one over the lane, one over ~10 rows).
//   If all 64 bits are fixed and the bin still holds more keys than
//     needed, those keys all equal the prefix (the repeated masked key),
//     and the prefix fills the rest.
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
#include "common.cuh"

namespace {
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKK = 1024;
constexpr int kDigit = 11;            // bits a pass
constexpr int kBins = 1 << kDigit;
constexpr int kCap = 4096;            // candidate list, rows
constexpr int kStageMax = 48 * 1024;  // staged rows a lane, 192 KiB
constexpr unsigned kInfHi = 0xff800000u;  // ordered bits of +inf
constexpr unsigned kNone = 0xffffffffu;
constexpr int kRun = 8192;        // keys a run, 64 KiB of shared memory
constexpr int kMergeThreads = 256;
constexpr int kItems = 8;         // merged keys a thread
typedef unsigned long long Key;  // (ordered d bits, id bits)
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

// kLarge: kk > kMaxKK, the selected keys go to keys [B, kk] unsorted
template <bool kStaged, bool kLarge>
__global__ void __launch_bounds__(kThreads)
lex_select_kernel(const float* __restrict__ S, const int* __restrict__ ids,
                  float* __restrict__ out_d, int* __restrict__ out_i, int R,
                  int kk, Key* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  Key* xchg = reinterpret_cast<Key*>(hist);  // the sort's, after the passes
  int* sel = reinterpret_cast<int*>(hist + kBins);  // selected rows
  int* cand = sel + kMaxKK;
  unsigned* staged = reinterpret_cast<unsigned*>(cand + kCap);
  __shared__ unsigned warp_sum[kWarps];
  __shared__ unsigned s_bin, s_below, s_cnt;
  __shared__ int s_nsel, s_ncand;
  __shared__ unsigned s_min, s_max_real, s_max, s_real;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* srow = S + (long long)blockIdx.x * R;

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
  // the key where only bits >= 32 matter, without reading the id
  auto key_hi = [&](int r, int shift) -> Key {
    return shift >= 32 ? ((Key)hi_of(r) << 32) : key_of(r);
  };
  // a selected row: to the shared list, or its key to the lane's scratch
  Key* lane_keys = kLarge ? keys + (long long)blockIdx.x * kk : nullptr;
  auto take = [&](int pos, int r) {
    if constexpr (kLarge) {
      lane_keys[pos] = key_of(r);
    } else {
      sel[pos] = r;
    }
  };

  if (tid == 0) {
    s_nsel = 0;
    s_ncand = 0;
    s_min = kNone;
    s_max_real = 0;
    s_max = 0;
    s_real = 0;
  }
  __syncthreads();
  // Stage the high halves (when they fit) and find the range the kk-th
  // key lies in: the least key, and the greatest real key when there are
  // kk real keys, else the greatest key.
  unsigned hmin = kNone, hmax_real = 0, hmax = 0, real = 0;
  auto note = [&](unsigned h, bool is_real) {
    hmin = min(hmin, h);
    hmax = max(hmax, h);
    if (is_real) {
      hmax_real = max(hmax_real, h);
      ++real;
    }
  };
  if constexpr (kStaged) {
    // four rows a thread per 16-byte load, four loads in flight
    const bool vec =
        (R & 3) == 0 && rt::aligned16(srow) && rt::aligned16(ids);
    const int nv = vec ? R / 4 : 0;
    const float4* s4 = reinterpret_cast<const float4*>(srow);
    const int4* i4 = reinterpret_cast<const int4*>(ids);
    uint4* st4 = reinterpret_cast<uint4*>(staged);
    for (int v0 = tid; v0 < nv; v0 += 4 * kThreads) {
      float4 sv[4];
      int4 iv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * kThreads;
        if (v < nv) {
          sv[u] = s4[v];
          iv[u] = i4[v];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * kThreads;
        if (v < nv) {
          const uint4 h = make_uint4(
              iv[u].x < 0 ? kInfHi : ordered(sv[u].x),
              iv[u].y < 0 ? kInfHi : ordered(sv[u].y),
              iv[u].z < 0 ? kInfHi : ordered(sv[u].z),
              iv[u].w < 0 ? kInfHi : ordered(sv[u].w));
          st4[v] = h;
          note(h.x, iv[u].x >= 0);
          note(h.y, iv[u].y >= 0);
          note(h.z, iv[u].z >= 0);
          note(h.w, iv[u].w >= 0);
        }
      }
    }
    for (int r = 4 * nv + tid; r < R; r += kThreads) {
      const int id = ids[r];
      staged[r] = id < 0 ? kInfHi : ordered(srow[r]);
      note(staged[r], id >= 0);
    }
  } else {
    for (int r = tid; r < R; r += kThreads) note(hi_of(r), ids[r] >= 0);
  }
  hmin = __reduce_min_sync(rt::kFull, hmin);
  hmax = __reduce_max_sync(rt::kFull, hmax);
  hmax_real = __reduce_max_sync(rt::kFull, hmax_real);
  real = __reduce_add_sync(rt::kFull, real);
  if (lane == 0) {
    atomicMin(&s_min, hmin);
    atomicMax(&s_max, hmax);
    atomicMax(&s_max_real, hmax_real);
    atomicAdd(&s_real, real);
  }
  __syncthreads();
  // the high bits the range shares are the prefix every candidate has;
  // keys above the range (masked ones, when enough keys are real) fail
  // that prefix and are never counted
  const unsigned lo_h = s_min;
  const unsigned hi_h = s_real >= (unsigned)kk ? s_max_real : s_max;
  const int common = __clz(lo_h ^ hi_h);  // 32 when lo_h == hi_h
  const unsigned keep = common == 32 ? kNone : ~(kNone >> common);
  Key prefix = (Key)(lo_h & keep) << 32;
  int fixed = 64 - common;  // bits >= fixed of a live key equal prefix's
  unsigned need = (unsigned)kk;
  bool listed = false, exact = false;
  int ncand = 0;
  while (fixed > 0 && !exact) {
    const int sh = max(fixed - kDigit, 0);
    const unsigned dmask = (1u << (fixed - sh)) - 1;
    for (int i = tid; i < kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    const int n = listed ? ncand : R;
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      unsigned dg = kNone;
      if (i < n) {
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
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      unsigned v = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(rt::kFull, v, o);
        if (lane >= o) v += u;
      }
      warp_sum[lane] = v;
    }
    __syncthreads();
    const unsigned excl = incl - own + (warp ? warp_sum[warp - 1] : 0u);
    if (excl < need && need <= excl + own) {
      const bool first = need <= excl + h0;
      s_bin = 2 * tid + (first ? 0 : 1);
      s_below = first ? excl : excl + h0;
      s_cnt = first ? h0 : h1;
    }
    __syncthreads();
    need -= s_below;
    prefix |= (Key)s_bin << sh;
    fixed = sh;
    exact = s_cnt == need;
    if (!exact && !listed && s_cnt <= (unsigned)kCap) {
      // keys below the bin are selected; the bin's rows become the list
      // (rows, not keys: ids are read once, by the sort)
      const Key pt = prefix >> sh;
      for (int r = tid; r < R; r += kThreads) {
        const Key k = key_hi(r, sh) >> sh;
        if (k < pt)
          take(atomicAdd(&s_nsel, 1), r);
        else if (k == pt)
          cand[atomicAdd(&s_ncand, 1)] = r;
      }
      __syncthreads();
      ncand = s_ncand;
      listed = true;
    }
  }

  // the keys below the final bin, and the bin itself when it is exact
  const Key pt = prefix >> fixed;
  const int n = listed ? ncand : R;
  for (int i = tid; i < n; i += kThreads) {
    const int r = listed ? cand[i] : i;
    const Key k = key_hi(r, fixed) >> fixed;
    if (k < pt || (exact && k == pt)) {
      const int pos = atomicAdd(&s_nsel, 1);
      if (pos < kk) take(pos, r);
    }
  }
  __syncthreads();
  // all 64 bits fixed and the bin not exact: the rest repeat the prefix
  if constexpr (kLarge) {
    for (int j = min(s_nsel, kk) + tid; j < kk; j += kThreads)
      lane_keys[j] = prefix;
    return;  // sorted by sort_runs and merge_runs
  }
  for (int j = min(s_nsel, kk) + tid; j < kk; j += kThreads) sel[j] = -1;
  __syncthreads();
  // bitonic sort of kp = 2^ceil(log2 kk) keys, thread t holding key t:
  // strides below 32 exchange by shuffles, larger ones through sel
  int kp = 1;
  while (kp < kk) kp <<= 1;
  Key v = ~0ull;
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
  if (tid < kk)
    write_pair(out_d, out_i, (long long)blockIdx.x * kk + tid, v);
}

// One block per (lane, run): keys[b, j*kRun : (j+1)*kRun) sorted in
// place in shared memory; with one run a lane (last), written as (d, id).
__global__ void __launch_bounds__(kThreads)
sort_runs(Key* __restrict__ keys, float* __restrict__ out_d,
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
      run[i] = i < n ? keys[base + i] : ~0ull;
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
merge_runs(const Key* __restrict__ src, Key* __restrict__ dst,
           float* __restrict__ out_d, int* __restrict__ out_i, int kk,
           int w, bool last) {
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
}  // namespace

// How many [B, kk] buffers of 64-bit keys lex_select_f32 needs as its
// scratch: two when the sort runs through device memory, else none.
extern "C" int lex_select_scratch_buffers(int kk) {
  return kk > kMaxKK ? 2 : 0;
}

// S [B, R] f32, ids [R] int32, out_d [B, kk] f32, out_i [B, kk] int32;
// scratch: lex_select_scratch_buffers(kk) * B * kk keys of device memory.
extern "C" int lex_select_f32(const void* S, const void* ids, void* out_d,
                              void* out_i, int B, long long R, int kk,
                              void* scratch, void* stream) {
  if (B == 0) return 0;
  const bool large = kk > kMaxKK;
  if (kk < 1 || kk > R || R > 0x7fffffffLL ||
      (large && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(S);
  const int* i = static_cast<const int*>(ids);
  float* d = static_cast<float*>(out_d);
  int* o = static_cast<int*>(out_i);
  Key* keys = static_cast<Key*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t staged_smem = kSmemFixed + (size_t)R * sizeof(unsigned);
  const int max_staged = (int)(kSmemFixed + kStageMax * sizeof(unsigned));
  if (!large && R <= kStageMax) {
    // set once for the process: the largest staged lane
    static const cudaError_t attr = cudaFuncSetAttribute(
        lex_select_kernel<true, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, max_staged);
    if (attr != cudaSuccess) return (int)attr;
    lex_select_kernel<true, false><<<B, kThreads, staged_smem, st>>>(
        s, i, d, o, (int)R, kk, nullptr);
    return (int)cudaGetLastError();
  }
  if (!large) {
    lex_select_kernel<false, false><<<B, kThreads, kSmemFixed, st>>>(
        s, i, d, o, (int)R, kk, nullptr);
    return (int)cudaGetLastError();
  }
  if (R <= kStageMax) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        lex_select_kernel<true, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, max_staged);
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
  static const cudaError_t run_attr = cudaFuncSetAttribute(
      sort_runs, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kRun * sizeof(Key)));
  if (run_attr != cudaSuccess) return (int)run_attr;
  const int nruns = (kk + kRun - 1) / kRun;
  const dim3 run_grid(B, min(nruns, 65535));
  sort_runs<<<run_grid, kThreads, kRun * sizeof(Key), st>>>(keys, d, o, kk,
                                                            nruns == 1);
  err = cudaGetLastError();
  Key* src = keys;
  Key* dst = keys + (long long)B * kk;
  const long long chunks =
      ((long long)kk + kMergeThreads * kItems - 1) / (kMergeThreads * kItems);
  const dim3 merge_grid(B, (unsigned)min(chunks, 65535LL));
  for (long long w = kRun; w < kk && err == cudaSuccess; w *= 2) {
    merge_runs<<<merge_grid, kMergeThreads, 0, st>>>(src, dst, d, o, kk,
                                                     (int)w, 2 * w >= kk);
    err = cudaGetLastError();
    Key* t = src;
    src = dst;
    dst = t;
  }
  return (int)err;
}
