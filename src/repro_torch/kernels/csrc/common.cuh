// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every kernel is exported through a plain C function that launches it
// on the caller's stream and returns cudaGetLastError() (0 on success),
// so the Python wrapper raises on a launch that CUDA refused.
//
// The lexicographic (d, id) selection shared by K4 (topk.cu) and K6
// (pq_adc_select.cu) lives here too: a warp owns one query lane; a
// candidate is a 64-bit key (float bits of d >= 0, then the id with its
// sign bit flipped, so unsigned order is (d, id) order); the warp sorts
// 32 keys at a time with shuffles (warp_sort32) and folds them into the
// lane's ascending running list in shared memory. A tile whose smallest
// key is not below the list's kk-th is skipped. Two folds:
//   merge_tile   (K4) the list holds kp = a power of two >= kk keys;
//                min(list[i], tile[kp-1-i]) makes one bitonic sequence
//                that holds the kp smallest, and a bitonic merge sorts
//                it: log2(kp) passes over the whole list per tile.
//   insert_tile  (K6) the list holds exactly kk keys; each tile key finds
//                its rank in the list by binary search, and the list
//                entries above the first rank move up by the number of
//                tile keys ranked at or below them, 32 at a time from the
//                top: per tile, about (kk - first rank) moves instead of
//                kp * log2(kp) compare-exchanges, which matters at K6's
//                kk = 800.
// select_merge_kernel is the second pass of both kernels: a warp per lane
// merges the per-slice lists with the kernel's fold.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr unsigned kFull = 0xffffffffu;
typedef unsigned long long Key;

__device__ __forceinline__ Key pack(float d, int id) {
  return ((Key)__float_as_uint(d) << 32) | (Key)((unsigned)id ^ 0x80000000u);
}

__device__ __forceinline__ Key empty_key() {
  return pack(__int_as_float(0x7f800000), -1);  // (inf, -1)
}

__device__ __forceinline__ float key_d(Key k) {
  return __uint_as_float((unsigned)(k >> 32));
}

__device__ __forceinline__ int key_id(Key k) {
  return (int)((unsigned)k ^ 0x80000000u);
}

__device__ __forceinline__ Key key_min(Key a, Key b) { return a < b ? a : b; }

// Bitonic sort of a warp's 32 keys (one per thread t), ascending by lane.
__device__ __forceinline__ Key warp_sort32(Key key, int t) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const Key other = __shfl_xor_sync(kFull, key, stride);
      const bool take_min = ((t & stride) == 0) == ((t & size) == 0);
      key = take_min == (other < key) ? other : key;
    }
  }
  return key;
}

// Fold a warp's 32 keys, ascending by lane, into the ascending list
// best[0..kp) so that best[0..kk) stay the kk smallest keys seen.
// kp is a power of two >= 32 and >= kk.
__device__ __forceinline__ void merge_tile(Key* best, Key key, int kk, int kp,
                                           int t) {
  if (!(__shfl_sync(kFull, key, 0) < best[kk - 1])) return;  // warp-uniform
  const Key rev = __shfl_sync(kFull, key, 31 - t);
  best[kp - 32 + t] = key_min(best[kp - 32 + t], rev);
  __syncwarp();
  for (int stride = kp >> 1; stride > 0; stride >>= 1) {
    for (int p = t; p < kp / 2; p += 32) {
      const int lo = (p / stride) * (2 * stride) + (p % stride);
      const Key x0 = best[lo], x1 = best[lo + stride];
      if (x1 < x0) {
        best[lo] = x1;
        best[lo + stride] = x0;
      }
    }
    __syncwarp();
  }
}

// Fold a warp's 32 keys, ascending by lane, into the ascending list
// best[0..kk) of exactly kk keys, keeping the kk smallest. rank is 32 ints
// of the warp's scratch in shared memory; len (warp-uniform) counts the
// list's keys below the (inf, -1) placeholder, which fill best[len..kk),
// so only best[r0..len) has to move. Ties between a tile key and a list
// key (only the placeholder repeats) put the tile key first, which keeps
// the positions a permutation.
__device__ __forceinline__ void insert_tile(Key* best, int* rank, Key key,
                                            int kk, int& len, int t) {
  if (!(__shfl_sync(kFull, key, 0) < best[kk - 1])) return;  // warp-uniform
  int lo = 0, hi = len;  // lo = #{list keys < key}
  if (key < empty_key()) {
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (best[mid] < key)
        lo = mid + 1;
      else
        hi = mid;
    }
  } else {
    lo = len;
  }
  rank[t] = lo;
  const int r0 = __shfl_sync(kFull, lo, 0);
  const int fresh = __popc(__ballot_sync(kFull, key < empty_key()));
  __syncwarp();
  // list entry i in [r0, len) moves up by #{tile keys whose rank <= i};
  // chunks go from the top down, so no entry is overwritten before it is
  // read
  for (int c = r0 + ((len - 1 - r0) & ~31); c >= r0 && len > r0; c -= 32) {
    const int i = c + t;
    Key v = 0;
    int dest = kk;
    if (i < len) {
      v = best[i];
      int a = 0, b = 32;  // upper bound of i in the non-decreasing ranks
      while (a < b) {
        const int m = (a + b) >> 1;
        if (rank[m] <= i)
          a = m + 1;
        else
          b = m;
      }
      dest = i + a;
    }
    __syncwarp();
    if (dest < kk) best[dest] = v;
  }
  if (lo + t < kk && t < fresh) best[lo + t] = key;
  len = min(kk, len + fresh);
  __syncwarp();
}

// The list capacity for kk keys: the least power of two >= max(kk, 32).
inline int list_capacity(int kk) {
  int kp = 32;
  while (kp < kk) kp <<= 1;
  return kp;
}

// Pass 2: partial [splits, B, kk] holds each slice's sorted keys per
// lane; a warp per lane merges them 32 keys at a time and unpacks the kk
// smallest into out_d / out_i [B, kk]. The list of a lane holds kp keys
// (merge_tile: a power of two >= kk; insert_tile: kp = kk); dynamic
// shared memory: kLanes * kp keys, and with insert_tile 32 ints a lane.
template <int kLanes, bool kInsert>
__global__ void __launch_bounds__(kLanes * 32)
select_merge_kernel(const Key* __restrict__ partial, float* __restrict__ out_d,
                    int* __restrict__ out_i, int B, int splits, int kk,
                    int kp) {
  extern __shared__ Key merge_smem[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * kLanes + warp;
  if (b >= B) return;  // whole warps; no block-wide barrier below
  Key* best = merge_smem + warp * kp;
  int* rank = reinterpret_cast<int*>(merge_smem + kLanes * kp) + warp * 32;
  for (int i = t; i < kp; i += 32) best[i] = empty_key();
  __syncwarp();
  int len = 0;  // insert_tile's count of real keys in the list
  for (int s = 0; s < splits; ++s) {
    const Key* list = partial + ((long long)s * B + b) * kk;
    for (int c0 = 0; c0 < kk; c0 += 32) {
      const Key key = (c0 + t < kk) ? list[c0 + t] : empty_key();
      if constexpr (kInsert)
        insert_tile(best, rank, key, kk, len, t);
      else
        merge_tile(best, key, kk, kp, t);
    }
  }
  for (int j = t; j < kk; j += 32) {
    const Key k = best[j];
    out_d[(long long)b * kk + j] = key_d(k);
    out_i[(long long)b * kk + j] = key_id(k);
  }
}

// Launch pass 2 on st, raising its shared-memory limit where it needs
// more than the default 48 KB.
template <int kLanes, bool kInsert>
inline cudaError_t launch_select_merge(const Key* partial, float* out_d,
                                       int* out_i, int B, int splits, int kk,
                                       int kp, cudaStream_t st) {
  const size_t smem =
      (size_t)kLanes * (kp * sizeof(Key) + (kInsert ? 32 * sizeof(int) : 0));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        select_merge_kernel<kLanes, kInsert>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = (unsigned)((B + kLanes - 1) / kLanes);
  select_merge_kernel<kLanes, kInsert><<<blocks, kLanes * 32, smem, st>>>(
      partial, out_d, out_i, B, splits, kk, kp);
  return cudaGetLastError();
}

}  // namespace rt
