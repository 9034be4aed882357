// K4 coop_score_select: per lane, the kk lexicographically smallest
// (d, id) pairs over R pooled rows, d = max(|q|^2 - 2 q.x + |x|^2, 0)
// with the row norms passed in; a row whose id is -1 is masked to
// (inf, -1). Output sorted by (d, id).
//
// Replaces src/repro/kernels/topk.py (coop_score_select_pallas /
// _coop_topk_kernel and lex_min_select), the cooperative
// (share_gathers) refinement step: every lane scores every row gathered
// by any lane this iteration, and keeps only its best kk. Bound on the
// H100: operations (2*B*n flops for every pooled row read once; the
// [B, R] distance matrix never leaves the chip).
//
// Pass 1 (coop_score_kernel): a block owns kLanes lanes, one warp each,
// and one of `splits` slices of the pool, walked in tiles of 32 rows.
// Each tile is staged in shared memory in chunks of kKC dims and read by
// all the block's lanes; thread t of a warp scores row t of the tile for
// the warp's lane. The 32 candidates are packed into 64-bit (d, id)
// keys, sorted across the warp and merged into the lane's running list of
// kp keys in shared memory (merge_tile in common.cuh). Each block
// writes its lanes' kk best keys for its slice to a scratch buffer.
// Pass 2 (rt::select_merge_kernel): a warp per lane merges the slices'
// sorted lists 32 keys at a time with the same merge, and unpacks them.
// Splitting the pool gives the card enough blocks at small lane counts.
// Limit: kk <= kMaxKP (256); the wrapper raises above it.
// Precondition (as for the reference): real ids are distinct in the pool.
#include "common.cuh"

namespace {
constexpr int kLanes = 8;     // query lanes per block, one warp each
constexpr int kRows = 32;     // pooled rows per tile, one per thread
constexpr int kKC = 128;      // dims per staged chunk
constexpr int kMaxKP = 256;   // running-list capacity per lane
using rt::Key;
using rt::kFull;
}  // namespace

template <typename TR>
__global__ void __launch_bounds__(kLanes * 32)
coop_score_kernel(const float* __restrict__ q, const TR* __restrict__ rows,
                  const float* __restrict__ norms,
                  const int* __restrict__ ids, Key* __restrict__ partial,
                  int B, long long R, int n, int kk, int kp,
                  long long rows_per_split) {
  __shared__ Key best[kLanes][kMaxKP];
  __shared__ float rs[kRows][kKC + 1];
  __shared__ float qs[kLanes][kKC];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * kLanes + warp;
  const long long r_begin = blockIdx.y * rows_per_split;
  const long long r_end = min(R, r_begin + rows_per_split);
  for (int i = t; i < kp; i += 32) best[warp][i] = rt::empty_key();

  float qn = 0.f;
  if (b < B) {
    for (int c = t; c < n; c += 32) {
      const float v = q[(long long)b * n + c];
      qn = fmaf(v, v, qn);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qn += __shfl_xor_sync(kFull, qn, o);

  for (long long r0 = r_begin; r0 < r_end; r0 += kRows) {
    float acc = 0.f;
    for (int k0 = 0; k0 < n; k0 += kKC) {
      for (int e = threadIdx.x; e < kRows * kKC; e += kLanes * 32) {
        const int r = e / kKC, c = e - r * kKC;
        const long long gr = r0 + r;
        const int gc = k0 + c;
        rs[r][c] =
            (gr < r_end && gc < n) ? rt::to_f32(rows[gr * n + gc]) : 0.f;
      }
      for (int e = threadIdx.x; e < kLanes * kKC; e += kLanes * 32) {
        const int l = e / kKC, c = e - l * kKC;
        const int gb = blockIdx.x * kLanes + l;
        const int gc = k0 + c;
        qs[l][c] = (gb < B && gc < n) ? q[(long long)gb * n + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll 16
      for (int c = 0; c < kKC; ++c) acc = fmaf(qs[warp][c], rs[t][c], acc);
      __syncthreads();
    }

    const long long gr = r0 + t;
    Key key = rt::empty_key();
    if (gr < r_end) {
      const int id = ids[gr];
      if (id >= 0) {
        const float d = (qn - 2.f * acc) + norms[gr];
        key = rt::pack(d > 0.f ? d : 0.f, id);
      }
    }
    key = rt::warp_sort32(key, t);
    rt::merge_tile(best[warp], key, kk, kp, t);
  }
  if (b < B) {
    Key* out = partial + ((long long)blockIdx.y * B + b) * kk;
    for (int j = t; j < kk; j += 32) out[j] = best[warp][j];
  }
}

template <typename TR>
static int launch(const void* q, const void* rows, const void* norms,
                  const void* ids, void* partial, void* out_d, void* out_i,
                  int B, long long R, int n, int kk, int splits,
                  void* stream) {
  if (B == 0) return 0;
  if (kk < 1 || kk > kMaxKP || kk > R || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int kp = rt::list_capacity(kk);
  long long per = (R + splits - 1) / splits;
  per = (per + kRows - 1) / kRows * kRows;
  const unsigned lane_blocks = (unsigned)((B + kLanes - 1) / kLanes);
  cudaStream_t st = (cudaStream_t)stream;
  coop_score_kernel<TR><<<dim3(lane_blocks, (unsigned)splits), kLanes * 32,
                          0, st>>>(
      static_cast<const float*>(q), static_cast<const TR*>(rows),
      static_cast<const float*>(norms), static_cast<const int*>(ids),
      static_cast<Key*>(partial), B, R, n, kk, kp, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rt::launch_select_merge<kLanes, false>(
      static_cast<const Key*>(partial), static_cast<float*>(out_d),
      static_cast<int*>(out_i), B, splits, kk, kp, st);
}

extern "C" int coop_score_select_f32(const void* q, const void* rows,
                                     const void* norms, const void* ids,
                                     void* partial, void* out_d,
                                     void* out_i, int B, long long R, int n,
                                     int kk, int splits, void* stream) {
  return launch<float>(q, rows, norms, ids, partial, out_d, out_i, B, R, n,
                       kk, splits, stream);
}

extern "C" int coop_score_select_bf16(const void* q, const void* rows,
                                      const void* norms, const void* ids,
                                      void* partial, void* out_d,
                                      void* out_i, int B, long long R, int n,
                                      int kk, int splits, void* stream) {
  return launch<__nv_bfloat16>(q, rows, norms, ids, partial, out_d, out_i, B,
                               R, n, kk, splits, stream);
}
