// K6 pq_adc_select: fused cooperative ADC score + select. Per lane b,
// the kk lexicographically smallest (d, id) pairs over R pooled uint8 code
// rows, d = sum_j luts[b, j, codes[r, j]] summed left to right from zero;
// a row whose id is -1 is masked to (inf, -1). Output sorted by (d, id).
//
// Replaces src/repro/kernels/pq_adc_select.py (pq_adc_select_pallas /
// _pq_select_kernel with lex_min_select), the cooperative pq refinement
// step: every lane scores every code row any lane gathered this
// iteration, and only the kk best per lane leave the chip, so the [B, R]
// ADC matrix never reaches device memory. On the TPU the codes went
// through a one-hot MXU contraction; here the scoring is a gather from
// the lane's table in shared memory (as in K5). Bound on the H100:
// operations (m table reads and adds for every (lane, row) pair; the
// codes, R*m bytes, are read from device memory once per block and from
// L1 by the block's other lanes).
//
// Pass 1 (pq_select_kernel): a block owns kLanes lanes, one warp each, and
// one of `splits` slices of the pool. Each warp stages its lane's table
// (m*K f32, 16 KiB at m = 16) in shared memory, then walks the slice 32
// rows at a time: thread t reads row t's m codes (one 16-byte load at
// m = 16), scores it, and the warp sorts the 32 packed (d, id) keys as K4
// does and folds them into its running list of exactly kk keys with
// rt::insert_tile (common.cuh): at kk = 800 K4's bitonic merge would make
// every merged tile 10 passes over a 1024-key list. kk <= kMaxKK = 1024
// (the wrapper raises above it); shared memory per block is
// kLanes * (kk * 8 + 128 + m * K * 4) bytes, 178 KiB at kk = 800, m = 16.
// Pass 2 is rt::select_merge_kernel with the same fold.
// Precondition (as for the reference): real ids are distinct in the pool.
#include "common.cuh"

namespace {
constexpr int kLanes = 8;      // query lanes per block, one warp each
constexpr int kMaxKK = 1024;   // running-list capacity per lane
using rt::Key;

template <int width>
__device__ __forceinline__ float adc_row(const uint8_t* __restrict__ row,
                                         const float* lut, int m, int K) {
  float acc = 0.f;
  if constexpr (width == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      acc += lut[j * K + ((w[j >> 2] >> (8 * (j & 3))) & 0xff)];
  } else {
    for (int j = 0; j < m; ++j) acc += lut[j * K + row[j]];
  }
  return acc;
}

template <int width>
__global__ void __launch_bounds__(kLanes * 32)
pq_select_kernel(const uint8_t* __restrict__ codes,
                 const float* __restrict__ luts, const int* __restrict__ ids,
                 Key* __restrict__ partial, int B, long long R, int m, int K,
                 int kk, long long rows_per_split) {
  extern __shared__ Key smem[];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * kLanes + warp;
  if (b >= B) return;  // whole warps; no block-wide barrier below
  Key* best = smem + warp * kk;
  int* rank = reinterpret_cast<int*>(smem + kLanes * kk) + warp * 32;
  float* lut = reinterpret_cast<float*>(smem + kLanes * kk) + kLanes * 32 +
               warp * m * K;
  for (int i = t; i < kk; i += 32) best[i] = rt::empty_key();
  const float* src = luts + (long long)b * m * K;
  for (int i = t; i < m * K; i += 32) lut[i] = src[i];
  __syncwarp();
  int len = 0;  // insert_tile's count of real keys in the list

  const long long r_begin = blockIdx.y * rows_per_split;
  const long long r_end = min(R, r_begin + rows_per_split);
  for (long long r0 = r_begin; r0 < r_end; r0 += 32) {
    const long long r = r0 + t;
    Key key = rt::empty_key();
    if (r < r_end) {
      const int id = ids[r];
      if (id >= 0)
        key = rt::pack(adc_row<width>(codes + r * m, lut, m, K), id);
    }
    key = rt::warp_sort32(key, t);
    rt::insert_tile(best, rank, key, kk, len, t);
  }
  Key* out = partial + ((long long)blockIdx.y * B + b) * kk;
  for (int j = t; j < kk; j += 32) out[j] = best[j];
}

template <int width>
cudaError_t launch_select(const uint8_t* codes, const float* luts,
                          const int* ids, Key* partial, int B, long long R,
                          int m, int K, int kk, int splits, cudaStream_t st) {
  const size_t smem = (size_t)kLanes * (kk * sizeof(Key) + 32 * sizeof(int) +
                                        (size_t)m * K * sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_select_kernel<width>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  long long per = (R + splits - 1) / splits;
  per = (per + 31) / 32 * 32;
  const unsigned lane_blocks = (unsigned)((B + kLanes - 1) / kLanes);
  pq_select_kernel<width><<<dim3(lane_blocks, (unsigned)splits),
                            kLanes * 32, smem, st>>>(
      codes, luts, ids, partial, B, R, m, K, kk, per);
  return cudaGetLastError();
}
}  // namespace

// codes [R, m] uint8, luts [B, m, K] f32, ids [R] int32, partial
// [splits, B, kk] int64 scratch, out_d [B, kk] f32, out_i [B, kk] int32.
extern "C" int pq_adc_select_u8(const void* codes, const void* luts,
                                const void* ids, void* partial, void* out_d,
                                void* out_i, int B, long long R, int m, int K,
                                int kk, int splits, void* stream) {
  if (B == 0) return 0;
  if (kk < 1 || kk > kMaxKK || kk > R || splits < 1 || m < 1 || K < 1 ||
      K > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* l = static_cast<const float*>(luts);
  const int* i = static_cast<const int*>(ids);
  Key* p = static_cast<Key*>(partial);
  const cudaError_t e =
      (m == 16 && rt::aligned16(codes))
          ? launch_select<16>(c, l, i, p, B, R, m, K, kk, splits, st)
          : launch_select<0>(c, l, i, p, B, R, m, K, kk, splits, st);
  if (e != cudaSuccess) return (int)e;
  return (int)rt::launch_select_merge<kLanes, true>(
      p, static_cast<float*>(out_d), static_cast<int*>(out_i), B, splits, kk,
      kk, st);
}
