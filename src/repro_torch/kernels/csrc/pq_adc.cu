// K5 pq_adc_batch: the PQ asymmetric distance scan,
// out[b, i] = sum_j luts[b, j, codes[b, i, j]], summed left to right from
// zero in f32 (the plain version's order, so the two agree bit for bit).
// codes are uint8, [B, M, m] per lane or [M, m] shared by every lane (a
// lane stride of zero); luts [B, m, K] f32.
//
// Replaces src/repro/kernels/pq_adc.py (pq_adc_pallas / _adc_kernel). The
// TPU kernel expanded each code tile to a one-hot matrix and contracted it
// on the MXU, because the TPU has no fast gather; on Hopper the natural
// form is the gather itself. A block serves one lane and a run of rows:
// it stages the lane's table (m*K*4 bytes, 16 KiB at m = 16, K = 256) in
// shared memory, and each thread scores whole rows, reading a row's m
// codes in one vector load (16 B at m = 16, 8 B at m = 8) and summing
// m table entries from shared memory. Bound on the H100: bytes (the codes
// are read once, one f32 is written per row; the table reads hit shared
// memory). A block scores at least kRowsPerBlock rows, and more when the
// grid would exceed kTargetBlocks, so that a shared row set scored
// against many lanes (K6's score pass: 100 lanes x 25,600 rows) stages
// each table a few hundred times per call, not thousands.
#include "common.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 1024;
constexpr long long kTargetBlocks = 512;

// width: 16 or 8 = m with a vector load of the row, 0 = any m, byte loads
template <int width>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const uint8_t* __restrict__ codes,
              const float* __restrict__ luts, float* __restrict__ out,
              long long M, int m, int K, long long lane_stride,
              long long rows_per_block) {
  extern __shared__ float lut[];
  const int b = blockIdx.y;
  const float* src = luts + (long long)b * m * K;
  for (int i = threadIdx.x; i < m * K; i += kThreads) lut[i] = src[i];
  __syncthreads();
  const uint8_t* lane = codes + (long long)b * lane_stride;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += kThreads) {
    const uint8_t* row = lane + r * m;
    float acc = 0.f;
    if constexpr (width == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc += lut[j * K + ((w[j >> 2] >> (8 * (j & 3))) & 0xff)];
    } else if constexpr (width == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(row);
      const unsigned w[2] = {v.x, v.y};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc += lut[j * K + ((w[j >> 2] >> (8 * (j & 3))) & 0xff)];
    } else {
      for (int j = 0; j < m; ++j) acc += lut[j * K + row[j]];
    }
    out[(long long)b * M + r] = acc;
  }
}

template <int width>
cudaError_t launch(const uint8_t* codes, const float* luts, float* out,
                   int B, long long M, int m, int K, long long lane_stride,
                   cudaStream_t st) {
  const size_t smem = (size_t)m * K * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_adc_kernel<width>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  long long per = (M * B + kTargetBlocks - 1) / kTargetBlocks;
  per = max((long long)kRowsPerBlock,
            (per + kThreads - 1) / kThreads * kThreads);
  const dim3 grid((unsigned)((M + per - 1) / per), (unsigned)B);
  pq_adc_kernel<width><<<grid, kThreads, smem, st>>>(codes, luts, out, M, m,
                                                      K, lane_stride, per);
  return cudaGetLastError();
}
}  // namespace

// codes: [B, M, m] uint8 (shared = 0) or [M, m] (shared = 1); luts
// [B, m, K] f32; out [B, M] f32.
extern "C" int pq_adc_u8(const void* codes, const void* luts, void* out,
                         int B, long long M, int m, int K, int shared,
                         void* stream) {
  if (B == 0 || M == 0) return 0;
  if (m < 1 || K < 1 || K > 256) return (int)cudaErrorInvalidValue;
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* l = static_cast<const float*>(luts);
  float* o = static_cast<float*>(out);
  const long long stride = shared ? 0 : M * m;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (m == 16 && rt::aligned16(codes))
    e = launch<16>(c, l, o, B, M, m, K, stride, st);
  else if (m == 8 && (reinterpret_cast<uintptr_t>(codes) & 7) == 0)
    e = launch<8>(c, l, o, B, M, m, K, stride, st);
  else
    e = launch<0>(c, l, o, B, M, m, K, stride, st);
  return (int)e;
}
