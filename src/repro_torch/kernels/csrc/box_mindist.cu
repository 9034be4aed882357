// K1 box_mindist: lb^2[b, l] = sum_d w_d * max(lo_ld - q_bd, q_bd - hi_ld, 0)^2
//
// Replaces src/repro/kernels/box_mindist.py (box_mindist_pallas /
// _box_kernel), the filter stage of every query: the lower bound of each
// leaf box (iSAX region, DSTree EAPCA range, VA+file cell) for each lane.
// Bound on the H100: bytes. The [B, L] f32 output dominates (for VA+file
// L is the collection size), then the two [L, D] box arrays.
//
// Grid: x over tiles of kBoxes boxes, y over tiles of kQueries lanes. A
// block stages its lanes' summaries and the weights in shared memory, and
// its boxes' lo then hi rows (contiguous in memory) through one buffer
// with coalesced loads; each thread lifts its own box into registers
// (MAXD = 16 or 32, chosen by D, so a 16-dim box costs 32 registers),
// then scores kUnroll lanes at a time (independent sums for the
// pipeline), reading their summaries as shared-memory broadcasts. Each
// lane's row of output is written by consecutive threads to consecutive
// addresses. Every sum runs left to right without fused multiply-adds,
// the order of the plain version.
//
// D > 32 (box_mindist_wide_kernel): the same block walks D in chunks of
// 32 dims. For each chunk it stages the lanes' and the boxes' columns,
// lifts the chunk of its box into registers, and adds the chunk's terms
// to each lane's running sum, which waits in the output between chunks
// (the thread that owns the element reads back what it wrote). A float
// sum continued from its stored f32 value is the same left-to-right sum,
// so the result stays bit-equal to the plain version; the output is
// read and written once more per chunk after the first.
#include "common.cuh"

namespace {
constexpr int kBoxes = 128;    // boxes per block, one per thread
constexpr int kQueries = 128;  // lanes staged per block
constexpr int kUnroll = 4;     // lanes scored together

__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           float* buf, long long l0, int nb,
                                           int D) {
  const int stride = D + 1;  // odd stride: conflict-free row reads
  for (int e = threadIdx.x; e < nb * D; e += kBoxes) {
    const int r = e / D, c = e - r * D;
    buf[r * stride + c] = src[l0 * D + e];
  }
}
}  // namespace

template <int MAXD>
__global__ void __launch_bounds__(kBoxes)
box_mindist_kernel(const float* __restrict__ q, const float* __restrict__ lo,
                   const float* __restrict__ hi, const float* __restrict__ w,
                   float* __restrict__ out, int B, long long L, int D) {
  __shared__ float box_s[kBoxes * (MAXD + 1)];
  __shared__ float q_s[kQueries * MAXD];
  __shared__ float w_s[MAXD];
  const long long l0 = (long long)blockIdx.x * kBoxes;
  const int b0 = blockIdx.y * kQueries;
  const int nb = (int)min((long long)kBoxes, L - l0);
  const int nq = min(kQueries, B - b0);
  const int t = threadIdx.x;
  for (int e = t; e < nq * D; e += kBoxes) q_s[e] = q[(long long)b0 * D + e];
  if (t < D) w_s[t] = w[t];

  float lo_r[MAXD], hi_r[MAXD];
  stage_rows(lo, box_s, l0, nb, D);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < MAXD; ++d)
    if (d < D && t < nb) lo_r[d] = box_s[t * (D + 1) + d];
  __syncthreads();
  stage_rows(hi, box_s, l0, nb, D);
  __syncthreads();
#pragma unroll
  for (int d = 0; d < MAXD; ++d)
    if (d < D && t < nb) hi_r[d] = box_s[t * (D + 1) + d];
  if (t >= nb) return;  // no barrier below

  float* o = out + (long long)b0 * L + l0 + t;
  int b = 0;
  for (; b + kUnroll <= nq; b += kUnroll) {
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < D) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float qd = q_s[(b + u) * D + d];
          const float g = fmaxf(fmaxf(lo_r[d] - qd, qd - hi_r[d]), 0.f);
          acc[u] = __fadd_rn(acc[u], __fmul_rn(__fmul_rn(g, g), w_s[d]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) o[(long long)(b + u) * L] = acc[u];
  }
  for (; b < nq; ++b) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      if (d < D) {
        const float qd = q_s[b * D + d];
        const float g = fmaxf(fmaxf(lo_r[d] - qd, qd - hi_r[d]), 0.f);
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(g, g), w_s[d]));
      }
    }
    o[(long long)b * L] = acc;
  }
}


// D > 32: chunks of kChunk dims, the running sum kept in the output
constexpr int kChunk = 32;

__global__ void __launch_bounds__(kBoxes)
box_mindist_wide_kernel(const float* __restrict__ q,
                        const float* __restrict__ lo,
                        const float* __restrict__ hi,
                        const float* __restrict__ w, float* __restrict__ out,
                        int B, long long L, int D) {
  __shared__ float box_s[kBoxes * (kChunk + 1)];
  __shared__ float q_s[kQueries * kChunk];
  __shared__ float w_s[kChunk];
  const long long l0 = (long long)blockIdx.x * kBoxes;
  const int b0 = blockIdx.y * kQueries;
  const int nb = (int)min((long long)kBoxes, L - l0);
  const int nq = min(kQueries, B - b0);
  const int t = threadIdx.x;
  const bool own = t < nb;
  float* o = out + (long long)b0 * L + l0 + t;
  float lo_r[kChunk], hi_r[kChunk];
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    const int dc = min(kChunk, D - c0);
    const int stride = dc + 1;  // odd stride: conflict-free row reads
    __syncthreads();  // the previous chunk is done with the buffers
    for (int e = t; e < nq * dc; e += kBoxes) {
      const int r = e / dc, c = e - r * dc;
      q_s[e] = q[(long long)(b0 + r) * D + c0 + c];
    }
    if (t < dc) w_s[t] = w[c0 + t];
    for (int e = t; e < nb * dc; e += kBoxes) {
      const int r = e / dc, c = e - r * dc;
      box_s[r * stride + c] = lo[(l0 + r) * D + c0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kChunk; ++d)
      if (d < dc && own) lo_r[d] = box_s[t * stride + d];
    __syncthreads();
    for (int e = t; e < nb * dc; e += kBoxes) {
      const int r = e / dc, c = e - r * dc;
      box_s[r * stride + c] = hi[(l0 + r) * D + c0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kChunk; ++d)
      if (d < dc && own) hi_r[d] = box_s[t * stride + d];
    if (!own) continue;  // every barrier sits at the loop's top
    int b = 0;
    for (; b + kUnroll <= nq; b += kUnroll) {
      float acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        acc[u] = c0 ? o[(long long)(b + u) * L] : 0.f;
#pragma unroll
      for (int d = 0; d < kChunk; ++d) {
        if (d < dc) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float qd = q_s[(b + u) * dc + d];
            const float g = fmaxf(fmaxf(lo_r[d] - qd, qd - hi_r[d]), 0.f);
            acc[u] = __fadd_rn(acc[u], __fmul_rn(__fmul_rn(g, g), w_s[d]));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) o[(long long)(b + u) * L] = acc[u];
    }
    for (; b < nq; ++b) {
      float acc = c0 ? o[(long long)b * L] : 0.f;
#pragma unroll
      for (int d = 0; d < kChunk; ++d) {
        if (d < dc) {
          const float qd = q_s[b * dc + d];
          const float g = fmaxf(fmaxf(lo_r[d] - qd, qd - hi_r[d]), 0.f);
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(g, g), w_s[d]));
        }
      }
      o[(long long)b * L] = acc;
    }
  }
}

extern "C" int box_mindist_f32(const void* q, const void* lo, const void* hi,
                               const void* w, void* out, int B, long long L,
                               int D, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((L + kBoxes - 1) / kBoxes),
                  (unsigned)((B + kQueries - 1) / kQueries));
  cudaStream_t st = (cudaStream_t)stream;
  const float* qf = static_cast<const float*>(q);
  const float* lof = static_cast<const float*>(lo);
  const float* hif = static_cast<const float*>(hi);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (D <= 16)
    box_mindist_kernel<16><<<grid, kBoxes, 0, st>>>(qf, lof, hif, wf, of, B,
                                                    L, D);
  else if (D <= 32)
    box_mindist_kernel<32><<<grid, kBoxes, 0, st>>>(qf, lof, hif, wf, of, B,
                                                    L, D);
  else
    box_mindist_wide_kernel<<<grid, kBoxes, 0, st>>>(qf, lof, hif, wf, of, B,
                                                     L, D);
  return (int)cudaGetLastError();
}
