// The tiled SIMT GEMM shared by K3 (l2_dist.cu) and K4's score pass
// (topk.cu): out[b, m] = max(|q_b|^2 - 2 q_b.x_m + |x_m|^2, 0), f32.
//
// IEEE f32 FMAs only: no TF32 and no tensor cores, because exact
// answers compare these distances. Each dot product runs over k from 0
// up, one FMA at a time, as a sequential loop would.
//
// A block owns kBB = 104 lanes by kBM = 128 rows (104 = 13 x 8 holds
// the main path's 100 lanes with 4% padding; a 64-lane tile would pad
// them by 28%) and walks n in stages of kKC dims. Both tiles are staged
// row-major in shared memory with a stride of kLd floats: 16-byte reads
// along k by 8 consecutive rows hit 8 distinct bank groups. A thread
// holds a kLT x kRT = 13 x 4 register tile (lanes ty + 8i, rows
// tx + 32j); a warp covers 4 ty by 8 tx, so each 16-byte read serves a
// quarter of the warp with one address and every read is one wavefront:
// 17 shared-memory reads per 208 FMAs. Stages are double-buffered: f32
// rows whose 16-byte chunks are aligned come in by cp.async, so the next
// stage's loads overlap this stage's FMAs; bf16 rows, and f32 rows
// that are not aligned, are loaded through registers and widened.
//
// kRowNorms: |x_m|^2 comes from the caller (K4 passes the index's cached
// norms, the ones the solo path scores with); otherwise the block squares
// the staged rows (K3). |q_b|^2 always comes from the staged lanes.
#pragma once

#include "common.cuh"

namespace gemm {

constexpr int kLT = 13;              // lanes per thread
constexpr int kRT = 4;               // rows per thread
constexpr int kTY = 8;               // thread groups along the lanes
constexpr int kTX = 32;              // thread groups along the rows
constexpr int kThreads = kTY * kTX;  // 256
constexpr int kBB = kTY * kLT;       // 104 lanes per block
constexpr int kBM = kTX * kRT;       // 128 rows per block
constexpr int kKC = 16;              // dims per stage
constexpr int kLd = kKC + 4;         // padded row stride, floats
static_assert(kBM + kBB <= kThreads, "one norm per thread");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage rows [r0, r0 + nrows) x dims [k0, k0 + kKC) of src [R, n] into
// dst [nrows][kLd], zero outside the matrix. vec: f32 with n % 4 == 0
// and a 16-byte aligned base (cp.async); otherwise through registers.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long r0, int nrows, long long R,
                                      int n, int k0, bool vec) {
  constexpr int kQuads = kKC / 4;
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      for (int e = threadIdx.x; e < nrows * kQuads; e += kThreads) {
        const int r = e / kQuads, c = (e - r * kQuads) * 4;
        const long long gr = r0 + r;
        const bool ok = gr < R && k0 + c < n;
        cp_async16(dst + r * kLd + c,
                   reinterpret_cast<const float*>(src) +
                       (ok ? gr * n + k0 + c : 0),
                   ok);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < nrows * kKC; e += kThreads) {
    const int r = e / kKC, c = e - r * kKC;
    const long long gr = r0 + r;
    dst[r * kLd + c] =
        (gr < R && k0 + c < n) ? rt::to_f32(src[gr * n + k0 + c]) : 0.f;
  }
}

// out [B, M] row-major; x [M, n] of TX (f32 or bf16); q [B, n] f32;
// row_norms [M] f32 when kRowNorms.
template <typename TX, bool kRowNorms>
__global__ void __launch_bounds__(kThreads, 2)
l2_tile_kernel(const float* __restrict__ q, const TX* __restrict__ x,
               const float* __restrict__ row_norms, float* __restrict__ out,
               int B, long long M, int n, bool vec) {
  __shared__ __align__(16) float qs[2][kBB * kLd];
  __shared__ __align__(16) float xs[2][kBM * kLd];
  __shared__ float qn_s[kBB];
  __shared__ float xn_s[kBM];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, l = tid & 31;
  const int ty = (warp >> 2) * 4 + (l >> 3);  // 0..7
  const int tx = (warp & 3) * 8 + (l & 7);    // 0..31
  const long long m0 = (long long)blockIdx.x * kBM;
  const int b0 = blockIdx.y * kBB;
  const bool xvec = vec && sizeof(TX) == 4;

  float acc[kLT][kRT];
#pragma unroll
  for (int i = 0; i < kLT; ++i)
#pragma unroll
    for (int j = 0; j < kRT; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // thread t < kBM: row t's norm; next kBB: a lane's

  const int stages = (n + kKC - 1) / kKC;
  stage(qs[0], q, b0, kBB, B, n, 0, vec);
  stage(xs[0], x, m0, kBM, M, n, 0, xvec);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    const int cur = s & 1;
    if (s + 1 < stages) {
      stage(qs[cur ^ 1], q, b0, kBB, B, n, (s + 1) * kKC, vec);
      stage(xs[cur ^ 1], x, m0, kBM, M, n, (s + 1) * kKC, xvec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qb = qs[cur];
    const float* xb = xs[cur];
    if (tid < kBM || tid - kBM < kBB) {
      const float* v = tid < kBM ? xb + tid * kLd : qb + (tid - kBM) * kLd;
      if (tid >= kBM || !kRowNorms) {
#pragma unroll
        for (int c = 0; c < kKC; c += 4) {
          const float4 a = *reinterpret_cast<const float4*>(v + c);
          nrm = fmaf(a.x, a.x, nrm);
          nrm = fmaf(a.y, a.y, nrm);
          nrm = fmaf(a.z, a.z, nrm);
          nrm = fmaf(a.w, a.w, nrm);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kKC; c += 4) {
      float4 xv[kRT];
#pragma unroll
      for (int j = 0; j < kRT; ++j)
        xv[j] =
            *reinterpret_cast<const float4*>(xb + (tx + kTX * j) * kLd + c);
#pragma unroll
      for (int i = 0; i < kLT; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(qb + (ty + kTY * i) * kLd + c);
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
          acc[i][j] = fmaf(a.x, xv[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, xv[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, xv[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, xv[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (tid < kBM) {
    if constexpr (kRowNorms) {
      const long long m = m0 + tid;
      xn_s[tid] = m < M ? row_norms[m] : 0.f;
    } else {
      xn_s[tid] = nrm;
    }
  } else if (tid - kBM < kBB) {
    qn_s[tid - kBM] = nrm;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLT; ++i) {
    const int b = b0 + ty + kTY * i;
    if (b >= B) continue;
    const float qn = qn_s[ty + kTY * i];
    float* o = out + (long long)b * M;
#pragma unroll
    for (int j = 0; j < kRT; ++j) {
      const int mc = tx + kTX * j;
      const long long m = m0 + mc;
      if (m >= M) continue;
      const float d = (qn - 2.f * acc[i][j]) + xn_s[mc];
      o[m] = d > 0.f ? d : 0.f;
    }
  }
}

// Launch on stream; returns cudaGetLastError().
template <typename TX, bool kRowNorms>
inline cudaError_t launch_l2_tile(const float* q, const TX* x,
                                  const float* row_norms, float* out, int B,
                                  long long M, int n, cudaStream_t st) {
  if (B == 0 || M == 0) return cudaSuccess;
  const bool vec = (n % 4 == 0) && rt::aligned16(q) && rt::aligned16(x);
  const dim3 grid((unsigned)((M + kBM - 1) / kBM),
                  (unsigned)((B + kBB - 1) / kBB));
  l2_tile_kernel<TX, kRowNorms><<<grid, kThreads, 0, st>>>(
      q, x, row_norms, out, B, M, n, vec);
  return cudaGetLastError();
}

}  // namespace gemm
