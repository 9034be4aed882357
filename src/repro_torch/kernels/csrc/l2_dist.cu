// K3 l2: out[b, m] = max(|q_b|^2 - 2 q_b.x_m + |x_m|^2, 0), f32 accumulation.
//
// Replaces src/repro/kernels/l2_dist.py (l2_pallas / _l2_kernel), the
// brute-force yardstick's distance pass over the whole collection.
// Bound on the H100: operations at the shapes of the main path (2*B*n
// flops for every row read once; B = 100 puts it above the f32 ridge of
// 67 TFLOP/s over 3.35 TB/s).
//
// A tiled SIMT GEMM in IEEE f32 FMAs: no TF32 and no tensor cores,
// because exact answers compare these distances. A block owns a tile of
// kBB lanes by kBM rows and walks n in chunks of kKC, staging both tiles
// k-major in shared memory; each thread accumulates a 4 x 8 register
// tile whose columns are two float4-wide stripes, so the shared-memory
// reads are 16 bytes a thread without bank conflicts. The two norm terms
// come from the same staged tiles (threads 0..kBM-1 square the rows,
// kBM..kBM+kBB-1 the lanes), so no separate pass reads the data again.
// bf16 rows are read as bf16 and widened in registers.
#include "common.cuh"

namespace {
constexpr int kBB = 64;   // lanes per block
constexpr int kBM = 128;  // rows per block
constexpr int kKC = 16;   // depth per staged chunk
constexpr int kThreads = 256;

__device__ __forceinline__ void load8(const float* row, int k, int n,
                                      bool vec, float* v) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + k));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + k + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (k + j < n) ? __ldg(row + k + j) : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int k, int n,
                                      bool vec, float* v) {
  if (vec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + k));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (k + j < n) ? __bfloat162float(row[k + j]) : 0.f;
  }
}
}  // namespace

template <typename TX>
__global__ void __launch_bounds__(kThreads)
l2_kernel(const float* __restrict__ q, const TX* __restrict__ x,
          float* __restrict__ out, int B, long long M, int n, bool vec) {
  __shared__ __align__(16) float qs[kKC][kBB];
  __shared__ __align__(16) float xs[kKC][kBM];
  __shared__ float qn_s[kBB];
  __shared__ float xn_s[kBM];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int b0 = blockIdx.y * kBB;
  // loaders: row tile kBM x kKC (8 per thread), lane tile kBB x kKC (4)
  const int xr = tid >> 1, xc = (tid & 1) * 8;
  const int qr = tid >> 2, qc = (tid & 3) * 4;
  const long long gm = m0 + xr;
  const int gb = b0 + qr;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;

  for (int k0 = 0; k0 < n; k0 += kKC) {
    float v[8];
    if (gm < M) {
      load8(x + gm * n, k0 + xc, n, vec, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) xs[xc + j][xr] = v[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + qc + j;
      qs[qc + j][qr] = (gb < B && k < n) ? q[(long long)gb * n + k] : 0.f;
    }
    __syncthreads();
    if (tid < kBM) {
#pragma unroll
      for (int c = 0; c < kKC; ++c) nrm = fmaf(xs[c][tid], xs[c][tid], nrm);
    } else if (tid < kBM + kBB) {
#pragma unroll
      for (int c = 0; c < kKC; ++c)
        nrm = fmaf(qs[c][tid - kBM], qs[c][tid - kBM], nrm);
    }
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[c][ty * 4]);
      const float4 p = *reinterpret_cast<const float4*>(&xs[c][tx * 4]);
      const float4 r = *reinterpret_cast<const float4*>(&xs[c][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {p.x, p.y, p.z, p.w, r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kBM) {
    xn_s[tid] = nrm;
  } else if (tid < kBM + kBB) {
    qn_s[tid - kBM] = nrm;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    if (b >= B) continue;
    const float qn = qn_s[ty * 4 + i];
    float* o = out + (long long)b * M;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int mc = (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
      const long long m = m0 + mc;
      if (m >= M) continue;
      const float d = (qn - 2.f * acc[i][j]) + xn_s[mc];
      o[m] = d > 0.f ? d : 0.f;
    }
  }
}

template <typename TX>
static int launch(const void* q, const void* x, void* out, int B,
                  long long M, int n, void* stream) {
  if (B == 0 || M == 0) return 0;
  // whole 16-byte loads only when every chunk lies inside its row
  const bool vec = (n % kKC == 0) && rt::aligned16(x);
  const dim3 grid((unsigned)((M + kBM - 1) / kBM),
                  (unsigned)((B + kBB - 1) / kBB));
  l2_kernel<TX><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const TX*>(x),
      static_cast<float*>(out), B, M, n, vec);
  return (int)cudaGetLastError();
}

extern "C" int l2_f32(const void* q, const void* x, void* out, int B,
                      long long M, int n, void* stream) {
  return launch<float>(q, x, out, B, M, n, stream);
}

extern "C" int l2_bf16(const void* q, const void* x, void* out, int B,
                       long long M, int n, void* stream) {
  return launch<__nv_bfloat16>(q, x, out, B, M, n, stream);
}
