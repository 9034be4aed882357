// The tiled SIMT GEMM shared by K3 (l2_dist.cu) and K4's score pass
// (topk.cu): out[b, m] = max(|q_b|^2 - 2 q_b.x_m + |x_m|^2, 0), f32.
//
// IEEE f32 FMAs only: no TF32 and no tensor cores, because exact
// answers compare these distances. Each dot product runs over k from 0
// up, one FMA at a time, as a sequential loop would, whatever the tile:
// a score does not depend on which block computed it.
//
// A block owns kTY * kLT lanes by kBM = 128 rows and walks n in stages
// of kKC dims. K3 and K4 at a batch of at most 104 take kLT = 13 (104 =
// 13 x 8 holds the main path's 100 lanes with 4% padding; a 64-lane tile
// would pad them by 28%); K4 at a batch that 128-lane tiles pad less
// takes kLT = 16 (B = 256: none, where 104 padded 18%). Both tiles are
// staged row-major in shared memory with a stride of kLd floats: 16-byte
// reads along k by 8 consecutive rows hit 8 distinct bank groups. A
// thread holds a kLT x kRT register tile (lanes ty + 8i, rows tx + 32j);
// a warp covers 4 ty by 8 tx, so each 16-byte read serves a quarter of
// the warp with one address and every read is one wavefront: 17 shared-
// memory reads per 208 FMAs at kLT = 13, 20 per 256 at 16. Stages are
// double-buffered: f32 rows whose 16-byte chunks are aligned come in by
// cp.async, so the next stage's loads overlap this stage's FMAs; bf16
// rows, and f32 rows that are not aligned, are loaded through registers
// and widened.
//
// kRowNorms (K4 alone): |x_m|^2 comes from the caller (the index's cached
// norms, the ones the solo path scores with), slot m's row is
// x[index[m]] (x itself without an index), and the grid is one dimension
// with the lane tiles of a row tile next to each other, so a row's second
// read comes from L2. The block first sends its lanes' first stage, then
// reads its slots' ids, rows and norms (one latency); a block whose 128
// slots all carry a negative id returns there and writes nothing: the
// selection (lex_select.cu) takes such a slot as (inf, id) without
// reading its score. Masked slots of a scored tile are staged as zeros,
// not read. The lane tile is a kernel argument, not a template
// parameter, so the pass stays the one kernel l2_tile_kernel<float,
// true> (the benchmark's K4 metrics find it by that name). Otherwise
// (K3) the block squares the staged rows for |x_m|^2 and the grid is
// (row tiles, lane tiles). |q_b|^2 always comes from the staged lanes.
#pragma once

#include "common.cuh"

namespace gemm {

constexpr int kLT = 13;              // lanes per thread (K3; K4 at B <= 104)
constexpr int kLTWide = 16;          // lanes per thread (K4, wide batches)
constexpr int kRT = 4;               // rows per thread
constexpr int kTY = 8;               // thread groups along the lanes
constexpr int kTX = 32;              // thread groups along the rows
constexpr int kThreads = kTY * kTX;  // 256
constexpr int kBM = kTX * kRT;       // 128 rows per block
constexpr int kKC = 16;              // dims per stage
constexpr int kLd = kKC + 4;         // padded row stride, floats
static_assert(kBM + kTY * kLTWide <= kThreads, "one norm per thread");

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

// Stage nrows rows x dims [k0, k0 + kKC) of src [*, n] into dst
// [nrows][kLd]. Local row r is src row r0 + r while that is below R, or,
// with a row map, src row rmap[r] (-1: none); zero where there is no row
// or past n. vec: f32 with n % 4 == 0 and a 16-byte aligned base
// (cp.async); otherwise through registers.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      const long long* rmap, long long r0,
                                      int nrows, long long R, int n, int k0,
                                      bool vec) {
  auto row = [&](int r) -> long long {
    if (rmap != nullptr) return rmap[r];
    return r0 + r < R ? r0 + r : -1;
  };
  constexpr int kQuads = kKC / 4;
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      for (int e = threadIdx.x; e < nrows * kQuads; e += kThreads) {
        const int r = e / kQuads, c = (e - r * kQuads) * 4;
        const long long gr = row(r);
        const bool ok = gr >= 0 && k0 + c < n;
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
    const long long gr = row(r);
    dst[r * kLd + c] =
        (gr >= 0 && k0 + c < n) ? rt::to_f32(src[gr * n + k0 + c]) : 0.f;
  }
}

// One block's tile: lanes [b0, b0 + kTY * kL) by rows [m0, m0 + kBM) of
// out [B, M]; qs and xs are two stage buffers each, qstride and
// kBM * kLd floats apart. kRowNorms: the caller has staged the lanes'
// first stage (not yet committed), put the rows' norms in xn_s and the
// row tile's rows in rmap (-1: a masked slot).
template <typename TX, bool kRowNorms, int kL>
__device__ __forceinline__ void tile(
    const float* __restrict__ q, const TX* __restrict__ x,
    const long long* rmap, float* __restrict__ out, int B, long long M,
    int n, bool vec, long long m0, int b0, float* qs, int qstride,
    float* xs, float* qn_s, float* xn_s) {
  constexpr int kBB = kTY * kL;  // lanes per block
  // K4's tiles unrolled over a whole stage spill past 128 registers (the
  // row addresses and, at kLTWide, 64 sums); one 4-dim step at a time
  // they do not. K3 keeps its whole stage unrolled.
  constexpr int kUnroll = kRowNorms ? 1 : kKC / 4;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, l = tid & 31;
  const int ty = (warp >> 2) * 4 + (l >> 3);  // 0..7
  const int tx = (warp & 3) * 8 + (l & 7);    // 0..31
  const bool xvec = vec && sizeof(TX) == 4;

  float acc[kL][kRT];
#pragma unroll
  for (int i = 0; i < kL; ++i)
#pragma unroll
    for (int j = 0; j < kRT; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;  // thread t < kBM: row t's norm; next kBB: a lane's

  // K4's aligned f32 rows: a thread's two 16-byte chunks of every stage
  // lie in two fixed rows, whose addresses are taken from rmap once
  static_assert(kBM * (kKC / 4) == 2 * kThreads, "two chunks a thread");
  const int cq = (tid & 3) * 4;
  const float* xp[2] = {nullptr, nullptr};
  bool xok[2] = {false, false};
  if constexpr (kRowNorms) {
    if (xvec) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long long gr = rmap[(tid >> 2) + kBM / 2 * k];
        xok[k] = gr >= 0;
        xp[k] = reinterpret_cast<const float*>(x) + (xok[k] ? gr * n : 0) +
                cq;
      }
    }
  }
  auto stage_x = [&](float* dst, int k0) {
    if constexpr (kRowNorms) {
      if (xvec) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const bool ok = xok[k] && k0 + cq < n;
          cp_async16(dst + ((tid >> 2) + kBM / 2 * k) * kLd + cq,
                     xp[k] + (ok ? k0 : 0), ok);
        }
        return;
      }
    }
    stage(dst, x, rmap, m0, kBM, M, n, k0, xvec);
  };

  const int stages = (n + kKC - 1) / kKC;
  if constexpr (!kRowNorms) stage(qs, q, nullptr, b0, kBB, B, n, 0, vec);
  stage_x(xs, 0);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    const int cur = s & 1;
    if (s + 1 < stages) {
      stage(qs + (cur ^ 1) * qstride, q, nullptr, b0, kBB, B, n,
            (s + 1) * kKC, vec);
      stage_x(xs + (cur ^ 1) * kBM * kLd, (s + 1) * kKC);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qb = qs + cur * qstride;
    const float* xb = xs + cur * kBM * kLd;
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
#pragma unroll kUnroll
    for (int c = 0; c < kKC; c += 4) {
      float4 xv[kRT];
#pragma unroll
      for (int j = 0; j < kRT; ++j)
        xv[j] =
            *reinterpret_cast<const float4*>(xb + (tx + kTX * j) * kLd + c);
#pragma unroll
      for (int i = 0; i < kL; ++i) {
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
    if constexpr (!kRowNorms) xn_s[tid] = nrm;  // K4's came with rmap
  } else if (tid - kBM < kBB) {
    qn_s[tid - kBM] = nrm;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kL; ++i) {
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

// out [B, M] row-major; x [*, n] of TX (f32 or bf16); q [B, n] f32.
// kRowNorms: row_norms [M] f32, ids [M] int32, index [M] int64 into x or
// null, lanes (kTY * kLT or kTY * kLTWide) lanes a block.
template <typename TX, bool kRowNorms>
__global__ void __launch_bounds__(kThreads, 2)
l2_tile_kernel(const float* __restrict__ q, const TX* __restrict__ x,
               const long long* __restrict__ index,
               const float* __restrict__ row_norms,
               const int* __restrict__ ids, float* __restrict__ out, int B,
               long long M, int n, bool vec, int lanes) {
  constexpr int kQs = kTY * (kRowNorms ? kLTWide : kLT) * kLd;
  static_assert(kLTWide >= kLT, "the lane buffers hold either tile");
  __shared__ __align__(16) float qs[2 * kQs];
  __shared__ __align__(16) float xs[2 * kBM * kLd];
  __shared__ float qn_s[kQs / kLd];
  __shared__ float xn_s[kBM];
  if constexpr (!kRowNorms) {
    tile<TX, false, kLT>(q, x, nullptr, out, B, M, n, vec,
                         (long long)blockIdx.x * kBM, blockIdx.y * kTY * kLT,
                         qs, kQs, xs, qn_s, xn_s);
  } else {
    __shared__ long long rmap[kBM];
    const unsigned lane_tiles = (unsigned)((B + lanes - 1) / lanes);
    const long long m0 = (long long)(blockIdx.x / lane_tiles) * kBM;
    const int b0 = (int)(blockIdx.x % lane_tiles) * lanes;
    // the lanes' first stage is on its way while the row map comes in;
    // a slot's id, row and norm are three loads of one latency
    stage(qs, q, nullptr, b0, lanes, B, n, 0, vec);
    bool kept = false;
    if (threadIdx.x < kBM) {
      const long long m = m0 + threadIdx.x;
      const bool in = m < M;
      const int id = in ? ids[m] : -1;
      const long long row = in ? (index != nullptr ? index[m] : m) : -1;
      xn_s[threadIdx.x] = in ? row_norms[m] : 0.f;
      kept = id >= 0;
      rmap[threadIdx.x] = kept ? row : -1;
    }
    // a masked tile: nothing written (see the top); the lanes' copies
    // land before the block leaves
    if (!__syncthreads_or(kept)) {
      cp_async_commit();
      cp_async_wait<0>();
      return;
    }
    if (lanes == kTY * kLTWide)
      tile<TX, true, kLTWide>(q, x, rmap, out, B, M, n, vec, m0, b0, qs,
                              kQs, xs, qn_s, xn_s);
    else
      tile<TX, true, kLT>(q, x, rmap, out, B, M, n, vec, m0, b0, qs, kQs,
                          xs, qn_s, xn_s);
  }
}

// Launch on stream; returns cudaGetLastError().
template <typename TX>
inline cudaError_t launch_l2_tile(const float* q, const TX* x, float* out,
                                  int B, long long M, int n,
                                  cudaStream_t st) {
  if (B == 0 || M == 0) return cudaSuccess;
  const bool vec = (n % 4 == 0) && rt::aligned16(q) && rt::aligned16(x);
  const int lanes = kTY * kLT;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM),
                  (unsigned)((B + lanes - 1) / lanes));
  l2_tile_kernel<TX, false><<<grid, kThreads, 0, st>>>(
      q, x, nullptr, nullptr, nullptr, out, B, M, n, vec, lanes);
  return cudaGetLastError();
}

// K4's score pass: slot m of M scored against every lane, its row
// x[index[m]] (x[m] with no index); lanes a block kTY * kLT or
// kTY * kLTWide. Returns cudaGetLastError().
template <typename TX>
inline cudaError_t launch_l2_tile_norms(const float* q, const TX* x,
                                        const long long* index,
                                        const float* row_norms,
                                        const int* ids, float* out, int B,
                                        long long M, int n, int lanes,
                                        cudaStream_t st) {
  if (lanes != kTY * kLT && lanes != kTY * kLTWide)
    return cudaErrorInvalidValue;
  if (B == 0 || M == 0) return cudaSuccess;
  const bool vec = (n % 4 == 0) && rt::aligned16(q) && rt::aligned16(x);
  const long long blocks =
      (M + kBM - 1) / kBM * ((B + lanes - 1) / lanes);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  l2_tile_kernel<TX, true><<<(unsigned)blocks, kThreads, 0, st>>>(
      q, x, index, row_norms, ids, out, B, M, n, vec, lanes);
  return cudaGetLastError();
}

}  // namespace gemm
