// K3 l2: out[b, m] = max(|q_b|^2 - 2 q_b.x_m + |x_m|^2, 0), f32 accumulation.
//
// Replaces src/repro/kernels/l2_dist.py (l2_pallas / _l2_kernel), the
// brute-force yardstick's distance pass over the whole collection.
// Bound on the H100: operations at the shapes of the main path (2*B*n
// flops for every row read once; B = 100 puts it above the f32 ridge of
// 67 TFLOP/s over 3.35 TB/s).
//
// The tiled SIMT GEMM of gemm_tile.cuh (IEEE f32 FMAs, a 13 x 4 register
// tile a thread, double-buffered stages), squaring the staged rows for
// |x_m|^2 in the same pass, so no separate pass reads the data again.
// bf16 rows are read as bf16 and widened before they are staged.
#include "gemm_tile.cuh"

extern "C" int l2_f32(const void* q, const void* x, void* out, int B,
                      long long M, int n, void* stream) {
  return (int)gemm::launch_l2_tile<float>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<float*>(out), B, M, n, (cudaStream_t)stream);
}

extern "C" int l2_bf16(const void* q, const void* x, void* out, int B,
                       long long M, int n, void* stream) {
  return (int)gemm::launch_l2_tile<__nv_bfloat16>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(x),
      static_cast<float*>(out), B, M, n, (cudaStream_t)stream);
}
