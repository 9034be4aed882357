// K4 coop_score_select, score pass: S[b, r] = max(|q_b|^2 - 2 q_b.x_r +
// norms[r], 0) for every lane b and pooled row r, with the row norms
// passed in (the index's cached norms, which the solo path scores with).
// The selection pass is lex_select.cu.
//
// Replaces the scoring half of src/repro/kernels/topk.py
// (coop_score_select_pallas / _coop_topk_kernel), the cooperative
// (share_gathers) refinement step: every lane scores every row gathered
// by any lane this iteration. The TPU kernel kept the [B, R] distances
// in VMEM and carried its selection across the grid; here the scores go
// to a scratch matrix that the wrapper allocates (10 MB at B = 100,
// R = 25,600, which stays in the 50 MB L2 for the selection pass), and
// one exact radix select per lane follows. Bound on the H100: operations
// (2*B*n flops for every pooled row read once), so the pass is K3's
// register-tiled GEMM (gemm_tile.cuh) with the norms as an argument.
#include "gemm_tile.cuh"

extern "C" int coop_score_f32(const void* q, const void* rows,
                              const void* norms, void* scores, int B,
                              long long R, int n, void* stream) {
  return (int)gemm::launch_l2_tile<float, true>(
      static_cast<const float*>(q), static_cast<const float*>(rows),
      static_cast<const float*>(norms), static_cast<float*>(scores), B, R, n,
      (cudaStream_t)stream);
}

extern "C" int coop_score_bf16(const void* q, const void* rows,
                               const void* norms, void* scores, int B,
                               long long R, int n, void* stream) {
  return (int)gemm::launch_l2_tile<__nv_bfloat16, true>(
      static_cast<const float*>(q),
      static_cast<const __nv_bfloat16*>(rows),
      static_cast<const float*>(norms), static_cast<float*>(scores), B, R, n,
      (cudaStream_t)stream);
}
