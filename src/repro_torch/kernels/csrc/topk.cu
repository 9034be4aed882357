// K4 coop_score_select, score pass: S[b, r] = max(|q_b|^2 - 2 q_b.x_r +
// norms[r], 0) for every lane b and pooled slot r, with the row norms
// passed in (the index's cached norms, which the solo path scores with).
// Slot r's row is rows[index[r]]: the pass reads the index's rows (or a
// device cache's slots) where they lie, so no gathered pool is copied
// first; with no index, slot r is rows[r]. The selection pass is
// lex_select.cu.
//
// Replaces the scoring half of src/repro/kernels/topk.py
// (coop_score_select_pallas / _coop_topk_kernel), the cooperative
// (share_gathers) refinement step: every lane scores every row gathered
// by any lane this iteration. The TPU kernel kept the [B, R] distances
// in VMEM and carried its selection across the grid; here the scores go
// to a scratch matrix that the wrapper allocates, and one exact radix
// select per lane follows. Bound on the H100: operations, 2*B*n flops a
// pooled row read once. At the main path's B = 100, R = 25,600: 1.31
// GFLOP, 0.020 ms at the f32 peak, the 10 MB of scores staying in the
// 50 MB L2 for the selection; 200 blocks of 104 lanes fill under one wave
// of the 132 SMs (two blocks each). At the search cell's B = 256,
// R = 1,001,472 (256 lanes x 8 leaves x 489 slots, the index's largest
// leaf): 131 GFLOP over every slot, 1.96 ms at the peak; the pool the
// pass no longer gathers was 1 GB.
//
// The schedule (gemm_tile.cuh, the kRowNorms instantiations): K3's
// register-tiled f32 GEMM with the norms as an argument, and only the
// work the answers use. A row tile whose 128 slots are all masked (ids
// < 0: same-iteration copies of a leaf, empty slots) is skipped whole;
// the lane tile is 104 or 128 lanes, whichever pads the batch less (the
// wrapper chooses it, kernels/topk.py lane_tile), so B = 256 pads none;
// the lane tiles of a row tile are neighbours in the grid, so the second
// read of a row comes from L2. Every kept slot's score is bit-identical
// to the dense pass's: the same FMAs in the same order. The lane tile is
// an argument and not a template parameter, so the pass keeps its name,
// gemm::l2_tile_kernel<float, true> (bf16 rows: <__nv_bfloat16, true>).
#include "gemm_tile.cuh"

extern "C" int coop_score_f32(const void* q, const void* rows,
                              const void* index, const void* norms,
                              const void* ids, void* scores, int B,
                              long long R, int n, int lanes, void* stream) {
  return (int)gemm::launch_l2_tile_norms<float>(
      static_cast<const float*>(q), static_cast<const float*>(rows),
      static_cast<const long long*>(index), static_cast<const float*>(norms),
      static_cast<const int*>(ids), static_cast<float*>(scores), B, R, n,
      lanes, (cudaStream_t)stream);
}

extern "C" int coop_score_bf16(const void* q, const void* rows,
                               const void* index, const void* norms,
                               const void* ids, void* scores, int B,
                               long long R, int n, int lanes, void* stream) {
  return (int)gemm::launch_l2_tile_norms<__nv_bfloat16>(
      static_cast<const float*>(q),
      static_cast<const __nv_bfloat16*>(rows),
      static_cast<const long long*>(index), static_cast<const float*>(norms),
      static_cast<const int*>(ids), static_cast<float*>(scores), B, R, n,
      lanes, (cudaStream_t)stream);
}

// The pass's tile: 0 the slots a block holds, 1 and 2 the lanes a block
// may hold. kernels/topk.py counts K4's tiles by the same numbers and
// checks them against these when it loads the library.
extern "C" int coop_score_tile(int which) {
  switch (which) {
    case 0: return gemm::kBM;
    case 1: return gemm::kTY * gemm::kLTWide;
    case 2: return gemm::kTY * gemm::kLT;
    default: return 0;
  }
}
