// Kernel 9: attention over one layer of the stacked cell cache, with the
// ubatch's fresh K/V rows merged in.
//
// Replaces llama_kotlin_tpu/ops/pallas/flash_stacked.py::
// flash_attention_stacked: online softmax over the cache cells of layer
// `layer` under mask_cells [nt, n_vis] (the caller has masked out the cells
// the fresh rows will be written to), then over the fresh rows
// new_k/new_v [nt, KV, D] bf16 under mask_new [nt, nt]; bf16 or int8
// cache (per-row f32 scales); head dims 64 and 128; logit softcap; a row
// that sees nothing gives 0.
//
// Design: kernel 3's bf16 tensor-core tile (flash_mma.cuh) in its stacked
// variant: kernel 3's cache splits, dead-tile skip and ragged last tile,
// plus one split whose blocks walk the fresh rows, token-major as the
// forward pass produces them; the merge combines all splits.  The Pallas
// kernel's nt % 8 == 0, n_vis % 128 and scalar-prefetch rules are Mosaic
// tiling rules and do not apply: any nt >= 1 and 1 <= n_vis <= cells.
#include "flash_mma.cuh"

// q [nt, H, D] bf16 (D = 64 or 128); k/v cache [L, KV, cells, D] bf16 or
// int8 codes with k_scale/v_scale [L, KV, cells] f32; new_k/new_v [nt, KV,
// D] bf16; mask_cells [nt, mask_ld] int8 over cells 0 .. n_vis - 1
// (mask_ld a multiple of 8 and at least n_vis rounded up to 64; the
// columns past n_vis zero) and mask_new [nt, nt] int8; out [nt, H, D] bf16.
// part_o [nsplit + 1, KV*R, D] and part_ml [nsplit + 1, KV*R, 2] f32 are
// scratch, R = (H/KV) * nt; nsplit splits, dividing ceil(n_vis / 64), walk
// the cache cells.
LK_API int lk_flash_stacked(const __nv_bfloat16* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale, const int8_t* mask_cells,
                            const __nv_bfloat16* new_k, const __nv_bfloat16* new_v,
                            const int8_t* mask_new, __nv_bfloat16* out, float* part_o,
                            float* part_ml, int nt, int H, int KV, int D, int cells, int n_vis,
                            int mask_ld, int layer, float scale, float softcap, int nsplit,
                            cudaStream_t stream) {
  if (new_k == nullptr || new_v == nullptr || mask_new == nullptr ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{q,      k,       v,  k_scale, v_scale, mask_cells, new_k, new_v, mask_new,
                    part_o, part_ml, nt, H,       KV,      D,          cells, n_vis, mask_ld,
                    layer,  scale,   softcap, 0,  nsplit};
  if (k_scale != nullptr) return flmma::launch<int8_t, true>(a, out, stream);
  return flmma::launch<__nv_bfloat16, true>(a, out, stream);
}
