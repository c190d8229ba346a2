// Kernel 3: masked GQA attention over the cell cache, online softmax.
//
// Replaces llama_kotlin_tpu/ops/pallas/flash.py::flash_attention for a bf16
// cache, an int8 cache and a packed int4 cache, both with per-row f32
// scales (static layer index into the whole [L, KV, cells, D] cache, int8
// mask bounding n_vis, logit softcap, fully masked rows give 0), at head
// dims 64 and 128, at deepseek2's multi-head latent attention (the MLA
// branch: K rows 192 wide, V rows 128) and at Gemma's head dim 256 (the
// D = 256 branch: 8 warps a block, Q in shared memory), on bf16 tensor
// cores at every row count: flash_mma.cuh's tile, which skips a 64-cell
// tile that no row of a block sees, takes a ragged last tile, splits the
// cells over blocks and merges the splits in a fixed order.  The header
// says what bounds it and what its design does about it.  The other (DK,
// DV) pairs (the JAX kernel's other branches) are not taken.
#include "flash_mma.cuh"

// q [nt, H, D] bf16 (D = 64, 128, 256, or 192 with Dv = 128; else Dv = D;
// at D = 256 16-byte aligned); k
// cache [L, KV, cells, D] and v cache [L, KV, cells, Dv] bf16, or int8
// codes when k_scale/v_scale ([L, KV, cells] f32) are given, or with
// kv_bits = 4 packed int4 codes [.., D/2] and [.., Dv/2] with such scales
// (layer `layer`); mask [nt, mask_ld] int8 over cells 0 .. n_vis - 1
// (mask_ld a multiple of 8 and at least n_vis rounded up to 64; the
// columns past n_vis zero); out [nt, H, Dv] bf16.  part_o [nsplit, KV*R,
// Dv] and part_ml [nsplit, KV*R, 2] f32 are scratch, R = (H/KV) * nt;
// nsplit divides ceil(n_vis / 64).
LK_API int lk_flash(const __nv_bfloat16* q, const void* k, const void* v, const float* k_scale,
                    const float* v_scale, const int8_t* mask, __nv_bfloat16* out, float* part_o,
                    float* part_ml, int nt, int H, int KV, int D, int cells, int n_vis,
                    int mask_ld, int layer, float scale, float softcap, int nsplit, int kv_bits,
                    int Dv, cudaStream_t stream) {
  if (kv_bits != 4 && kv_bits != 8) return (int)cudaErrorInvalidValue;
  const FlashArgs a{q,      k,  v,     k_scale, v_scale, mask,    nullptr, nullptr, nullptr,
                    part_o, part_ml, nt, H,     KV,      D,       cells,   n_vis,   mask_ld,
                    layer,  scale, softcap, 0,  nsplit};
  if (kv_bits == 4) return flmma::launch<q4_packed, false>(a, out, stream, Dv);
  if (k_scale != nullptr) return flmma::launch<int8_t, false>(a, out, stream, Dv);
  return flmma::launch<__nv_bfloat16, false>(a, out, stream, Dv);
}
