// Kernel 9: attention over one layer of the stacked cell cache, with the
// ubatch's fresh K/V rows merged in.
//
// Replaces llama_kotlin_tpu/ops/pallas/flash_stacked.py::
// flash_attention_stacked: online softmax over the cache cells of layer
// `layer` under mask_cells [nt, n_vis] (the caller has masked out the cells
// the fresh rows will be written to), then over the fresh rows
// new_k/new_v [nt, KV, 128] bf16 under mask_new [nt, nt]; bf16 or int8
// cache (per-row f32 scales); logit softcap; a row that sees nothing gives 0.
//
// Design: the split walk of flash_tile.cuh over the cache cells, plus
// one extra split whose blocks walk the fresh rows, token-major as the
// forward pass produces them; the merge combines all splits.  The Pallas
// kernel's nt % 8 == 0, n_vis % 128 and scalar-prefetch rules are Mosaic
// tiling rules and do not apply: any nt >= 1, n_vis a multiple of 64.
#include "flash_tile.cuh"

// Launch kernel 9's splits (n_old over the cache, one more for the fresh
// rows) and the merge.  Returns a CUDA error code, cudaErrorInvalidValue
// for a shape the kernels do not take.
static int flash_launch(const FlashArgs& a, __nv_bfloat16* out, cudaStream_t stream) {
  if (a.nt <= 0 || a.KV <= 0 || a.H % a.KV || a.n_vis <= 0 || a.n_vis % CT ||
      a.n_vis > a.cells || a.n_old <= 0 || (a.n_vis / CT) % a.n_old ||
      (a.ks == nullptr) != (a.vs == nullptr) || a.kn == nullptr || a.vn == nullptr ||
      a.mask_new == nullptr)
    return (int)cudaErrorInvalidValue;
  const int R = (a.H / a.KV) * a.nt;
  const int splits = a.n_old + 1;
  const dim3 grid(a.KV, (R + RT - 1) / RT, splits);
  if (a.ks != nullptr)
    flash_split_kernel<int8_t, true><<<grid, NTHR, 0, stream>>>(a);
  else
    flash_split_kernel<__nv_bfloat16, true><<<grid, NTHR, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_merge_kernel<<<a.KV * R, NTHR, 0, stream>>>(a.part_o, a.part_ml, out, a.nt, a.H, a.KV,
                                                   splits);
  return (int)cudaGetLastError();
}

// q [nt, H, 128] bf16; k/v cache [L, KV, cells, 128] bf16 or int8 codes
// with k_scale/v_scale [L, KV, cells] f32; new_k/new_v [nt, KV, 128] bf16;
// mask_cells [nt, n_vis] and mask_new [nt, nt] int8; out [nt, H, 128] bf16.
// part_o [nsplit + 1, KV*R, 128] and part_ml [nsplit + 1, KV*R, 2] f32 are
// scratch, R = (H/KV) * nt; nsplit splits walk the cache cells.
LK_API int lk_flash_stacked(const __nv_bfloat16* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale, const int8_t* mask_cells,
                            const __nv_bfloat16* new_k, const __nv_bfloat16* new_v,
                            const int8_t* mask_new, __nv_bfloat16* out, float* part_o,
                            float* part_ml, int nt, int H, int KV, int cells, int n_vis, int layer,
                            float scale, float softcap, int nsplit, cudaStream_t stream) {
  if (new_k == nullptr || new_v == nullptr || mask_new == nullptr)
    return (int)cudaErrorInvalidValue;
  FlashArgs a{q, k, v, k_scale, v_scale, mask_cells, new_k, new_v, mask_new, part_o, part_ml,
              nt, H, KV, cells, n_vis, layer, scale, softcap, 0, nsplit};
  if (nsplit > 0) a.split_cells = n_vis / nsplit;
  return flash_launch(a, out, stream);
}
