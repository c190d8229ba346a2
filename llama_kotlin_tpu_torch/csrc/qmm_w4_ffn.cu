// Kernel 2: the gated FFN of a decode step in one pass over its weights,
// y[B, E] = (act(x Wg^T) * (x Wu^T)) Wd^T, B <= 32.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py::qmm_w4_ffn (entry
// qmm_w4_ffn_matmul) for the fused [gate; up] layout: gu [2F, E] and
// down [E, F], both W4 folds of one flavor.  The activations arrive as the
// prologue's x8/sx/xsum (q8.cu).
//
// Bound on the H100: bytes (the 3*E*F weights at <= 64 int8 ops a byte).
// Design: the F axis is elementwise in the gated FFN, so each block owns
// one 256-wide superblock of F and does the whole FFN for it:
//   1. its 256 gate and 256 up rows (w4_row_partial, one warp per row) into
//      shared memory;
//   2. h = bf16(act(g) * u) quantized per row over the block's superblock
//      (ffn_quantize_h, w4_ffn.cuh) — exactly the per-256 Q8 of h, so h
//      never leaves shared memory;
//   3. the down product over the block's 128 plane bytes of every down row
//      (ffn_down_partial), written as a [B, E] partial.
// A second kernel sums the F/256 partials in a fixed order, so the result
// is deterministic (no atomics) and greedy tokens repeat run to run.
#include "w4_ffn.cuh"

template <int NB, bool COMPACT>
__global__ void __launch_bounds__(512)
w4_ffn_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
              const int* __restrict__ xsum, int B, const uint8_t* __restrict__ gu_codes,
              const uint8_t* __restrict__ gu_q6, const float* __restrict__ gu_dd,
              const float* __restrict__ gu_gs, const float* __restrict__ gu_gm,
              const uint8_t* __restrict__ dn_codes, const uint8_t* __restrict__ dn_q6,
              const float* __restrict__ dn_dd, const float* __restrict__ dn_gs,
              const float* __restrict__ dn_gm, int E, int F, int act,
              float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* gu_s = reinterpret_cast<float*>(smem);                   // [NB][512]
  int8_t* h8 = reinterpret_cast<int8_t*>(gu_s + NB * 512);          // [NB][256]
  float* dh = reinterpret_cast<float*>(h8 + NB * 256);              // [NB]
  int* hsum = reinterpret_cast<int*>(dh + NB);                      // [NB][8]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x, f0 = blk * 256;

  // 1. gate rows f0.. and up rows F+f0.. of the fused tensor
  for (int r = warp; r < 512; r += 16) {
    const int row = r < 256 ? f0 + r : F + f0 + (r - 256);
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    w4_row_partial<NB, COMPACT>(acc, x8, sx, xsum, B, gu_codes, gu_q6, gu_dd, gu_gs, gu_gm,
                                row, E / 2, lane);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float v = warp_sum(acc[b]);
      if (lane == 0) gu_s[b * 512 + r] = v;
    }
  }
  __syncthreads();

  // 2. h in bf16, quantized per row of the batch
  ffn_quantize_h(B, gu_s, gu_s + 256, 512, act, h8, dh, hsum, warp, 16, lane);
  __syncthreads();

  // 3. down partial over every down row
  ffn_down_partial<NB, COMPACT>(h8, dh, hsum, B, dn_codes, dn_q6, dn_dd, dn_gs, dn_gm, E, F, blk,
                                0, E, warp, 16, lane, partial);
}

// Fixed-order sum of the per-block partials: y[i] = sum_blk partial[blk][i].
__global__ void ffn_reduce_kernel(const float* __restrict__ partial, float* __restrict__ y,
                                  int nblk, int be) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= be) return;
  float s = 0.f;
  for (int blk = 0; blk < nblk; ++blk) s += partial[(size_t)blk * be + i];
  y[i] = s;
}

template <int NB, bool COMPACT>
static int launch_ffn(const int8_t* x8, const float* sx, const int* xsum, int B,
                      const uint8_t* gu_codes, const uint8_t* gu_q6, const float* gu_dd,
                      const float* gu_gs, const float* gu_gm, const uint8_t* dn_codes,
                      const uint8_t* dn_q6, const float* dn_dd, const float* dn_gs,
                      const float* dn_gm, int E, int F, int act, float* partial,
                      cudaStream_t stream) {
  const size_t smem = (size_t)NB * (512 * 4 + 256 + 4 + 8 * 4);
  auto kern = w4_ffn_kernel<NB, COMPACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<F / 256, 512, smem, stream>>>(x8, sx, xsum, B, gu_codes, gu_q6, gu_dd, gu_gs, gu_gm,
                                       dn_codes, dn_q6, dn_dd, dn_gs, dn_gm, E, F, act,
                                       partial);
  return (int)cudaGetLastError();
}

// partial: scratch [F/256, B, E] f32; y: [B, E] f32.
LK_API int lk_w4_ffn(const int8_t* x8, const float* sx, const int* xsum, int B,
                     const uint8_t* gu_codes, const uint8_t* gu_q6, const float* gu_dd,
                     const float* gu_gs, const float* gu_gm, const uint8_t* dn_codes,
                     const uint8_t* dn_q6, const float* dn_dd, const float* dn_gs,
                     const float* dn_gm, int E, int F, int compact, int act, float* partial,
                     float* y, cudaStream_t stream) {
  if (E <= 0 || E % 1024 || F <= 0 || F % 256 || (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  int err;
  if (compact) {
    LK_SWITCH_NB(B, err = launch_ffn<NB, true>(x8, sx, xsum, B, gu_codes, gu_q6, gu_dd, gu_gs,
                                              gu_gm, dn_codes, dn_q6, dn_dd, dn_gs, dn_gm, E,
                                              F, act, partial, stream))
  } else {
    LK_SWITCH_NB(B, err = launch_ffn<NB, false>(x8, sx, xsum, B, gu_codes, gu_q6, gu_dd, gu_gs,
                                               gu_gm, dn_codes, dn_q6, dn_dd, dn_gs, dn_gm, E,
                                               F, act, partial, stream))
  }
  if (err) return err;
  const int be = B * E;
  ffn_reduce_kernel<<<(be + 255) / 256, 256, 0, stream>>>(partial, y, F / 256, be);
  return (int)cudaGetLastError();
}
