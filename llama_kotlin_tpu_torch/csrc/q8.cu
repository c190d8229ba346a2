// Activation prologue of the W4A8 kernels (qmm_w4.cu, qmm_w4_ffn.cu):
// x [B, K] f32 -> x8 [B, K] int8, sx [B, K/256] f32 per-superblock scales,
// xsum [B, K/32] int32 per-32-group code sums (the min term's operand,
// the analogue of the reference's Q8_K bsums).
//
// Replaces the in-kernel prep of llama_kotlin_tpu/ops/pallas/qmm_w4.py
// qmm_w4_fx2 (its `_prep` at the first n-block of each k-block).  Bound:
// bytes (reads 4 B and writes ~1.1 B per element); one warp per
// superblock, each lane owning 8 consecutive elements.
#include "common.cuh"

__global__ void quantize_q8_kernel(const float* __restrict__ x, int8_t* __restrict__ x8,
                                   float* __restrict__ sx, int* __restrict__ xsum, int k) {
  const int s = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  const size_t base = (size_t)b * k + s * 256 + lane * 8;
  const float4 a = *reinterpret_cast<const float4*>(x + base);
  const float4 c = *reinterpret_cast<const float4*>(x + base + 4);
  const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  __align__(8) int8_t q[8];
  int gsum;
  const float d = quantize8_sb(v, q, &gsum);
  *reinterpret_cast<int2*>(x8 + base) = *reinterpret_cast<const int2*>(q);
  if ((lane & 3) == 0) xsum[(size_t)b * (k / 32) + s * 8 + lane / 4] = gsum;
  if (lane == 0) sx[(size_t)b * (k / 256) + s] = d;
}

LK_API const char* lk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

LK_API int lk_quantize_q8(const float* x, int8_t* x8, float* sx, int* xsum, int rows, int k,
                          cudaStream_t stream) {
  if (rows <= 0 || k <= 0 || k % 256) return (int)cudaErrorInvalidValue;
  quantize_q8_kernel<<<dim3(k / 256, rows), 32, 0, stream>>>(x, x8, sx, xsum, k);
  return (int)cudaGetLastError();
}
