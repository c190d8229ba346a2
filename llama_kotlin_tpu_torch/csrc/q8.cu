// Activation prologue of the W4A8 kernels (qmm_w4.cu, qmm_w4_ffn.cu):
// x [B, K] f32 -> x8 [B, K] int8, sx [B, K/256] f32 per-superblock scales,
// xsum [B, K/32] int32 per-32-group code sums (the min term's operand,
// the analogue of the reference's Q8_K bsums).
//
// Replaces the in-kernel prep of llama_kotlin_tpu/ops/pallas/qmm_w4.py
// qmm_w4_fx2 (its `_prep` at the first n-block of each k-block).  Bound:
// bytes (reads 4 B and writes ~1.1 B per element); one warp per
// superblock, each lane owning 8 consecutive elements.
//
// The dual-plane variant (the W4X mode's kernels 7 and 5) is the JAX
// package's quantize_activations_2p (qmm_w4.py:145-160): plane 1 quantizes
// x, plane 2 the residual r = x - f32(x1) * s1, written as rows B..2B-1 of
// the same outputs.  The residual is one rounded multiply and one rounded
// subtract (__fmul_rn/__fsub_rn): nvcc would otherwise contract them into
// an FMA, whose single rounding gives other residuals and other plane-2
// codes than the reference's separate operations.
#include "common.cuh"

__device__ __forceinline__ void store_q8(int8_t* __restrict__ x8, float* __restrict__ sx,
                                         int* __restrict__ xsum, int row, int s, int lane,
                                         int k, const int8_t q[8], float d, int gsum) {
  const size_t base = (size_t)row * k + s * 256 + lane * 8;
  *reinterpret_cast<int2*>(x8 + base) = *reinterpret_cast<const int2*>(q);
  if ((lane & 3) == 0) xsum[(size_t)row * (k / 32) + s * 8 + lane / 4] = gsum;
  if (lane == 0) sx[(size_t)row * (k / 256) + s] = d;
}

__device__ __forceinline__ void load8(const float* __restrict__ x, int row, int s, int lane,
                                      int k, float v[8]) {
  const size_t base = (size_t)row * k + s * 256 + lane * 8;
  const float4 a = *reinterpret_cast<const float4*>(x + base);
  const float4 c = *reinterpret_cast<const float4*>(x + base + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

__global__ void quantize_q8_kernel(const float* __restrict__ x, int8_t* __restrict__ x8,
                                   float* __restrict__ sx, int* __restrict__ xsum, int k) {
  const int s = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  float v[8];
  load8(x, b, s, lane, k, v);
  __align__(8) int8_t q[8];
  int gsum;
  const float d = quantize8_sb(v, q, &gsum);
  store_q8(x8, sx, xsum, b, s, lane, k, q, d, gsum);
}

__global__ void quantize_q8_2p_kernel(const float* __restrict__ x, int8_t* __restrict__ x8,
                                      float* __restrict__ sx, int* __restrict__ xsum, int B,
                                      int k) {
  const int s = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  float v[8], r[8];
  load8(x, b, s, lane, k, v);
  __align__(8) int8_t q[8];
  int gsum;
  const float d1 = quantize8_sb(v, q, &gsum);
  store_q8(x8, sx, xsum, b, s, lane, k, q, d1, gsum);
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = __fsub_rn(v[i], __fmul_rn((float)q[i], d1));
  const float d2 = quantize8_sb(r, q, &gsum);
  store_q8(x8, sx, xsum, B + b, s, lane, k, q, d2, gsum);
}

LK_API const char* lk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

LK_API int lk_quantize_q8(const float* x, int8_t* x8, float* sx, int* xsum, int rows, int k,
                          cudaStream_t stream) {
  if (rows <= 0 || k <= 0 || k % 256) return (int)cudaErrorInvalidValue;
  quantize_q8_kernel<<<dim3(k / 256, rows), 32, 0, stream>>>(x, x8, sx, xsum, k);
  return (int)cudaGetLastError();
}

// x [rows, k] f32 -> x8 [2 rows, k], sx [2 rows, k/256], xsum [2 rows, k/32]:
// plane 1 in rows 0..rows-1, plane 2 (the residual) in rows rows..2 rows-1.
LK_API int lk_quantize_q8_2p(const float* x, int8_t* x8, float* sx, int* xsum, int rows, int k,
                             cudaStream_t stream) {
  if (rows <= 0 || k <= 0 || k % 256) return (int)cudaErrorInvalidValue;
  quantize_q8_2p_kernel<<<dim3(k / 256, rows), 32, 0, stream>>>(x, x8, sx, xsum, rows, k);
  return (int)cudaGetLastError();
}
