// Kernel 10: the post-attention half of a llama layer in one launch, for
// decode rows (B <= 8):
//   h2 = h + bf16(W4A8(attn) Wo^T)
//   r  = bf16(f32(h2) * (1 / sqrt(mean(h2^2) + eps)) * (norm_w + offset))
//   h3 = h2 + bf16(FFN(r)),  FFN(r) = W4A8(bf16(act(W4A8(r) Wg^T) * (W4A8(r) Wu^T))) Wd^T
// with every activation quantized per 256 as kernels 1 and 2 quantize it.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py::_qmm_w4_layer (entry
// qmm_w4_layer_matmul; LKTPU_LAYER_FUSED=1).  Wo, the fused [gate; up] and
// down are W4 folds of one family (all compact or none).  When all three
// are sym folds (SYM), the row walks form the min term from the scale and
// never read g_min (w4_dot.cuh); a layer that mixes sym and legacy folds
// reads every g_min, which is right for both.
//
// Bound on the H100: bytes (Wo, gate|up and down once, at B <= 8 far below
// the int8 rate).  On the TPU the grid runs in order, so one grid step can
// finish h2 before the next normalizes it.  Here blocks run in parallel,
// and each stage needs all of the one before it, so the kernel is one
// cooperative launch (every block resident) with grid-wide barriers:
//   1. every block quantizes attn into shared memory; the grid's warps take
//      Wo's rows (w4_row_partial, one warp per row) and write h2 to a global
//      scratch;
//   2. every block reads all of h2, takes the norm of each row in the same
//      order (so every block holds the same r) and quantizes r; the grid's
//      warps take the 2F gate|up rows and write g|u to a global scratch;
//   3. units of (F superblock f, slice of down rows) go round the blocks:
//      each forms h = bf16(act(g) u) of superblock f, quantizes it, and
//      writes its rows' down partial for f (kernel 2's steps, w4_ffn.cuh);
//   4. the F/256 partials are summed in a fixed order and added to h2.
// Stages 1-3 spread over all SMs (kernel 2 alone runs one block per F
// superblock: 56 at F = 14336).  Nothing is summed by atomics, so greedy
// tokens repeat run to run; the arithmetic of each stage is kernel 1's and
// kernel 2's, so the result equals the unfused route but for the norm's
// f32 summation order.
#include <cooperative_groups.h>

#include "w4_ffn.cuh"

namespace cg = cooperative_groups;

constexpr int kLayerWarps = 16;

struct LayerArgs {
  const __nv_bfloat16* attn;  // [B, E]
  const __nv_bfloat16* h;     // [B, E]
  const float* norm_w;        // [E]
  const uint8_t *o_codes, *o_q6;
  const float *o_dd, *o_gs, *o_gm;
  const uint8_t *gu_codes, *gu_q6;
  const float *gu_dd, *gu_gs, *gu_gm;
  const uint8_t *dn_codes, *dn_q6;
  const float *dn_dd, *dn_gs, *dn_gm;
  __nv_bfloat16* h2;          // scratch [B, E]
  float* gu_out;              // scratch [B, 2F]
  float* partial;             // scratch [F/256, B, E]
  __nv_bfloat16* out;         // [B, E]
  int B, E, F, act, n_slices;
  float eps, offset;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Quantize B rows of E values, given lane by lane by `value(b, e)`, into
// the shared x8/sx/xsum (one warp per 256-element superblock).
template <typename Fn>
__device__ __forceinline__ void quantize_rows_smem(int B, int E, int8_t* x8, float* sx, int* xs,
                                                   Fn value) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, S = E / 256;
  for (int u = warp; u < B * S; u += kLayerWarps) {
    const int b = u / S, s = u - b * S, e0 = s * 256 + lane * 8;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = value(b, e0 + i);
    __align__(8) int8_t q[8];
    int gsum;
    const float d = quantize8_sb(v, q, &gsum);
    *reinterpret_cast<int2*>(x8 + (size_t)b * E + e0) = *reinterpret_cast<const int2*>(q);
    if ((lane & 3) == 0) xs[b * (E / 32) + s * 8 + lane / 4] = gsum;
    if (lane == 0) sx[b * S + s] = d;
  }
}

template <int NB, bool COMPACT, bool SYM>
__global__ void __launch_bounds__(kLayerWarps * 32, 1) w4_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int B = a.B, E = a.E, F = a.F;
  int8_t* x8 = reinterpret_cast<int8_t*>(smem);                 // [NB][E]
  float* sx = reinterpret_cast<float*>(x8 + (size_t)NB * E);    // [NB][E/256]
  int* xs = reinterpret_cast<int*>(sx + NB * (E / 256));        // [NB][E/32]
  int8_t* h8 = reinterpret_cast<int8_t*>(xs + NB * (E / 32));   // [NB][256]
  float* dh = reinterpret_cast<float*>(h8 + NB * 256);          // [NB]
  int* hsum = reinterpret_cast<int*>(dh + NB);                  // [NB][8]
  float* red = reinterpret_cast<float*>(hsum + NB * 8);         // [16][NB]
  float* inv = red + kLayerWarps * NB;                          // [NB]
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kLayerWarps + warp, nwarps = gridDim.x * kLayerWarps;

  // 1. o projection and the first residual
  quantize_rows_smem(B, E, x8, sx, xs,
                     [&](int b, int e) { return __bfloat162float(a.attn[(size_t)b * E + e]); });
  __syncthreads();
  for (int row = gwarp; row < E; row += nwarps) {
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    w4_row_partial<NB, COMPACT, 1, SYM>(acc, x8, sx, xs, B, a.o_codes, a.o_q6, a.o_dd, a.o_gs, a.o_gm,
                                row, E / 2, lane);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float v = warp_sum(acc[b]);
      if (lane == 0 && b < B) {
        const size_t i = (size_t)b * E + row;
        a.h2[i] = __float2bfloat16_rn(__bfloat162float(a.h[i]) + bf16_round(v));
      }
    }
  }
  grid.sync();

  // 2. the norm of h2 (every block alike), r quantized, gate|up rows
  float ss[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) ss[b] = 0.f;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < B) {
        const float v = __bfloat162float(a.h2[(size_t)b * E + e]);
        ss[b] = __fadd_rn(ss[b], __fmul_rn(v, v));
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const float v = warp_sum(ss[b]);
    if (lane == 0) red[warp * NB + b] = v;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    float s = 0.f;
    for (int w = 0; w < kLayerWarps; ++w) s += red[w * NB + threadIdx.x];
    const float var = __fdiv_rn(s, (float)E);
    inv[threadIdx.x] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, a.eps)));
  }
  __syncthreads();
  quantize_rows_smem(B, E, x8, sx, xs, [&](int b, int e) {
    const float v = __bfloat162float(a.h2[(size_t)b * E + e]);
    return bf16_round(__fmul_rn(__fmul_rn(v, inv[b]), __fadd_rn(a.norm_w[e], a.offset)));
  });
  __syncthreads();
  for (int row = gwarp; row < 2 * F; row += nwarps) {
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    w4_row_partial<NB, COMPACT, 1, SYM>(acc, x8, sx, xs, B, a.gu_codes, a.gu_q6, a.gu_dd, a.gu_gs,
                                a.gu_gm, row, E / 2, lane);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float v = warp_sum(acc[b]);
      if (lane == 0 && b < B) a.gu_out[(size_t)b * 2 * F + row] = v;
    }
  }
  grid.sync();

  // 3. units (F superblock f, slice of down rows): h of f quantized, then the
  // slice's down partial for f
  const int S_F = F / 256;
  const int slice = ((E + 64 * a.n_slices - 1) / (64 * a.n_slices)) * 64;
  for (int unit = blockIdx.x; unit < S_F * a.n_slices; unit += gridDim.x) {
    const int f = unit / a.n_slices, e_lo = (unit - f * a.n_slices) * slice;
    __syncthreads();  // h8 of the previous unit is no longer read
    ffn_quantize_h(B, a.gu_out + f * 256, a.gu_out + F + f * 256, 2 * (size_t)F, a.act, h8, dh,
                   hsum, warp, kLayerWarps, lane);
    __syncthreads();
    ffn_down_partial<NB, COMPACT, SYM>(h8, dh, hsum, B, a.dn_codes, a.dn_q6, a.dn_dd, a.dn_gs,
                                  a.dn_gm, E, F, f, e_lo, min(E, e_lo + slice), warp,
                                  kLayerWarps, lane, a.partial);
  }
  grid.sync();

  // 4. fixed-order sum of the partials and the second residual
  const int be = B * E;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < be; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int f = 0; f < S_F; ++f) s += a.partial[(size_t)f * be + i];
    a.out[i] = __float2bfloat16_rn(__bfloat162float(a.h2[i]) + bf16_round(s));
  }
}

template <int NB, bool COMPACT, bool SYM>
static int launch_layer(LayerArgs a, cudaStream_t stream) {
  const size_t smem = (size_t)NB * a.E + (size_t)NB * (a.E / 256) * 4 +
                      (size_t)NB * (a.E / 32) * 4 + NB * 256 + NB * 4 + NB * 8 * 4 +
                      kLayerWarps * NB * 4 + NB * 4;
  auto kern = w4_layer_kernel<NB, COMPACT, SYM>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)err;
  if (!coop) return (int)cudaErrorCooperativeLaunchTooLarge;
  if ((err = lk_sm_count(&sms)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kLayerWarps * 32,
                                                           smem)) != cudaSuccess)
    return (int)err;
  // every block must be resident at once for the grid barriers
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms * per_sm;
  // down units: about four a block, in slices of whole 64-row warp steps
  const int S_F = a.F / 256;
  int n_slices = (4 * grid + S_F - 1) / S_F;
  if (n_slices > a.E / 64) n_slices = a.E / 64;
  a.n_slices = n_slices < 1 ? 1 : n_slices;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kLayerWarps * 32), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NB>
static int launch_flavor(LayerArgs a, int compact, int sym, cudaStream_t stream) {
  if (compact) return launch_layer<NB, true, false>(a, stream);
  return sym ? launch_layer<NB, false, true>(a, stream) : launch_layer<NB, false, false>(a, stream);
}

// attn, h: [B, E] bf16; norm_w [E] f32; Wo [E, E], gu [2F, E], dn [E, F]
// W4 folds (compact planes or g_scale/g_min; sym != 0 when all three are
// sym folds); scratch h2 [B, E] bf16, gu_out [B, 2F] f32, partial
// [F/256, B, E] f32; out [B, E] bf16.
LK_API int lk_w4_layer(const void* attn, const void* h, const float* norm_w, int B,
                       const uint8_t* o_codes, const uint8_t* o_q6, const float* o_dd,
                       const float* o_gs, const float* o_gm, const uint8_t* gu_codes,
                       const uint8_t* gu_q6, const float* gu_dd, const float* gu_gs,
                       const float* gu_gm, const uint8_t* dn_codes, const uint8_t* dn_q6,
                       const float* dn_dd, const float* dn_gs, const float* dn_gm, int E, int F,
                       int compact, int sym, int act, float eps, float offset, void* h2,
                       float* gu_out, float* partial, void* out, cudaStream_t stream) {
  if (E <= 0 || E % 2048 || F <= 0 || F % 1024 || (act != 0 && act != 1) || B < 1 || B > 8)
    return (int)cudaErrorInvalidValue;
  LayerArgs a{static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(h),
              norm_w, o_codes, o_q6, o_dd, o_gs, o_gm, gu_codes, gu_q6, gu_dd, gu_gs, gu_gm,
              dn_codes, dn_q6, dn_dd, dn_gs, dn_gm, static_cast<__nv_bfloat16*>(h2), gu_out,
              partial, static_cast<__nv_bfloat16*>(out), B, E, F, act, 1, eps, offset};
  // the batch-row buckets of at most 8 rows (LK_SWITCH_NB's first four)
  switch (nb_bucket(B)) {
    case 1: return launch_flavor<1>(a, compact, sym, stream);
    case 2: return launch_flavor<2>(a, compact, sym, stream);
    case 4: return launch_flavor<4>(a, compact, sym, stream);
    case 8: return launch_flavor<8>(a, compact, sym, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
