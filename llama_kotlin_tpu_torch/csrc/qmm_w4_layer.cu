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
// are sym folds (SYM), the products form the min term from the scale and
// never read g_min; a layer that mixes sym and legacy folds reads every
// g_min, which is right for both.
//
// Bound on the H100: bytes (Wo, gate|up and down once, at B <= 8 far below
// the int8 rate).  On the TPU the grid runs in order, so one grid step can
// finish h2 before the next normalizes it.  Here blocks run in parallel,
// and each stage needs all of the one before it, so the kernel is one
// cooperative launch (every block resident, one an SM) with grid-wide
// barriers, on the stages of w4_coop.cuh that kernel 2 runs up to its T2:
//   1. every block quantizes attn into shared memory; the grid takes Wo's
//      rows and writes h2 to a global scratch;
//   -- grid.sync
//   2. every block reads all of h2, takes the norm of each row in the same
//      order (so every block holds the same r) and quantizes r;
//   3. kernel 2's FFN stages (gate|up, h, down), the down rows' sums added
//      to h2 as they are formed.
// Each stage walks its rows (B <= T10) or runs them on int8 tensor cores,
// with the next stage's first weights asked of L2 before each barrier.
// Nothing is summed by atomics, so greedy tokens repeat run to run; the
// arithmetic of each stage is kernel 1's and kernel 2's, so the result
// equals the unfused route but for the f32 order of the sums.
#include <algorithm>

#include "w4_coop.cuh"

struct LayerArgs {
  const __nv_bfloat16* attn;  // [B, E]
  const __nv_bfloat16* h;     // [B, E]
  const float* norm_w;        // [E]
  W4Fold o;
  coop::Ffn f;
  __nv_bfloat16* h2;  // scratch [B, E]
  __nv_bfloat16* out;  // [B, E]
  float eps, offset;
};

template <int NB, bool MMA, bool COMPACT, bool SYM>
__global__ void __launch_bounds__(coop::THREADS, 1) w4_layer_kernel(const LayerArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int NR = MMA ? coop::MAX_ROWS : NB;
  using SM = coop::Smem<NR, MMA>;
  const int B = a.f.B, E = a.f.E, kmax = max(E, a.f.F);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const coop::Act x = SM::act(smem, kmax, E);
  float* nsum = SM::norm(smem, kmax);    // [WARPS][NR]
  float* inv = nsum + coop::WARPS * NR;  // [NR]

  // 1. o projection and the first residual
  const coop::Rows o{a.o, a.o, E, E, E / 2};
  coop::quantize_rows<MMA>(B, E, x, [&](int b, int e, float v[8]) {
    coop::load8_bf16(a.attn + (size_t)b * E + e, v);
  });
  __syncthreads();
  coop::stage<NB, MMA, COMPACT, SYM>(o, x, B, SM::red(smem, kmax), [&](int b, int row, float v) {
    const size_t i = (size_t)b * E + row;
    a.h2[i] = __float2bfloat16_rn(__bfloat162float(a.h[i]) + coop::bf16_round(v));
  });
  grid.sync();

  // 2. the norm of h2 (every block alike), r quantized
  float ss[NR];
#pragma unroll
  for (int b = 0; b < NR; ++b) ss[b] = 0.f;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
#pragma unroll
    for (int b = 0; b < NR; ++b) {
      if (b < B) {
        const float v = __bfloat162float(a.h2[(size_t)b * E + e]);
        ss[b] = __fadd_rn(ss[b], __fmul_rn(v, v));
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NR; ++b) {
    const float v = warp_sum(ss[b]);
    if (lane == 0) nsum[warp * NR + b] = v;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    float s = 0.f;
    for (int w = 0; w < coop::WARPS; ++w) s += nsum[w * NR + threadIdx.x];
    const float var = __fdiv_rn(s, (float)E);
    inv[threadIdx.x] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, a.eps)));
  }
  __syncthreads();
  coop::quantize_rows<MMA>(B, E, x, [&](int b, int e, float v[8]) {
    coop::load8_bf16(a.h2 + (size_t)b * E + e, v);
    float w[8];
    coop::load8_f32(a.norm_w + e, w);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = coop::bf16_round(__fmul_rn(__fmul_rn(v[i], inv[b]), __fadd_rn(w[i], a.offset)));
  });
  __syncthreads();

  // 3. the FFN, and the second residual
  coop::ffn<NB, MMA, COMPACT, SYM>(a.f, smem, kmax, grid, [&](int b, int e, float v) {
    const size_t i = (size_t)b * E + e;
    a.out[i] = __float2bfloat16_rn(__bfloat162float(a.h2[i]) + coop::bf16_round(v));
  });
}

template <int NB, bool MMA, bool COMPACT, bool SYM>
struct LayerLaunch {
  static int run(const LayerArgs& a, cudaStream_t stream) {
    using SM = coop::Smem<MMA ? coop::MAX_ROWS : NB, MMA>;
    return coop::launch(w4_layer_kernel<NB, MMA, COMPACT, SYM>, a,
                        SM::bytes(std::max(a.f.E, a.f.F)), stream);
  }
};

// attn, h: [B, E] bf16; norm_w [E] f32; Wo [E, E], gate and up [F, E] (the
// halves of the fused [gate; up]), dn [E, F] W4 folds (codes, q6, dd, gs,
// gm each: compact planes or g_scale/g_min; sym != 0 when all are sym
// folds); scratch h2 [B, E] bf16 and work (lk_w4_ffn_workspace(B, E, F, 0,
// 0) bytes); out [B, E] bf16.
LK_API int lk_w4_layer(const void* attn, const void* h, const float* norm_w, int B,
                       const uint8_t* o_codes, const uint8_t* o_q6, const float* o_dd,
                       const float* o_gs, const float* o_gm, const uint8_t* g_codes,
                       const uint8_t* g_q6, const float* g_dd, const float* g_gs,
                       const float* g_gm, const uint8_t* u_codes, const uint8_t* u_q6,
                       const float* u_dd, const float* u_gs, const float* u_gm,
                       const uint8_t* dn_codes, const uint8_t* dn_q6, const float* dn_dd,
                       const float* dn_gs, const float* dn_gm, int E, int F, int compact,
                       int sym, int act, float eps, float offset, void* h2, void* work, void* out,
                       cudaStream_t stream) {
  if (E <= 0 || E % 2048 || F <= 0 || F % 1024 || (act != 0 && act != 1) || B < 1 ||
      B > coop::MAX_ROWS || !work)
    return (int)cudaErrorInvalidValue;
  coop::Ffn f{W4Fold{g_codes, g_q6, g_dd, g_gs, g_gm}, W4Fold{u_codes, u_q6, u_dd, u_gs, u_gm},
              W4Fold{dn_codes, dn_q6, dn_dd, dn_gs, dn_gm}, B, E, F, act};
  coop::Carve c{static_cast<uint8_t*>(work)};
  f.take_scratch(c);  // lk_w4_ffn's cooperative workspace
  const LayerArgs a{static_cast<const __nv_bfloat16*>(attn),
                    static_cast<const __nv_bfloat16*>(h),
                    norm_w,
                    W4Fold{o_codes, o_q6, o_dd, o_gs, o_gm},
                    f,
                    static_cast<__nv_bfloat16*>(h2),
                    static_cast<__nv_bfloat16*>(out),
                    eps,
                    offset};
  return coop::dispatch<LayerLaunch>(a, B, compact, sym, stream);
}
