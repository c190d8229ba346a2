// Kernel 2: the gated FFN of decode rows, y[B, E] = (act(x Wg^T) * (x Wu^T)) Wd^T,
// B <= 32, x quantized per 256 and h = bf16(act(g) u) re-quantized per 256.
//
// Replaces llama_kotlin_tpu/ops/pallas/qmm_w4_ffn.py::qmm_w4_ffn (entry
// qmm_w4_ffn_matmul), both layouts: the fused [gate; up] tensor [2F, E],
// or separate gate [F, E] and up [F, E] (up=; the wrapper passes the
// fused tensor's two halves the same way), and down [E, F], W4 folds all
// compact or none.  SYM (gate, up and down all sym folds): no g_min read.
//
// Bound on the H100: bytes (the 3 E F weights once; at B <= 32 each byte
// feeds at most 64 int8 operations).  Two routes, by the row threshold T2
// (FFN_COOP_ROWS here, ops/cuda/qmm_w4_ffn.py::MMA_MIN_ROWS):
//
// - up to T2 rows, one cooperative launch over every SM (w4_coop.cuh,
//   shared with kernel 10): each block quantizes x into shared memory, the
//   grid's warps take the 2F gate|up rows (a g|u scratch), a barrier, h
//   quantized per superblock, a barrier, then every block holds all of h's
//   codes and the grid takes the E down rows, each summed whole.  No
//   partials, no second kernel.
// - above T2, kernel 1's int8 tile (w4_mma.cuh): x's codes from q8.cu's
//   prologue; gate|up on the tile with its 128 rows a block laid out as 64
//   gate rows and the same 64 up rows (GATED loads), so the block's
//   epilogue forms h = bf16(act(g) u) of its 64 columns; h quantized by the
//   prologue; the down product on kernel 1's own tile (lk_w4_gemv).  K splits
//   (ops/cuda/qmm.py::plan) are summed in split order by the last block,
//   as kernel 1 sums them, so nothing is summed by atomics.
#include <algorithm>

#include "w4_coop.cuh"
#include "w4_mma.cuh"

// T2: the cooperative launch takes at most this many rows.
constexpr int FFN_COOP_ROWS = 8;
static_assert(FFN_COOP_ROWS <= coop::MAX_ROWS, "the cooperative stages take at most 8 rows");

LK_API int lk_quantize_q8(const float* x, int8_t* x8, float* sx, int* xsum, int rows, int k,
                          cudaStream_t stream);
LK_API int lk_w4_gemv(const int8_t* x8, const float* sx, const int* xsum, int B,
                      const uint8_t* codes, const uint8_t* q6, const float* dd, const float* gs,
                      const float* gm, int n, int kc, int compact, int sym, float* y, int splits,
                      float* ws, int* cnt, cudaStream_t stream);

// --- up to T2 rows: the cooperative launch ----------------------------------

struct FfnCoopArgs {
  const float* x;  // [B, E]
  coop::Ffn f;
  float* y;  // [B, E]
};

template <int NB, bool MMA, bool COMPACT, bool SYM>
__global__ void __launch_bounds__(coop::THREADS, 1) w4_ffn_coop_kernel(const FfnCoopArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  using SM = coop::Smem<MMA ? coop::MAX_ROWS : NB, MMA>;
  const int E = a.f.E, kmax = max(E, a.f.F);
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  coop::quantize_rows<MMA>(a.f.B, E, SM::act(smem, kmax, E), [&](int b, int e, float v[8]) {
    coop::load8_f32(a.x + (size_t)b * E + e, v);
  });
  __syncthreads();
  coop::ffn<NB, MMA, COMPACT, SYM>(a.f, smem, kmax, grid,
                                   [&](int b, int e, float v) { a.y[(size_t)b * E + e] = v; });
}

template <int NB, bool MMA, bool COMPACT, bool SYM>
struct CoopLaunch {
  static int run(const FfnCoopArgs& a, cudaStream_t stream) {
    using SM = coop::Smem<MMA ? coop::MAX_ROWS : NB, MMA>;
    return coop::launch(w4_ffn_coop_kernel<NB, MMA, COMPACT, SYM>, a,
                        SM::bytes(std::max(a.f.E, a.f.F)), stream);
  }
};

// --- above T2: kernel 1's tile ----------------------------------------------

// gate|up on the tile: block x takes gate rows and up rows 64x .. 64x + 63
// (tile columns 0..63 and 64..127), K split in `splits` span ranges.  Its
// epilogue writes h [B, F] f32 (bf16 values) for columns 64x ..; with
// splits > 1 the partials go to ws [splits, B, 2F] in tile-column order
// and the last block sums them in split order into gus [B, 2F] first.
template <int MT, bool SYM, bool COMPACT>
__global__ void __launch_bounds__(w4mma::THREADS, 1)
w4_gated_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                const int* __restrict__ xsum, int B, const W4Fold gate, const W4Fold up, int F,
                int kc, int act, float* __restrict__ h, int splits, float* __restrict__ ws,
                int* __restrict__ cnt, float* __restrict__ gus) {
  using namespace w4mma;
  using T = Tile<MT, COMPACT>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, z = blockIdx.z, n = 2 * F;
  int s0, s1;
  split_range(z, splits, kc / 128, &s0, &s1);
  const int ns = s1 - s0;
  auto load = [&](int stage, int s) {
    uint8_t* st = smem + stage * T::STAGE;
    load_weights<MT, SYM, COMPACT, true>(st, s, gate.codes, gate.gs, gate.gm, F, kc, n0, gate.q6,
                                         gate.dd, &up);
    load_acts<MT, COMPACT>(st, s, x8, sx, xsum, B, kc);
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ns) load(i, s0 + i);
    cp_async_commit();
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = i + STAGES - 1;
    if (nxt < ns) load(nxt % STAGES, s0 + nxt);
    cp_async_commit();
    span_step<MT, SYM, COMPACT>(smem + (i % STAGES) * T::STAGE, acc, warp, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the f32 tile [16 MT][BN]: batch rows by gate columns | up columns
  constexpr int O_LD = BN + 4;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(mt * 16 + g + (e >= 2 ? 8 : 0)) * O_LD + warp * 16 + nt * 8 + 2 * t + (e & 1)] =
            acc[mt][nt][e];
  __syncthreads();
  const float* src = tile;
  int ld = O_LD;
  if (splits > 1) {
    float* part = ws + (size_t)z * B * n;
    for (int idx = tid; idx < B * BN; idx += THREADS)
      part[(size_t)(idx / BN) * n + n0 + idx % BN] = tile[(idx / BN) * O_LD + idx % BN];
    if (!split_arrive_last(cnt, blockIdx.x, splits)) return;
    split_sum(ws, gus, splits, (size_t)B * n, n, 0, B, n0, BN);
    __syncthreads();
    src = gus + n0;
    ld = n;
  }
  for (int idx = tid; idx < B * (BN / 2); idx += THREADS) {
    const int b = idx / (BN / 2), c = idx % (BN / 2);
    const float gv = src[b * ld + c], uv = src[b * ld + BN / 2 + c];
    h[(size_t)b * F + blockIdx.x * (BN / 2) + c] = coop::bf16_round(coop::ffn_act(act, gv) * uv);
  }
}

template <bool SYM, bool COMPACT>
static int launch_gated(const int8_t* x8, const float* sx, const int* xsum, int B,
                        const W4Fold& gate, const W4Fold& up, int F, int kc, int act, float* h,
                        int splits, float* ws, int* cnt, float* gus, cudaStream_t stream) {
  using namespace w4mma;
  const dim3 grid(2 * F / BN, 1, splits);
  if (B <= 16)
    LK_MMA_LAUNCH((w4_gated_kernel<1, SYM, COMPACT>), (Tile<1, COMPACT>::SMEM), grid, stream, x8,
                  sx, xsum, B, gate, up, F, kc, act, h, splits, ws, cnt, gus)
  LK_MMA_LAUNCH((w4_gated_kernel<2, SYM, COMPACT>), (Tile<2, COMPACT>::SMEM), grid, stream, x8,
                sx, xsum, B, gate, up, F, kc, act, h, splits, ws, cnt, gus)
}

// --- the entry ----------------------------------------------------------------

// The tile route's scratch beside the FFN's h8, dh, hsum: x's codes, h,
// the split sums.
struct TileWork {
  int8_t* x8;
  float *sx, *h, *gus, *ws;
  int* xsum;
};

// Carves one call's scratch from c into f (and t on the tile route).
static void take_work(coop::Carve& c, coop::Ffn& f, TileWork& t, int splits_gu, int splits_dn) {
  const int B = f.B, E = f.E, F = f.F;
  if (splits_gu == 0) return f.take_scratch(c);
  f.h8 = c.take<int8_t>((size_t)B * F);
  f.dh = c.take<float>((size_t)B * (F / 256));
  f.hsum = c.take<int>((size_t)B * (F / 32));
  t.x8 = c.take<int8_t>((size_t)B * E);
  t.sx = c.take<float>((size_t)B * (E / 256));
  t.xsum = c.take<int>((size_t)B * (E / 32));
  t.h = c.take<float>((size_t)B * F);
  t.gus = splits_gu > 1 ? c.take<float>((size_t)B * 2 * F) : nullptr;
  const size_t wsn = std::max(splits_gu > 1 ? (size_t)splits_gu * B * 2 * F : 0,
                              splits_dn > 1 ? (size_t)splits_dn * B * E : 0);
  t.ws = wsn ? c.take<float>(wsn) : nullptr;
}

static bool ffn_shape_ok(int B, int E, int F, int act, int splits_gu, int splits_dn) {
  if (B < 1 || B > 32 || E <= 0 || E % 1024 || F <= 0 || F % 1024 || (act != 0 && act != 1))
    return false;
  if (splits_gu == 0) return splits_dn == 0 && B <= coop::MAX_ROWS;
  return splits_gu >= 1 && splits_gu <= E / 256 && splits_dn >= 1 && splits_dn <= F / 256;
}

// Bytes of scratch lk_w4_ffn needs for these rows, shapes and splits (0
// when it does not take them); with no splits, also kernel 10's.
LK_API int lk_w4_ffn_workspace(int B, int E, int F, int splits_gu, int splits_dn) {
  if (!ffn_shape_ok(B, E, F, 0, splits_gu, splits_dn)) return 0;
  coop::Carve c{nullptr};
  coop::Ffn f{};
  f.B = B, f.E = E, f.F = F;
  TileWork t{};
  take_work(c, f, t, splits_gu, splits_dn);
  return (int)c.bytes;
}

// x [B, E] f32; gate, up [F, E] and dn [E, F] W4 folds (codes, q6, dd,
// gs, gm each; compact != 0: q6/dd; sym != 0: all three sym, gm not read);
// act 0 silu, 1 gelu; splits_gu = splits_dn = 0: the cooperative launch
// (B <= T2); else kernel 1's tile with those K splits (any B <= 32);
// work: lk_w4_ffn_workspace bytes; cnt: zeroed split counters (at least
// 2F/128); y [B, E] f32.
LK_API int lk_w4_ffn(const float* x, int B, const uint8_t* g_codes, const uint8_t* g_q6,
                     const float* g_dd, const float* g_gs, const float* g_gm,
                     const uint8_t* u_codes, const uint8_t* u_q6, const float* u_dd,
                     const float* u_gs, const float* u_gm, const uint8_t* d_codes,
                     const uint8_t* d_q6, const float* d_dd, const float* d_gs,
                     const float* d_gm, int E, int F, int compact, int sym, int act, int splits_gu,
                     int splits_dn, void* work, int* cnt, float* y, cudaStream_t stream) {
  if (!ffn_shape_ok(B, E, F, act, splits_gu, splits_dn) || (compact && sym) || !work ||
      (splits_gu == 0 ? B > FFN_COOP_ROWS : !cnt))
    return (int)cudaErrorInvalidValue;
  const W4Fold gate{g_codes, g_q6, g_dd, g_gs, g_gm}, up{u_codes, u_q6, u_dd, u_gs, u_gm},
      dn{d_codes, d_q6, d_dd, d_gs, d_gm};
  coop::Carve c{static_cast<uint8_t*>(work)};
  coop::Ffn f{gate, up, dn, B, E, F, act};
  TileWork w{};
  take_work(c, f, w, splits_gu, splits_dn);
  if (splits_gu == 0)
    return coop::dispatch<CoopLaunch>(FfnCoopArgs{x, f, y}, B, compact, sym, stream);
  int err = lk_quantize_q8(x, w.x8, w.sx, w.xsum, B, E, stream);
  if (err) return err;
  if (compact)
    err = launch_gated<false, true>(w.x8, w.sx, w.xsum, B, gate, up, F, E / 2, act, w.h,
                                    splits_gu, w.ws, cnt, w.gus, stream);
  else if (sym)
    err = launch_gated<true, false>(w.x8, w.sx, w.xsum, B, gate, up, F, E / 2, act, w.h,
                                    splits_gu, w.ws, cnt, w.gus, stream);
  else
    err = launch_gated<false, false>(w.x8, w.sx, w.xsum, B, gate, up, F, E / 2, act, w.h,
                                     splits_gu, w.ws, cnt, w.gus, stream);
  if (err) return err;
  if ((err = lk_quantize_q8(w.h, f.h8, f.dh, f.hsum, B, F, stream))) return err;
  return lk_w4_gemv(f.h8, f.dh, f.hsum, B, d_codes, d_q6, d_dd, d_gs, d_gm, E, F / 2, compact,
                    sym, y, splits_dn, w.ws, cnt, stream);
}
