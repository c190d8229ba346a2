// The flash-attention tile of kernels 3 (flash.cu) and 9 (flash_stacked.cu):
// the masked GQA online softmax with Q K^T and P V on bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulators), the FlashAttention-2 shape, at
// head dims 64 and 128 and at every row count; then a fixed-order merge of
// the cell splits.  It replaced both kernels' scalar walks, which it beats
// on the H100 from decode's 4 rows a kv head up (PERF.md, kernels 3, 9).
//
// A block owns one kv head, BM = 64 rows of that head's GQA row space (row
// r = token r / rep, head kvh * rep + r % rep) and one split of the
// visible cells; warp w owns rows 16w .. 16w + 15 and keeps their Q
// fragments in registers for the whole walk.  64-cell K/V tiles are
// double-buffered in shared memory by cp.async and fed to the products by
// ldmatrix (.trans for V).  An int8 or packed int4 cache lands raw in the
// ring and is widened to bf16 on its way into the tile (codes of at most 8
// bits are exact in bf16): int8 as is, int4 in the JAX package's q4_0
// layout (byte j of a row: low nibble code + 8 of dim j, high nibble the
// two's-complement code of dim j + D/2).
//
// The arithmetic is JAX's: S = (q . k) * scale, times the row's K scale
// ks[c] on a quantized cache, then the softcap, then the mask; the running
// max and sum per row by quad shuffles; l takes the unscaled p, then the V
// scale vs[c] folds into p before P V.  The S accumulator fragment is P's
// A fragment (no trip through shared memory).  P is f32 in JAX: it is fed
// as p_hi + p_lo, two bf16 products (p_hi = bf16(p), p_lo = bf16(p -
// p_hi)), whose sum is within 2^-16 of p, where one bf16 P is within 2^-8.
//
// Ragged edges: any 1 <= n_vis <= cells.  The last tile of a split may
// pass n_vis; its cells at or past n_vis are zero-filled by cp.async's
// src-size operand from a clamped (valid) address, so a tile never reads
// past the cache's rows, and their mask columns are 0 (the wrapper pads
// the mask to whole tiles with zeros), so they are dead.
//
// Dead tiles: before a tile's K/V is requested, the block reads its
// [tokens x 64] mask tile (kept for the products) and skips the tile when
// no row of the block sees a cell of it (__syncthreads_or): in the online
// softmax such a tile is an exact no-op.  In serving that is the common
// case (a visibility bucket of 512 cells with 64-96 live), so most splits
// of a prefill do no more than read their mask and write m = -1e30, l = 0,
// acc = 0, which the merge weighs by 0.
//
// Kernel 9 (STACKED) adds one split, index 0, whose blocks walk the step's
// fresh rows new_k/new_v [nt, KV, D] (bf16, token-major: a row stride of
// KV * D) under mask_new [nt, nt] with the same tile, on a bf16 or an int8
// cache alike; its mask is read a byte at a time past nt.  On a bf16 cache
// both kinds of split run one instance of the walk, told apart at run
// time: with a walk of its own the fresh split's 8 blocks ended a cold
// decode launch about 9 us after the cache splits on the H100.
//
// Bound on the H100: bytes (one read of the visible K/V prefix and its
// scales: per cached row and plane 2D bytes in bf16, D + 4 in int8, D/2 +
// 4 packed int4).  At decode and at a 64-token prefill over 512 cells with
// 64 live that is a few hundred KB, so the two launches (the splits, the
// merge) and each block's walk of its tiles set the time.
//
// Packed int4 cache (the JAX package's q4_0 layout, kept so that state
// blobs cross-load): the Pallas kernel's folds of the +8 into a per-row
// constant and of the high nibble's 16x into q are Mosaic workarounds (no
// 8-bit shifts) and are not carried over.
#pragma once

#include <type_traits>

#include "mma_pipe.cuh"

namespace {  // internal linkage: each .cu that includes this has its own copy

constexpr int CT = 64;  // cells a tile
constexpr float FLASH_NEG_INF = -1e30f;

struct FlashArgs {
  const __nv_bfloat16* q;   // [nt, H, D]
  const void* kc;           // [L, KV, cells, D] bf16, int8 codes, or [.., D/2] packed int4
  const void* vc;
  const float* ks;          // [L, KV, cells] f32 row scales (quantized cache) or null
  const float* vs;
  const int8_t* mask;       // [nt, mask_ld], columns n_vis .. mask_ld - 1 zero
  const __nv_bfloat16* kn;  // [nt, KV, D] fresh rows (kernel 9) or null
  const __nv_bfloat16* vn;
  const int8_t* mask_new;   // [nt, nt] (kernel 9)
  float* part_o;            // [splits, KV * R, D] scratch, R = (H / KV) * nt
  float* part_ml;           // [splits, KV * R, 2]
  int nt, H, KV, D, cells, n_vis, mask_ld, layer;
  float scale, softcap;
  int split_cells;          // cells per cache split (whole tiles)
  int n_old;                // cache splits (kernel 9: splits 1 .. n_old; 0 the fresh rows')
};

// Tag type of the packed int4 cache: D/2 bytes a row, two codes a byte.
struct q4_packed {};

namespace flmma {
constexpr int WARPS = 4, THREADS = 32 * WARPS, BM = 16 * WARPS;  // rows a block

// The tile at head dim D for the cache element T: its bytes a row, and
// whether the ring holds raw codes to widen (int8, packed int4) or the
// bf16 tile itself.
template <typename T, int D>
struct Cache {
  static_assert(D == 64 || D == 128, "the tile takes head dims 64 and 128");
  static constexpr int KLD = D + 8;  // bf16 a K/V tile row (ldmatrix conflict-free)
  static constexpr int TILE_BYTES = CT * KLD * 2;  // one K or V tile in bf16
  static constexpr bool QUANT = !std::is_same<T, __nv_bfloat16>::value;
  static constexpr int ROW = std::is_same<T, q4_packed>::value ? D / 2
                             : std::is_same<T, int8_t>::value  ? D
                                                               : 2 * D;
  // one stage of the ring: K and V (bf16 tiles, or raw rows), then the
  // K and V scales of its cells
  static constexpr int RAW = QUANT ? CT * ROW : TILE_BYTES;
  static constexpr int STAGE = 2 * RAW + (QUANT ? 2 * CT * 4 : 0);
  // the ring (2 stages), the widened K/V tile of a quantized cache, the
  // mask tiles (2 stages, up to BM tokens of 64 cells)
  static constexpr int WIDE = QUANT ? 2 * TILE_BYTES : 0;
  static constexpr int MASK = 2 * BM * CT;
  static constexpr int SMEM = 2 * STAGE + WIDE + MASK;
};

// Which rows a walk reads: a cache split's cells, kernel 9's fresh rows,
// or either, told at run time (kernel 9 on a bf16 cache, whose two kinds
// of split then share one walk's code).
constexpr int CACHE_SPLIT = 0, FRESH_SPLIT = 1, ANY_SPLIT = 2;
template <int SRC>
__device__ __forceinline__ bool is_fresh(bool fresh) {
  return SRC == FRESH_SPLIT || (SRC == ANY_SPLIT && fresh);
}

// The mask tile of cells c0 .. c0 + 63 for tokens tok0 .. tok0 + ntok - 1
// into mk [ntok][CT]; returns, in every thread, whether any cell is seen.
// A cache split reads whole 8-byte words of mask [nt, mask_ld] (padded to
// whole tiles with zeros); kernel 9's fresh split reads mask_new
// [nt, nt] a byte at a time, 0 past column nt.
template <int SRC>
__device__ __forceinline__ bool stage_mask(const FlashArgs& a, bool fresh, int tok0, int ntok,
                                           int c0, int8_t* mk) {
  int any = 0;
  if (is_fresh<SRC>(fresh)) {
    for (int idx = threadIdx.x; idx < ntok * CT; idx += THREADS) {
      const int tk = idx / CT, c = idx % CT;
      const int8_t m = c0 + c < a.nt ? a.mask_new[(size_t)(tok0 + tk) * a.nt + c0 + c] : 0;
      mk[tk * CT + c] = m;
      any |= m != 0;
    }
  } else {
    for (int idx = threadIdx.x; idx < ntok * (CT / 8); idx += THREADS) {
      const int tk = idx / (CT / 8), c8 = idx % (CT / 8);
      const uint2 m = *reinterpret_cast<const uint2*>(a.mask + (size_t)(tok0 + tk) * a.mask_ld +
                                                      c0 + c8 * 8);
      *reinterpret_cast<uint2*>(mk + tk * CT + c8 * 8) = m;
      any |= (m.x | m.y) != 0;
    }
  }
  return __syncthreads_or(any);
}

// cp.async copies of the tile's 64 rows (K, V, and on a quantized cache
// their scales) into stage st: cache rows row0 .. row0 + 63 (row0 = the
// head's first row + c0), or kernel 9's fresh rows c0 .. c0 + 63 of kv head
// kvh (bf16, token-major).  Rows at or past n_vis (nt) are
// zero-filled from the tile's first row, which is valid.
template <typename T, int D, int SRC>
__device__ __forceinline__ void load_stage(const FlashArgs& a, bool fresh, size_t row0, int c0,
                                           int kvh, uint8_t* st) {
  using C = Cache<T, D>;
  constexpr int CHUNKS = C::ROW / 16;  // 16-byte copies a row
  constexpr int ld = C::QUANT ? C::ROW : C::KLD * 2;  // bytes a row in the stage
  const bool fr = is_fresh<SRC>(fresh);
  const int live = (fr ? a.nt : a.n_vis) - c0;
  const uint8_t* kc;
  const uint8_t* vc;
  size_t stride;
  if (fr) {
    kc = reinterpret_cast<const uint8_t*>(a.kn + ((size_t)c0 * a.KV + kvh) * D);
    vc = reinterpret_cast<const uint8_t*>(a.vn + ((size_t)c0 * a.KV + kvh) * D);
    stride = (size_t)a.KV * D * 2;
  } else {
    kc = static_cast<const uint8_t*>(a.kc) + row0 * C::ROW;
    vc = static_cast<const uint8_t*>(a.vc) + row0 * C::ROW;
    stride = C::ROW;
  }
  for (int idx = threadIdx.x; idx < CT * CHUNKS; idx += THREADS) {
    const int c = idx / CHUNKS, j = idx % CHUNKS;
    const bool ok = c < live;
    const size_t off = (ok ? (size_t)c * stride : 0) + j * 16;
    cp_async16(st + c * ld + j * 16, kc + off, ok ? 16 : 0);
    cp_async16(st + C::RAW + c * ld + j * 16, vc + off, ok ? 16 : 0);
  }
  if constexpr (C::QUANT) {
    float* sc = reinterpret_cast<float*>(st + 2 * C::RAW);
    const int c = threadIdx.x % CT;
    const bool ok = c < live;
    const float* src = threadIdx.x < CT ? a.ks : a.vs;
    cp_async4(sc + (threadIdx.x < CT ? 0 : CT) + c, src + row0 + (ok ? c : 0), ok ? 4 : 0);
  }
}

// Raw codes of stage st widened into the bf16 K/V tiles at wide.
template <typename T, int D>
__device__ __forceinline__ void widen(const uint8_t* st, uint8_t* wide) {
  using C = Cache<T, D>;
  for (int idx = threadIdx.x; idx < 2 * CT * (C::ROW / 16); idx += THREADS) {
    const int m = idx / (CT * (C::ROW / 16)), rest = idx % (CT * (C::ROW / 16));
    const int c = rest / (C::ROW / 16), j = rest % (C::ROW / 16);
    const uint4 w = *reinterpret_cast<const uint4*>(st + m * C::RAW + c * C::ROW + j * 16);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
    __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(wide + m * C::TILE_BYTES) + c * C::KLD;
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = wv[i];
      if constexpr (std::is_same<T, int8_t>::value) {  // dims 16j + 4i .. + 3
        lo[2 * i] = pack_bf16((float)(int8_t)(v & 0xFF), (float)(int8_t)((v >> 8) & 0xFF));
        lo[2 * i + 1] = pack_bf16((float)(int8_t)((v >> 16) & 0xFF), (float)(int8_t)(v >> 24));
      } else {  // bytes 16j + 4i .. + 3: dims of that index (lo) and D/2 on (hi)
        float l[4], h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = (v >> (8 * e)) & 0xFF;
          l[e] = (float)((b & 0x0F) - 8);
          h[e] = (float)(((b >> 4) ^ 8) - 8);  // sign-extend the 4-bit code
        }
        lo[2 * i] = pack_bf16(l[0], l[1]);
        lo[2 * i + 1] = pack_bf16(l[2], l[3]);
        hi[2 * i] = pack_bf16(h[0], h[1]);
        hi[2 * i + 1] = pack_bf16(h[2], h[3]);
      }
    }
    uint4* dl = reinterpret_cast<uint4*>(row + 16 * j);
    dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    if constexpr (std::is_same<T, q4_packed>::value) {
      uint4* dh = reinterpret_cast<uint4*>(row + D / 2 + 16 * j);
      dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

// The tile's scores s[j][e] (cells 8j + 2t + (e & 1) of row h = e >> 1)
// scaled, times the K scale (QUANT), soft-capped (SOFTCAP) and masked:
// unseen cells -1e30, their bits in vis; mx the rows' maxima.
template <bool QUANT, bool SOFTCAP>
__device__ __forceinline__ void mask_scores(float (&s)[8][4], uint32_t& vis, float (&mx)[2],
                                            float scale, float softcap, const float* ksc,
                                            const bool (&rows_in)[2],
                                            const int8_t* const (&mrow)[2], int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1), h = e >> 1;
      float v = s[j][e] * scale;
      if (QUANT) v *= ksc[c];
      if (SOFTCAP) v = tanhf(v / softcap) * softcap;
      const bool seen = rows_in[h] && mrow[h][c] != 0;
      vis |= (uint32_t)seen << (4 * j + e);
      s[j][e] = seen ? v : FLASH_NEG_INF;
      mx[h] = fmaxf(mx[h], s[j][e]);
    }
}

// One split's walk for this block's rows: the cells of cache split
// cell_split, or kernel 9's fresh rows (is_fresh); (acc, m, l) of rows ra
// and rb of each warp into part_o / part_ml at split index blockIdx.z.
template <typename T, int D, int SRC>
__device__ __forceinline__ void walk(const FlashArgs& a, uint8_t* smem, int cell_split,
                                     bool fresh) {
  using C = Cache<T, D>;
  constexpr int KK = D / 16;  // k16 steps of Q K^T; n16 pairs of P V
  uint8_t* ring = smem;
  uint8_t* wide = smem + 2 * C::STAGE;
  int8_t* masks = reinterpret_cast<int8_t*>(wide + C::WIDE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.x, rep = a.H / a.KV, R = rep * a.nt;
  const int r0 = blockIdx.y * BM, split = blockIdx.z;
  const bool fr = is_fresh<SRC>(fresh);
  const int c_begin = fr ? 0 : cell_split * a.split_cells;
  const int c_end = fr ? a.nt : min(a.n_vis, c_begin + a.split_cells);
  const int tok0 = r0 / rep, ntok = (min(R, r0 + BM) - 1) / rep - tok0 + 1;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;  // this thread's two rows
  const bool live = r0 + warp * 16 < R;            // the warp has a row
  const int ta = ra / rep - tok0, tb = rb / rep - tok0;  // their tokens in the mask tile

  // Q fragments (bf16 pairs): qa[kk] = rows ra / rb at dims 16kk + 2t, +1
  // and 16kk + 8 + 2t, +1; rows past R are zero
  uint32_t qa[KK][4];
  {
    const __nv_bfloat16* qra =
        a.q + ((size_t)(ra / rep) * a.H + kvh * rep + ra % rep) * D + 2 * t;
    const __nv_bfloat16* qrb =
        a.q + ((size_t)(rb / rep) * a.H + kvh * rep + rb % rep) * D + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      qa[kk][0] = ra < R ? *reinterpret_cast<const uint32_t*>(qra + 16 * kk) : 0u;
      qa[kk][1] = rb < R ? *reinterpret_cast<const uint32_t*>(qrb + 16 * kk) : 0u;
      qa[kk][2] = ra < R ? *reinterpret_cast<const uint32_t*>(qra + 16 * kk + 8) : 0u;
      qa[kk][3] = rb < R ? *reinterpret_cast<const uint32_t*>(qrb + 16 * kk + 8) : 0u;
    }
  }
  float m_run[2] = {FLASH_NEG_INF, FLASH_NEG_INF}, l_run[2] = {0.f, 0.f};
  float o[2 * KK][4];
#pragma unroll
  for (int n = 0; n < 2 * KK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const size_t head_base = fr ? 0 : ((size_t)a.layer * a.KV + kvh) * a.cells;
  // the first live tile: its mask in stage 0, its K/V requested
  int cur = c_begin;
  while (cur < c_end && !stage_mask<SRC>(a, fr, tok0, ntok, cur, masks)) cur += CT;
  if (cur < c_end) load_stage<T, D, SRC>(a, fr, head_base + cur, cur, kvh, ring);
  cp_async_commit();
  int buf = 0;
  const int lr = lane & 7, lm = lane >> 3;  // the ldmatrix row this lane names, its matrix
  while (cur < c_end) {
    // the next live tile: its mask and K/V into the other stage, in flight
    // while this one is multiplied
    int nxt = cur + CT;
    int8_t* mk_nxt = masks + (buf ^ 1) * BM * CT;
    while (nxt < c_end && !stage_mask<SRC>(a, fr, tok0, ntok, nxt, mk_nxt)) nxt += CT;
    if (nxt < c_end)
      load_stage<T, D, SRC>(a, fr, head_base + nxt, nxt, kvh, ring + (buf ^ 1) * C::STAGE);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = ring + buf * C::STAGE;
    const uint8_t* kt = st;
    if constexpr (C::QUANT) {
      widen<T, D>(st, wide);
      __syncthreads();
      kt = wide;
    }
    const uint8_t* vt = kt + (C::QUANT ? C::TILE_BYTES : C::RAW);
    const float* ksc = reinterpret_cast<const float*>(st + 2 * C::RAW);
    const int8_t* mk = masks + buf * BM * CT;

    if (live) {
      // S = Q K^T: s[j] holds cells 8j + 2t, +1 of rows ra (e 0, 1) and rb (e 2, 3)
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];  // cells 16jp + 8 (lm >> 1) + lr, dims 16kk + 8 (lm & 1)
          ldmatrix_x4(b, kt + (16 * jp + 8 * (lm >> 1) + lr) * C::KLD * 2 +
                             (16 * kk + 8 * (lm & 1)) * 2);
          mma_bf16(s[2 * jp], qa[kk], b);
          mma_bf16(s[2 * jp + 1], qa[kk], b + 2);
        }
      // scale, K scale, softcap, mask; the tile's row max (the softcap
      // test taken once a tile, not once an element)
      uint32_t vis = 0;
      float mx[2] = {FLASH_NEG_INF, FLASH_NEG_INF};
      const bool rows_in[2] = {ra < R, rb < R};
      const int8_t* mrow[2] = {mk + ta * CT, mk + tb * CT};
      if (a.softcap > 0.f)
        mask_scores<C::QUANT, true>(s, vis, mx, a.scale, a.softcap, ksc, rows_in, mrow, t);
      else
        mask_scores<C::QUANT, false>(s, vis, mx, a.scale, a.softcap, ksc, rows_in, mrow, t);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(LK_FULL_MASK, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(LK_FULL_MASK, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        alpha[h] = expf(m_run[h] - m_new);
        m_run[h] = m_new;
      }
      const float* vsc = ksc + CT;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = (vis >> (4 * j + e)) & 1 ? expf(s[j][e] - m_run[h]) : 0.f;
          sum[h] += p;
          // the V scale folds into p only after l has taken the unscaled p
          s[j][e] = C::QUANT ? p * vsc[8 * j + 2 * t + (e & 1)] : p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(LK_FULL_MASK, sum[h], 1);
        sum[h] += __shfl_xor_sync(LK_FULL_MASK, sum[h], 2);
        l_run[h] = l_run[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int n = 0; n < 2 * KK; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P V, P as p_hi + p_lo: the A fragment of cells 16kk .. + 15 is
      // S's tiles 2kk (k 2t, 2t+1) and 2kk + 1 (k 2t + 8, 2t + 9)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // a[i]: tile 2kk + (i >> 1), row ra (i even) or rb
          const float* v = &s[2 * kk + (i >> 1)][2 * (i & 1)];
          ph[i] = pack_bf16(v[0], v[1]);
          const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&ph[i]);
          const float2 hf = __bfloat1622float2(hb);
          pl[i] = pack_bf16(v[0] - hf.x, v[1] - hf.y);
        }
#pragma unroll
        for (int np = 0; np < KK; ++np) {
          uint32_t b[4];  // cells 16kk + 8 (lm & 1) + lr, dims 16np + 8 (lm >> 1)
          ldmatrix_x4_trans(b, vt + (16 * kk + 8 * (lm & 1) + lr) * C::KLD * 2 +
                                   (16 * np + 8 * (lm >> 1)) * 2);
          mma_bf16(o[2 * np], ph, b);
          mma_bf16(o[2 * np], pl, b);
          mma_bf16(o[2 * np + 1], ph, b + 2);
          mma_bf16(o[2 * np + 1], pl, b + 2);
        }
      }
    }
    __syncthreads();  // this stage and the widened tile are free again
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();

  // this split's (acc, m, l) for rows ra and rb
  const size_t rows_total = (size_t)a.KV * R;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if (r >= R) continue;
    const size_t row = (size_t)split * rows_total + (size_t)kvh * R + r;
#pragma unroll
    for (int n = 0; n < 2 * KK; ++n)
      *reinterpret_cast<float2*>(a.part_o + row * D + 8 * n + 2 * t) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (t == 0) {
      a.part_ml[2 * row] = m_run[h];
      a.part_ml[2 * row + 1] = l_run[h];
    }
  }
}

// The shared memory a launch needs: kernel 9's blocks may walk its bf16
// fresh rows on an int8 cache.
template <typename T, int D, bool STACKED>
constexpr int smem_bytes() {
  return STACKED && Cache<__nv_bfloat16, D>::SMEM > Cache<T, D>::SMEM
             ? Cache<__nv_bfloat16, D>::SMEM
             : Cache<T, D>::SMEM;
}

// q [nt, H, D] rows of the GQA row space -> per-split (acc, m, l) in
// part_o / part_ml.  Grid (KV, ceil(R / BM), n_old + STACKED): kernel 3's
// splits walk the cache cells; kernel 9's split 0 walks the fresh rows
// and splits 1 .. n_old the cells.
template <typename T, int D, bool STACKED>
__global__ void __launch_bounds__(THREADS) flash_mma_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  if constexpr (!STACKED) {
    walk<T, D, CACHE_SPLIT>(a, smem, blockIdx.z, false);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // one walk for both kinds of split: the fresh rows' blocks run the
    // code the cache splits' blocks have already brought in
    walk<T, D, ANY_SPLIT>(a, smem, blockIdx.z - 1, blockIdx.z == 0);
  } else if (blockIdx.z == 0) {
    walk<__nv_bfloat16, D, FRESH_SPLIT>(a, smem, 0, true);
  } else {
    walk<T, D, CACHE_SPLIT>(a, smem, blockIdx.z - 1, false);
  }
}

// Merge the splits of one (kv head, row) and write out[t, h, :] in bf16;
// a row that sees no cell gets 0.  One thread a dim.
template <int D>
__global__ void __launch_bounds__(D)
flash_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                   __nv_bfloat16* __restrict__ out, int nt, int H, int KV, int nsplit) {
  const int row = blockIdx.x, tid = threadIdx.x;
  const int rep = H / KV, R = rep * nt;
  const size_t rows_total = (size_t)KV * R;
  float m = FLASH_NEG_INF;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_ml[2 * (s * rows_total + row)]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const size_t pr = s * rows_total + row;
    const float w = expf(part_ml[2 * pr] - m);
    l += part_ml[2 * pr + 1] * w;
    o += part_o[pr * D + tid] * w;
  }
  const int kvh = row / R, r = row % R;
  const int t = r / rep, h = kvh * rep + r % rep;
  out[((size_t)t * H + h) * D + tid] = __float2bfloat16_rn(l > 0.f ? o / l : 0.f);
}

template <typename T, int D, bool STACKED>
inline int launch_d(const FlashArgs& a, __nv_bfloat16* out, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<T, D, STACKED>();
  const int R = (a.H / a.KV) * a.nt;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<T, D, STACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int splits = a.n_old + (STACKED ? 1 : 0);
  const dim3 grid(a.KV, (R + BM - 1) / BM, splits);
  flash_mma_kernel<T, D, STACKED><<<grid, THREADS, SMEM, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_merge_kernel<D><<<a.KV * R, D, 0, stream>>>(a.part_o, a.part_ml, out, a.nt, a.H, a.KV,
                                                    splits);
  return (int)cudaGetLastError();
}

// The splits (n_old over the cache, and kernel 9's fresh split) and the
// merge; the cache element is bf16, int8 or (packed) q4_packed, with
// scales for the two quantized ones.  Sets a.split_cells.  Returns a CUDA
// error code, cudaErrorInvalidValue for a shape the kernels do not take.
template <typename T, bool STACKED>
inline int launch(FlashArgs a, __nv_bfloat16* out, cudaStream_t stream) {
  const int tiles = (a.n_vis + CT - 1) / CT;
  if (a.nt <= 0 || a.KV <= 0 || a.H % a.KV || (a.D != 64 && a.D != 128) || a.n_vis <= 0 ||
      a.n_vis > a.cells || a.mask_ld < tiles * CT || a.mask_ld % 8 || a.n_old <= 0 ||
      tiles % a.n_old ||
      Cache<T, 128>::QUANT != (a.ks != nullptr && a.vs != nullptr) ||
      STACKED != (a.kn != nullptr && a.vn != nullptr && a.mask_new != nullptr))
    return (int)cudaErrorInvalidValue;
  a.split_cells = tiles / a.n_old * CT;
  return a.D == 64 ? launch_d<T, 64, STACKED>(a, out, stream)
                   : launch_d<T, 128, STACKED>(a, out, stream);
}
}  // namespace flmma

}  // namespace
