// Kernel 3's tile (flash.cu), at every row count: the masked GQA online
// softmax with Q K^T and P V on bf16 tensor cores (mma.sync m16n8k16, f32
// accumulators), the FlashAttention-2 shape.  It replaced kernel 3's walk
// (the scalar f32 products kernel 9 keeps, flash_tile.cuh), which it beats
// on the H100 from decode's 4 rows a kv head up (PERF.md, kernel 3).
//
// A block owns one kv head, BM = 64 rows of that head's GQA row space (row
// r = token r / rep, head kvh * rep + r % rep, as in the walk) and one
// split of the visible cells; warp w owns rows 16w .. 16w + 15 and keeps
// their Q fragments in registers for the whole walk.  64-cell K/V tiles
// are double-buffered in shared memory by cp.async and fed to the products
// by ldmatrix (.trans for V).  An int8 or packed int4 cache lands raw in
// the ring and is widened to bf16 on its way into the tile (codes of at
// most 8 bits are exact in bf16): int8 as is, int4 as the walk unpacks it
// (low nibble: code + 8 of dim j; high nibble: the two's-complement code
// of dim j + 64).
//
// The arithmetic is the walk's and JAX's: S = (q . k) * scale, times the
// row's K scale ks[c] on a quantized cache, then the softcap, then the
// mask; the running max and sum per row by quad shuffles; l takes the
// unscaled p, then the V scale vs[c] folds into p before P V.  The S
// accumulator fragment is P's A fragment (no trip through shared memory).
// P is f32 in JAX: it is fed as p_hi + p_lo, two bf16 products (p_hi =
// bf16(p), p_lo = bf16(p - p_hi)), whose sum is within 2^-16 of p, where
// one bf16 P is within 2^-8.
//
// Dead tiles: before a tile's K/V is requested, the block reads its
// [tokens x 64] mask tile (kept for the products) and skips the tile when
// no row of the block sees a cell of it (__syncthreads_or): in the online
// softmax such a tile is an exact no-op.  In serving that is the common
// case (a visibility bucket of 512 cells with 64-96 live), so most splits
// of a prefill do no more than read their mask and write m = -1e30, l = 0,
// acc = 0, which the merge weighs by 0.
//
// Bound on the H100: bytes (one read of the visible K/V prefix and its
// scales: per cached row and plane 256 bytes in bf16, 128 + 4 in int8,
// 64 + 4 packed int4).  At decode and at a 64-token prefill over 512 cells
// with 64 live that is a few hundred KB, so the two launches (the splits,
// the merge) and each block's walk of its tiles set the time.
//
// Packed int4 cache (the JAX package's q4_0 layout, kept so that state
// blobs cross-load): the Pallas kernel's folds of the +8 into a per-row
// constant and of the high nibble's 16x into q are Mosaic workarounds (no
// 8-bit shifts) and are not carried over.
#pragma once

#include "flash_tile.cuh"
#include "mma_pipe.cuh"

namespace {  // internal linkage, as flash_tile.cuh

// Tag type of the packed int4 cache: 64 bytes a row, two codes a byte.
struct q4_packed {};

namespace flmma {
constexpr int WARPS = 4, THREADS = 32 * WARPS, BM = 16 * WARPS;  // rows a block
constexpr int KLD = FD + 8;  // bf16 a K/V tile row (272 bytes: ldmatrix conflict-free)
constexpr int TILE_BYTES = CT * KLD * 2;  // one K or V tile in bf16

// The element of the cache's rows: its bytes a row, and whether the ring
// holds raw codes to widen (int8, packed int4) or the bf16 tile itself.
template <typename T>
struct Cache {
  static constexpr bool QUANT = !std::is_same<T, __nv_bfloat16>::value;
  static constexpr int ROW = std::is_same<T, q4_packed>::value ? FD / 2
                             : std::is_same<T, int8_t>::value  ? FD
                                                               : 2 * FD;
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

// The mask tile of cells c0 .. c0 + 63 for tokens tok0 .. tok0 + ntok - 1
// into mk [ntok][CT]; returns, in every thread, whether any cell is seen.
__device__ __forceinline__ bool stage_mask(const FlashArgs& a, int tok0, int ntok, int c0,
                                           int8_t* mk) {
  int any = 0;
  for (int idx = threadIdx.x; idx < ntok * (CT / 8); idx += THREADS) {
    const int tk = idx / (CT / 8), c8 = idx % (CT / 8);
    const uint2 m = *reinterpret_cast<const uint2*>(a.mask + (size_t)(tok0 + tk) * a.n_vis + c0 +
                                                    c8 * 8);
    *reinterpret_cast<uint2*>(mk + tk * CT + c8 * 8) = m;
    any |= (m.x | m.y) != 0;
  }
  return __syncthreads_or(any);
}

// cp.async copies of cache rows row0 .. row0 + 63 (K, V, and on a
// quantized cache their scales) into stage st.
template <typename T>
__device__ __forceinline__ void load_stage(const FlashArgs& a, size_t row0, uint8_t* st) {
  using C = Cache<T>;
  constexpr int CHUNKS = C::ROW / 16;  // 16-byte copies a row
  const uint8_t* kc = static_cast<const uint8_t*>(a.kc) + row0 * C::ROW;
  const uint8_t* vc = static_cast<const uint8_t*>(a.vc) + row0 * C::ROW;
  const int ld = C::QUANT ? C::ROW : KLD * 2;  // bytes a row in the stage
  for (int idx = threadIdx.x; idx < CT * CHUNKS; idx += THREADS) {
    const int c = idx / CHUNKS, j = idx % CHUNKS;
    cp_async16(st + c * ld + j * 16, kc + (size_t)c * C::ROW + j * 16, 16);
    cp_async16(st + C::RAW + c * ld + j * 16, vc + (size_t)c * C::ROW + j * 16, 16);
  }
  if constexpr (C::QUANT) {
    float* sc = reinterpret_cast<float*>(st + 2 * C::RAW);
    const int c = threadIdx.x % CT;
    const float* src = threadIdx.x < CT ? a.ks : a.vs;
    cp_async4(sc + (threadIdx.x < CT ? 0 : CT) + c, src + row0 + c, 4);
  }
}

// Raw codes of stage st widened into the bf16 K/V tiles at wide.
template <typename T>
__device__ __forceinline__ void widen(const uint8_t* st, uint8_t* wide) {
  using C = Cache<T>;
  for (int idx = threadIdx.x; idx < 2 * CT * (C::ROW / 16); idx += THREADS) {
    const int m = idx / (CT * (C::ROW / 16)), rest = idx % (CT * (C::ROW / 16));
    const int c = rest / (C::ROW / 16), j = rest % (C::ROW / 16);
    const uint4 w = *reinterpret_cast<const uint4*>(st + m * C::RAW + c * C::ROW + j * 16);
    const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
    __nv_bfloat16* row = reinterpret_cast<__nv_bfloat16*>(wide + m * TILE_BYTES) + c * KLD;
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = wv[i];
      if constexpr (std::is_same<T, int8_t>::value) {  // dims 16j + 4i .. + 3
        lo[2 * i] = pack_bf16((float)(int8_t)(v & 0xFF), (float)(int8_t)((v >> 8) & 0xFF));
        lo[2 * i + 1] = pack_bf16((float)(int8_t)((v >> 16) & 0xFF), (float)(int8_t)(v >> 24));
      } else {  // bytes 16j + 4i .. + 3: dims of that index (lo) and 64 on (hi)
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
      uint4* dh = reinterpret_cast<uint4*>(row + FD / 2 + 16 * j);
      dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

// q [nt, H, D] rows of the GQA row space -> per-split (acc, m, l) in
// part_o / part_ml, as flash_split_kernel writes them.  Grid (KV,
// ceil(R / BM), n_old).
template <typename T>
__global__ void __launch_bounds__(THREADS) flash_mma_kernel(const FlashArgs a) {
  using C = Cache<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  uint8_t* wide = smem + 2 * C::STAGE;
  int8_t* masks = reinterpret_cast<int8_t*>(wide + C::WIDE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.x, rep = a.H / a.KV, R = rep * a.nt;
  const int r0 = blockIdx.y * BM, split = blockIdx.z;
  const int c_begin = split * a.split_cells, c_end = min(a.n_vis, c_begin + a.split_cells);
  const int tok0 = r0 / rep, ntok = (min(R, r0 + BM) - 1) / rep - tok0 + 1;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;  // this thread's two rows
  const bool live = r0 + warp * 16 < R;            // the warp has a row
  const int ta = ra / rep - tok0, tb = rb / rep - tok0;  // their tokens in the mask tile

  // Q fragments (bf16 pairs): qa[kk] = rows ra / rb at dims 16kk + 2t, +1
  // and 16kk + 8 + 2t, +1; rows past R are zero
  uint32_t qa[8][4];
  {
    const __nv_bfloat16* qra =
        a.q + ((size_t)(ra / rep) * a.H + kvh * rep + ra % rep) * FD + 2 * t;
    const __nv_bfloat16* qrb =
        a.q + ((size_t)(rb / rep) * a.H + kvh * rep + rb % rep) * FD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      qa[kk][0] = ra < R ? *reinterpret_cast<const uint32_t*>(qra + 16 * kk) : 0u;
      qa[kk][1] = rb < R ? *reinterpret_cast<const uint32_t*>(qrb + 16 * kk) : 0u;
      qa[kk][2] = ra < R ? *reinterpret_cast<const uint32_t*>(qra + 16 * kk + 8) : 0u;
      qa[kk][3] = rb < R ? *reinterpret_cast<const uint32_t*>(qrb + 16 * kk + 8) : 0u;
    }
  }
  float m_run[2] = {FLASH_NEG_INF, FLASH_NEG_INF}, l_run[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const size_t head_base = ((size_t)a.layer * a.KV + kvh) * a.cells;
  // the first live tile: its mask in stage 0, its K/V requested
  int cur = c_begin;
  while (cur < c_end && !stage_mask(a, tok0, ntok, cur, masks)) cur += CT;
  if (cur < c_end) load_stage<T>(a, head_base + cur, ring);
  cp_async_commit();
  int buf = 0;
  const int lr = lane & 7, lm = lane >> 3;  // the ldmatrix row this lane names, its matrix
  while (cur < c_end) {
    // the next live tile: its mask and K/V into the other stage, in flight
    // while this one is multiplied
    int nxt = cur + CT;
    int8_t* mk_nxt = masks + (buf ^ 1) * BM * CT;
    while (nxt < c_end && !stage_mask(a, tok0, ntok, nxt, mk_nxt)) nxt += CT;
    if (nxt < c_end) load_stage<T>(a, head_base + nxt, ring + (buf ^ 1) * C::STAGE);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = ring + buf * C::STAGE;
    const uint8_t* kt = st;
    if constexpr (C::QUANT) {
      widen<T>(st, wide);
      __syncthreads();
      kt = wide;
    }
    const uint8_t* vt = kt + (C::QUANT ? TILE_BYTES : C::RAW);
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
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];  // cells 16jp + 8 (lm >> 1) + lr, dims 16kk + 8 (lm & 1)
          ldmatrix_x4(b, kt + (16 * jp + 8 * (lm >> 1) + lr) * KLD * 2 + (16 * kk + 8 * (lm & 1)) * 2);
          mma_bf16(s[2 * jp], qa[kk], b);
          mma_bf16(s[2 * jp + 1], qa[kk], b + 2);
        }
      // scale, K scale, softcap, mask; the tile's row max
      uint32_t vis = 0;
      float mx[2] = {FLASH_NEG_INF, FLASH_NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), h = e >> 1;
          float v = s[j][e] * a.scale;
          if (C::QUANT) v *= ksc[c];
          if (a.softcap > 0.f) v = tanhf(v / a.softcap) * a.softcap;
          const int r = h ? rb : ra, tk = h ? tb : ta;
          const bool seen = r < R && mk[tk * CT + c] != 0;
          vis |= (uint32_t)seen << (4 * j + e);
          s[j][e] = seen ? v : FLASH_NEG_INF;
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
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
      for (int n = 0; n < 16; ++n) {
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
        for (int np = 0; np < 8; ++np) {
          uint32_t b[4];  // cells 16kk + 8 (lm & 1) + lr, dims 16np + 8 (lm >> 1)
          ldmatrix_x4_trans(b, vt + (16 * kk + 8 * (lm & 1) + lr) * KLD * 2 +
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
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(a.part_o + row * FD + 8 * n + 2 * t) =
          make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (t == 0) {
      a.part_ml[2 * row] = m_run[h];
      a.part_ml[2 * row + 1] = l_run[h];
    }
  }
}

// The tensor-core splits (n_old over the cache) and the merge; the cache
// element is bf16, int8 or (packed) q4_packed, with scales for the two
// quantized ones.  Returns a CUDA error code, cudaErrorInvalidValue for a
// shape the kernel does not take.
template <typename T>
inline int launch(const FlashArgs& a, __nv_bfloat16* out, cudaStream_t stream) {
  using C = Cache<T>;
  if (a.nt <= 0 || a.KV <= 0 || a.H % a.KV || a.n_vis <= 0 || a.n_vis % CT ||
      a.n_vis > a.cells || a.n_old <= 0 || (a.n_vis / CT) % a.n_old || a.kn != nullptr ||
      C::QUANT != (a.ks != nullptr && a.vs != nullptr))
    return (int)cudaErrorInvalidValue;
  const int R = (a.H / a.KV) * a.nt;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const dim3 grid(a.KV, (R + BM - 1) / BM, a.n_old);
  flash_mma_kernel<T><<<grid, THREADS, C::SMEM, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_merge_kernel<<<a.KV * R, NTHR, 0, stream>>>(a.part_o, a.part_ml, out, a.nt, a.H, a.KV,
                                                   a.n_old);
  return (int)cudaGetLastError();
}
}  // namespace flmma

}  // namespace
