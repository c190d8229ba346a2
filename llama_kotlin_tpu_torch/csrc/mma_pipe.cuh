// Pieces shared by the tensor-core GEMMs of kernel 4 (qmm.cu) and of
// kernels 5, 7 and 8 above their row thresholds (w8_mma.cuh, w4_mma.cuh):
// cp.async copies into a shared-memory ring, the mma.sync products, the
// bf16 dequantization of whole 32-bit code words, the fixed-order sum of
// split-K partials and the int8 GEMMs' epilogue.
#pragma once

#include "common.cuh"

// --- cp.async (sm_80+): global -> shared without registers -------------
// `bytes` < the copy size zero-fills the rest (0: the whole copy), which
// masks rows past the ragged edge; src must still be a valid address.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- tensor-core products (PTX ISA fragment layouts; g = lane / 4,
// t = lane % 4): A rows g and g+8, B column g, C rows g and g+8 at
// columns 2t and 2t+1 ---------------------------------------------------
// bf16 m16n8k16, f32 accumulators.  a[0], a[2]: row g at k {2t, 2t+1} and
// {2t+8, 2t+9}; a[1], a[3] the same for row g+8; b[0], b[1]: k {2t, 2t+1}
// and {2t+8, 2t+9} of column g (the lower k in the lower half).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// s8 m16n8k32, exact int32 products into zeroed accumulators.  a[0],
// a[2]: row g at k 4t..4t+3 and 16+4t..16+4t+3; a[1], a[3] row g+8;
// b[0], b[1]: the same k of column g.
__device__ __forceinline__ void mma_s8_zero(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
}

// The same product plus 0x4B400000 (kernels 2, 5, 6, 10): c[e] holds the
// bits of the f32 2^23 + 2^22 + P (|P| < 2^22), so exact_f gives P as an
// f32 with one FADD, where a conversion instruction would run at a quarter
// of the FADD rate.
constexpr int MAGIC_I = 0x4B400000;
constexpr float MAGIC_F = 12582912.f;  // 2^23 + 2^22
__device__ __forceinline__ void mma_s8_magic(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(MAGIC_I));
}
__device__ __forceinline__ float exact_f(int c) { return __int_as_float(c) - MAGIC_F; }

// ldmatrix x4: thread i names row i % 8 of 8x16-byte matrix i / 8 (a
// 16-byte aligned shared address); r[j] receives word t of row g of
// matrix j, the fragment layout of the products above.  The .trans form
// gives thread (g, t) the 16-bit elements at rows 2t and 2t+1 of column g
// of each matrix instead: a B fragment of a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// --- dequantization of one 32-bit code word ----------------------------
// Byte i of v (0..255) as an exact f32 plus 2^23: __byte_perm puts it in
// the mantissa of 2^23 (0x4B0000vv), so one subtraction gives the value.
__device__ __forceinline__ float byte_f(uint32_t v, int i) {
  return __int_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | i));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// W4: the 4 low nibbles (raw codes 0..15) of a word, or its 4 pre-signed
// high nibbles (q - 8), as w = plane * s - m in f32 without contraction,
// rounded to bf16 pairs: out[0] = elements 0, 1 and out[1] = 2, 3.  For
// the low nibbles one FMA gives plane * s: (2^23 + q) s - 2^23 s is q s
// exactly before its one rounding, the rounding of __fmul_rn(q, s).
__device__ __forceinline__ void dequant_w4_lo(uint32_t w, float s, float m, uint32_t out[2]) {
  const uint32_t v = w & 0x0F0F0F0Fu;
  const float ns = -8388608.f * s;  // exact: a power-of-two multiple
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __fsub_rn(__fmaf_rn(byte_f(v, i), s, ns), m);
  out[0] = pack_bf16(f[0], f[1]);
  out[1] = pack_bf16(f[2], f[3]);
}
__device__ __forceinline__ void dequant_w4_hi(uint32_t w, float s, float m, uint32_t out[2]) {
  const uint32_t v = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // q - 8 + 8
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __fsub_rn(__fmul_rn(byte_f(v, i) - 8388616.f, s), m);
  out[0] = pack_bf16(f[0], f[1]);
  out[1] = pack_bf16(f[2], f[3]);
}

// W8: 4 int8 codes of a word as w = code * s (- m) in f32 without
// contraction, rounded to bf16 pairs.
template <bool HAS_MIN>
__device__ __forceinline__ void dequant_w8_word(uint32_t w, float s, float m, uint32_t out[2]) {
  const uint32_t u = w ^ 0x80808080u;  // code + 128 in each byte
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __fmul_rn(byte_f(u, i) - 8388736.f, s);
    if (HAS_MIN) f[i] = __fsub_rn(f[i], m);
  }
  out[0] = pack_bf16(f[0], f[1]);
  out[1] = pack_bf16(f[2], f[3]);
}

// Host side: sets KERN's dynamic shared memory once, then launches it with
// the enclosing namespace's THREADS and returns the launch's error.
#define LK_MMA_LAUNCH(KERN, SMEM_BYTES, GRID, STREAM, ...)                               \
  {                                                                                      \
    auto kern = KERN;                                                                    \
    static bool sized = false;                                                           \
    if (!sized) {                                                                        \
      const cudaError_t err =                                                            \
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES); \
      if (err != cudaSuccess) return (int)err;                                           \
      sized = true;                                                                      \
    }                                                                                    \
    kern<<<GRID, THREADS, SMEM_BYTES, STREAM>>>(__VA_ARGS__);                            \
    return (int)cudaGetLastError();                                                      \
  }

// --- split-K partials, summed in a fixed order -------------------------
// A K range [u0, u1) of split z of `splits` over `units` units; the
// wrapper's plan (ops/cuda/qmm.py::split_bounds) uses the same formula.
__device__ __forceinline__ void split_range(int z, int splits, int units, int* u0, int* u1) {
  *u0 = (int)((long long)z * units / splits);
  *u1 = (int)((long long)(z + 1) * units / splits);
}

// Every thread of a block calls this after storing its partial of tile
// `tile`.  Returns true in the block that arrives last, which then sums
// every split's partial in split order (split_sum), so the output repeats
// bit for bit.  The counter is an int (no float atomics) and is left at 0
// for the next launch.
__device__ __forceinline__ bool split_arrive_last(int* cnt, int tile, int splits) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(cnt + tile, 1) == splits - 1;
    if (last) cnt[tile] = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last block's sum: y[r][c] = ws[0][r][c] + ws[1][r][c] + ... in split
// order, over rows [r0, r0 + nr) and columns [c0, c0 + nc) of row-major
// planes of `plane` floats with row stride ld (ld, c0 and nc multiples of
// 4: float4 rows).  Each thread keeps 4 float4 sums, so the L2 reads of a
// split are in flight together.
__device__ __forceinline__ void split_sum(const float* __restrict__ ws, float* __restrict__ y,
                                          int splits, size_t plane, int ld, int r0, int nr,
                                          int c0, int nc) {
  const int q = nc >> 2, total = nr * q;
  for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
    float4 v[4];
    size_t off[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = base + j * blockDim.x;
      ok[j] = idx < total;
      off[j] = ok[j] ? (size_t)(r0 + idx / q) * ld + c0 + (idx % q) * 4 : 0;
      v[j] = ok[j] ? __ldcg(reinterpret_cast<const float4*>(ws + off[j]))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll 4
    for (int z = 1; z < splits; ++z) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ok[j]) {
          const float4 t = __ldcg(reinterpret_cast<const float4*>(ws + z * plane + off[j]));
          v[j].x += t.x;
          v[j].y += t.y;
          v[j].z += t.z;
          v[j].w += t.w;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ok[j]) *reinterpret_cast<float4*>(y + off[j]) = v[j];
  }
}

// The epilogue of the int8 tensor-core GEMMs (w4_mma.cuh, w8_mma.cuh):
// THREADS = 256, 8 warps of 16 weight rows, acc[mt][nt][e] at activation
// row mt*16 + g (+8 for e >= 2) and weight row warp*16 + 8 nt + 2t + (e & 1),
// NP planes of B rows each.  The f32 tile [MP][BN] goes through shared memory (the ring,
// drained), then each batch row's planes are summed in a fixed order
// (plane 0, then plane 1) into y, or into split z's partial when K is
// split; the last block of the column tile then sums the splits in order.
template <int NP, int MT, int BN, int THREADS>
__device__ __forceinline__ void store_planes(uint8_t* smem, const float (&acc)[MT][2][4], int B,
                                             int n, int n0, int warp, int g, int t,
                                             float* __restrict__ y, int splits,
                                             float* __restrict__ ws, int* __restrict__ cnt,
                                             int z) {
  constexpr int O_LD = BN + 4;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(mt * 16 + g + (e >= 2 ? 8 : 0)) * O_LD + warp * 16 + nt * 8 + 2 * t +
             (e & 1)] = acc[mt][nt][e];
  __syncthreads();
  float* out = splits == 1 ? y : ws + (size_t)z * B * n;
  for (int idx = threadIdx.x; idx < B * BN; idx += THREADS) {
    const int b = idx / BN, c = idx % BN;
    if (n0 + c >= n) continue;
    float v = tile[b * O_LD + c];
#pragma unroll
    for (int p = 1; p < NP; ++p) v += tile[(p * B + b) * O_LD + c];
    out[(size_t)b * n + n0 + c] = v;
  }
  if (splits > 1 && split_arrive_last(cnt, blockIdx.x, splits))
    split_sum(ws, y, splits, (size_t)B * n, n, 0, B, n0, min(BN, n - n0));
}
