// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_attention.cu: #5; fused_attention_dense.cu: #6-#9): mma.sync
// m16n8k16 with bf16 operands and f32 accumulation, the fragment loads that
// feed it from row-major shared tiles, and row copies into shared memory
// through cp.async. Blocks are kMmaThreads = 4 warps; every
// row copy is a 16-byte piece, so rows start 16-byte aligned in global and
// shared memory (row strides and column offsets multiples of 8 elements).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b over one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The C fragments of columns 0..7 (c0) and 8..15 (c1) of a 16 x 16 tile as
// the A fragment of the same tile, each value rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The A fragments of p_hi = bf16(p) and p_lo = bf16(p - p_hi) for the 16 x 16
// tile whose C fragments are c0 (columns 0..7) and c1 (8..15): p_hi + p_lo
// carries p to ~16 significant bits.
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c0)[4],
                                             const float (&c1)[4]) {
  const float* c[4] = {c0, c0 + 2, c1, c1 + 2};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(c[i][0], c[i][1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(c[i][0] - hf.x, c[i][1] - hf.y);
  }
}

// The A fragment of rows r0..r0+15, columns c0..c0+15 of X (row-major, ld).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* x, int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = x + (r0 + (lane >> 2)) * ld + c0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// The B fragment of Z itself (Z row-major with k along its rows, rows
// starting 16-byte aligned) through ldmatrix.trans, for rows k0..k0+15 and
// columns n0..n0+7.
__device__ __forceinline__ void frag_b_t(uint32_t (&b)[2], const bf16* z, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = z + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// Two B fragments of Y^T in one ldmatrix.x4: b[0] for columns n0..n0+7 (rows
// of Y), b[1] for n0+8..n0+15, both over k0..k0+15 (rows of Y starting
// 16-byte aligned).
__device__ __forceinline__ void frag_b_x2(uint32_t (&b)[2][2], const bf16* y, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  const bf16* p = y + (n0 + (lane & 7) + 8 * (i >> 1)) * ld + k0 + 8 * (i & 1);
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
               : "r"(addr));
}

// Two B fragments in one ldmatrix.x4.trans: b[0] and b[1] as frag_b_t gives
// them for columns n0 and n0 + 8 of Z.
__device__ __forceinline__ void frag_b_t_x2(uint32_t (&b)[2][2], const bf16* z, int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  const bf16* p = z + (k0 + (lane & 7) + 8 * (i & 1)) * ld + n0 + 8 * (i >> 1);
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
               : "r"(addr));
}

// Asynchronous copies (cp.async, sm_80+): the copy runs while the threads go
// on; cp_async_commit() closes a group of the thread's copies and
// cp_async_wait<N>() waits until at most N of its groups are in flight. A
// source size of 0 fills the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) x DH columns from `col` of a (.., ld) bf16 tensor into
// s[r][d] (row stride lds), rows past L as zeros, in 16-byte cp.async copies
// (ld, col and lds are multiples of 8 elements) that stay in flight until
// the caller commits and waits.
template <int DH>
__device__ __forceinline__ void cp_async_rows(bf16* s, int lds, const bf16* g, int ld, int col, int r0, int rows,
                                              int L) {
  for (int idx = threadIdx.x; idx < rows * (DH / 8); idx += kMmaThreads) {
    const int r = idx / (DH / 8), w = idx % (DH / 8), row = r0 + r;
    const bool ok = row < L;
    cp_async16(s + r * lds + 8 * w, ok ? g + (size_t)row * ld + col + 8 * w : g, ok);
  }
}

// Scores (q k^T, unscaled) of 16 query rows whose A fragments are in
// registers (a[ks] for columns 16 ks..) against N8 (even) groups of 8 rows of
// K from row n0: s[j] is the C fragment of keys n0 + 8j...
template <int DH, int N8>
__device__ __forceinline__ void mma_scores_reg(float (&s)[N8][4], const uint32_t (&a)[DH / 16][4], const bf16* K,
                                               int n0) {
#pragma unroll
  for (int j = 0; j < N8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
#pragma unroll
    for (int j = 0; j < N8; j += 2) {
      uint32_t b[2][2];
      frag_b_x2(b, K, DH + 8, n0 + 8 * j, 16 * ks);
      mma_bf16(s[j], a[ks], b[0]);
      mma_bf16(s[j + 1], a[ks], b[1]);
    }
}

}  // namespace
