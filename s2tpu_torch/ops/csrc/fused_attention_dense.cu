// Fused whole-row attention, forward and backward, for Hopper (sm_90a), on
// two layouts of the packed q, k, v (a Layout descriptor: element strides,
// the last axis contiguous; both are read in place, with no transpose):
//
// * dense: qkv (B, L, 3D) row-major as nn.Linear(D, 3D) emits it: along the
//   last axis the q block, then k, then v, each D = H * Dh wide with the
//   heads contiguous. Head h of token i reads q at [i, h*Dh + d], k at
//   [i, D + h*Dh + d] and v at [i, 2D + h*Dh + d]; out, o, dout (B, L, D).
// * head-major: qkv (3, B, H, L, Dh), q, k, v at [0|1|2, b, h, i, d], as the
//   tensor-parallel einsum writes it; out, o, dout (B, H, L, Dh).
//
// dqkv has the layout of qkv. T is the input type (bf16 or f32); every
// product reads T values (exact in f32) and accumulates in f32.
//
// Forward, per (b, h):
//   s  = (q k^T) * scale                        f32, scale = 1/sqrt(Dh)
//   p  = exp(s - rowmax s) / rowsum(exp(...))   f32
//   o  = round_T(round_T(p) v)                  p rounded to T, f32 sums
// Backward, with the saved forward output o and the cotangent do (the
// layout of out):
//   recompute s and p as above; pc = round_T(p)
//   dv = pc^T do,  dp = do v^T (f32),  delta = rowsum(f32(do) f32(o))
//   ds = round_T(p * (dp - delta) * scale)      p is the f32 p
//   dq = ds k,  dk = ds^T q                     f32 sums, each rounded to T
// written into dqkv at the offsets of q, k, v.
//
// Replaces the TPU kernels s2tpu/ops/flash_attention.py::_fused_fwd_dense_kernel
// (launched from _fused_fwd_dense; its _paired variant computes the same
// output) and ::_fused_bwd_dense_kernel (launched from _fused_bwd_dense) on
// the dense layout, and ::_fused_fwd_kernel (_fused_fwd_qkv) and
// ::_fused_bwd_kernel (_fused_bwd_qkv) on the head-major layout: the same
// math, the same kernels, other strides. Those run one program per batch
// element with the whole (L, L) score matrix of each head in VMEM. Hopper
// blocks have at most 227 KB of shared memory and run in no order, so the
// work is cut differently, and by the input type:
//
// * bf16 (the training path): every product on the tensor cores,
//   mma.sync.m16n8k16 with bf16 operands and f32 accumulation, which is the
//   TPU kernel's rounding (bf16 products are exact in f32). In the forward
//   each warp owns 16 query rows at a time, their q in registers, and passes
//   over the keys twice: first each row's max and sum, then p = exp(s - m) /
//   l in f32 (as exp2 of one FMA in log2 units, times 1/l), rounded to bf16
//   straight into the A operand of p v. No score rows leave the registers.
//   For L <= 256 a block owns (b, h, 128 query rows) with the whole of k and
//   v resident in shared memory, as the TPU kernel holds a whole sequence;
//   for longer L a block owns (b, h, 64 query rows) and k and v stream
//   through two cp.async stages. The ragged edges are cut to 16 rows and 16
//   keys.
// * f32: exact f32 products, which the tensor cores do not offer (TF32
//   would round the operands), as register-blocked f32 FMAs on the CUDA
//   cores. The forward block owns (b, h, 32 query rows) and keeps their f32
//   score rows in shared memory (131 KB at L = 1024) for the softmax.
// * Backward, both types, FlashAttention-2 split, no atomics; each sum runs
//   in a fixed order, so every run gives the same bits.
//   - bf16, two launches: one block per (b, h, 64 query rows) forms delta,
//     sweeps the keys once for each row's max and sum, writes (m, 1/l,
//     delta) to an f32 scratch and sweeps them again for dq; then one block
//     per (b, h, 64 keys) streams the query tiles with their statistics and
//     accumulates dk and dv. Streamed tiles are double-buffered through
//     cp.async; q / do (launch 1) and k / v (launch 2) stay in registers as
//     mma operands, and the score tiles never leave them.
//   - f32, three launches: a statistics pass (the forward's first half)
//     writes each row's max m, sum l and delta; then dk/dv blocks and dq
//     blocks as above, with every tile copied synchronously. Every score is
//     formed by the same operations in all three kernels, so the backward
//     recomputes the forward's p bit for bit.
//
// Shared memory per block at Dh = 64: bf16 forward 46,080 bytes at L = 148
// (k and v resident; at most 73,728, at L = 256) and 46,080 streamed (L >
// 256), backward dq 55,552 and dk/dv 56,832, none growing with L; f32
// forward 156,160 at L = 1024, dk/dv 100,608, dq 83,968.
//
// Bound (either layout: the same bytes): for the T = 1 Prithvi decoder
// (B = 64, L = 197, H = 16, Dh = 32, bf16) the least time is set by bytes
// (qkv in, o out: 15.4 us forward; qkv, o, do in, dqkv out: 30.8 us
// backward) against 5.1 / 12.9 us of
// tensor-core operations. In f32 the operations bound it (67 TFLOP/s:
// 76 / 190 us). What keeps these kernels from their bound: scores are
// recomputed (the forward forms 3 products of L^2 Dh where 2 are needed,
// and an exp2 per score in each of its two sweeps; the backward 8 where 5
// are needed: q k^T three times, do v^T twice), each (b, h) re-reads its k
// and v from L2 once per query tile, and the f32 kernels copy each tile to
// shared memory and then use it, with no copy in flight behind the
// products. The bf16 kernels keep the next tile's copy in flight (or, in the
// forward at L <= 256, copy k and v once with one barrier), and the bf16
// forward cuts the ragged tiles to 16-key groups and 16-row slices: at
// L = 197 it forms 208 x 208 scores per (b, h) where whole 64-tiles would
// form 256 x 256.

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMaxLen = 1024;  // the longest sequence the fused route sends
constexpr int kRows = 32;      // query rows per forward / statistics block
constexpr int kTile = 64;      // keys per streamed tile; rows and keys per backward tile
constexpr int kTileLd = kTile + 1;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where the kernels find a (b, h) slice, in elements: row i of part p (0 q,
// 1 k, 2 v) of head h of batch element b starts at
// b * batch + (p * part + h * head + i * row), with the head's Dh values
// contiguous from there. qkv and dqkv share one layout, out / o / dout the
// other (part unused). Only the batch stride is 64-bit: the entry points take
// tensors of fewer than 2^31 elements, so every other offset fits an int,
// and a kernel keeps one 64-bit base pointer live, not one per part.
struct Layout {
  long long batch;
  int part, head, row;
};

struct Dims {
  int B, L, H;
  float scale;
  Layout qkv, o;
};

// ---------------------------------------------------------------------------
// f32 inputs: exact f32 products on the CUDA cores.
// ---------------------------------------------------------------------------

// Rows [r0, r0 + rows) of one (b, h) slice, row i at base + i * ld + col,
// into smem[r][d] (row stride DH + 1); rows past L read as zeros.
template <int DH>
__device__ __forceinline__ void load_rows(float* smem, const float* base, int ld, int col, int r0, int rows,
                                          int L) {
  for (int idx = threadIdx.x; idx < rows * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, row = r0 + r;
    smem[r * (DH + 1) + d] = row < L ? base[(size_t)row * ld + col + d] : 0.f;
  }
}

// The same rows transposed, into smem[d][r] (row stride kTileLd).
template <int DH>
__device__ __forceinline__ void load_rows_t(float* smem, const float* base, int ld, int col, int r0, int L) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, row = r0 + r;
    smem[d * kTileLd + r] = row < L ? base[(size_t)row * ld + col + d] : 0.f;
  }
}

// Forward (STATS = false) and the backward's statistics pass (STATS = true).
// grid (ceil(L / 32), H, B). Shared: scores [32][ldS], q [32][DH + 1],
// tile max(DH x kTileLd, kTile x (DH + 1)).
template <int DH, bool STATS>
__global__ void __launch_bounds__(kThreads) attn_fused_fwd_kernel(const float* __restrict__ qkv,
                                                                  float* __restrict__ out,
                                                                  const float* __restrict__ o_saved,
                                                                  const float* __restrict__ dout,
                                                                  float* __restrict__ stats, Dims dims) {
  extern __shared__ float smem[];
  const int L = dims.L, ld = dims.qkv.row, P = dims.qkv.part;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hq = h * dims.qkv.head;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int ldS = n_tiles * kTile + 1;
  float* S = smem;
  float* Qs = S + kRows * ldS;
  float* buf = Qs + kRows * (DH + 1);
  const float* base = qkv + (size_t)b * dims.qkv.batch;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_rows<DH>(Qs, base, ld, hq, q0, kRows, L);

  // 1. scores: thread (ty, tx) owns rows ty, ty + 16 and columns tx + 16 j.
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_rows_t<DH>(buf, base, ld, P + hq, t * kTile, L);
    __syncthreads();
    float acc[2][4] = {};
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float a0 = Qs[ty * (DH + 1) + d], a1 = Qs[(ty + 16) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = buf[d * kTileLd + tx + 16 * j];
        acc[0][j] = fmaf(a0, kv, acc[0][j]);
        acc[1][j] = fmaf(a1, kv, acc[1][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      S[ty * ldS + t * kTile + tx + 16 * j] = acc[0][j] * dims.scale;
      S[(ty + 16) * ldS + t * kTile + tx + 16 * j] = acc[1][j] * dims.scale;
    }
  }
  __syncthreads();

  // 2. softmax rows in f32: warp w owns rows w, w + 8, w + 16, w + 24.
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* row = S + r * ldS;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
    l = warp_sum(l);
    const int qi = q0 + r;
    if constexpr (STATS) {
      float delta = 0.f;  // rowsum(do * o) in f32
      if (qi < L) {
        const size_t off = (size_t)b * dims.o.batch + (qi * dims.o.row + h * dims.o.head);
        for (int d = lane; d < DH; d += 32) delta += dout[off + d] * o_saved[off + d];
      }
      delta = warp_sum(delta);
      if (lane == 0 && qi < L) {
        const size_t n = (size_t)dims.B * dims.H * L, i = ((size_t)b * dims.H + h) * L + qi;
        stats[i] = m;
        stats[n + i] = l;
        stats[2 * n + i] = delta;
      }
    } else {
      for (int j = lane; j < L; j += 32) row[j] /= l;
    }
  }
  if constexpr (STATS) return;

  // 3. o = pc v: thread (ty, tx) owns rows ty, ty + 16 and d = tx + 16 j.
  constexpr int NJ = DH / 16;
  float acc[2][NJ] = {};
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_rows<DH>(buf, base, ld, 2 * P + hq, t * kTile, kTile, L);
    __syncthreads();
    const int nk = min(kTile, L - t * kTile);
    for (int c = 0; c < nk; ++c) {
      const float p0 = S[ty * ldS + t * kTile + c], p1 = S[(ty + 16) * ldS + t * kTile + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float v = buf[c * (DH + 1) + tx + 16 * j];
        acc[0][j] = fmaf(p0, v, acc[0][j]);
        acc[1][j] = fmaf(p1, v, acc[1][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= L) continue;
    const size_t off = (size_t)b * dims.o.batch + (qi * dims.o.row + h * dims.o.head);
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[off + tx + 16 * j] = acc[i][j];
  }
}

// Scores, probabilities and ds of one 64 x 64 (query, key) tile, for the
// thread's 4 x 4 entries (rows ty + 16 i, keys tx + 16 j); writes pc (when
// Pc is given) and ds into shared memory. Qs/dOs [64][DH + 1] rows, Kt/Vt
// [DH][kTileLd] keys; m/l/delta the rows' statistics.
template <int DH>
__device__ __forceinline__ void tile_ds(const float* Qs, const float* dOs, const float* Kt, const float* Vt,
                                        const float* m, const float* l, const float* delta, float* Pc,
                                        float* dS, int q0, int k0, int L, float scale) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[4], g[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Qs[(ty + 16 * i) * (DH + 1) + d];
      g[i] = dOs[(ty + 16 * i) * (DH + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float kv = Kt[d * kTileLd + tx + 16 * j], vv = Vt[d * kTileLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = fmaf(a[i], kv, s[i][j]);
        dp[i][j] = fmaf(g[i], vv, dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float p = 0.f, ds = 0.f;
      if (q0 + r < L && k0 + c < L) {
        // __fmul_rn: s * scale rounds before the subtraction, as the
        // forward's stored score does (no contraction into an fma).
        p = expf(__fmul_rn(s[i][j], scale) - m[r]) / l[r];
        ds = p * (dp[i][j] - delta[r]) * scale;
      }
      if (Pc != nullptr) Pc[r * kTileLd + c] = p;
      dS[r * kTileLd + c] = ds;
    }
  }
}

// The rows' statistics from the scratch written by the statistics pass
// (m, l, delta); rows past L get m = 0, l = 1, delta = 0.
__device__ __forceinline__ void load_stats(float* m, float* l, float* delta, const float* stats, Dims dims,
                                           int b, int h, int r0) {
  const size_t n = (size_t)dims.B * dims.H * dims.L;
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = r0 + r;
    const bool ok = row < dims.L;
    const size_t i = ((size_t)b * dims.H + h) * dims.L + row;
    m[r] = ok ? stats[i] : 0.f;
    l[r] = ok ? stats[n + i] : 1.f;
    delta[r] = ok ? stats[2 * n + i] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dk, dv: grid (ceil(L / 64), H, B); one block per 64 keys, looping over all
// query tiles in order.
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kThreads) attn_fused_dkdv_kernel(const float* __restrict__ qkv,
                                                                   const float* __restrict__ dout,
                                                                   const float* __restrict__ stats,
                                                                   float* __restrict__ dqkv, Dims dims) {
  extern __shared__ float smem[];
  const int L = dims.L, ld = dims.qkv.row, P = dims.qkv.part;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hq = h * dims.qkv.head;
  float* Kt = smem;
  float* Vt = Kt + DH * kTileLd;
  float* Qs = Vt + DH * kTileLd;
  float* dOs = Qs + kTile * (DH + 1);
  float* Pc = dOs + kTile * (DH + 1);
  float* dS = Pc + kTile * kTileLd;
  float* m = dS + kTile * kTileLd;
  float* l = m + kTile;
  float* delta = l + kTile;
  const float* base = qkv + (size_t)b * dims.qkv.batch;
  const float* dbase = dout + (size_t)b * dims.o.batch;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int NJ = DH / 16;

  load_rows_t<DH>(Kt, base, ld, P + hq, k0, L);
  load_rows_t<DH>(Vt, base, ld, 2 * P + hq, k0, L);
  float dk[4][NJ] = {}, dv[4][NJ] = {};
  for (int q0 = 0; q0 < L; q0 += kTile) {
    __syncthreads();
    load_rows<DH>(Qs, base, ld, hq, q0, kTile, L);
    load_rows<DH>(dOs, dbase, dims.o.row, h * dims.o.head, q0, kTile, L);
    load_stats(m, l, delta, stats, dims, b, h, q0);
    __syncthreads();
    tile_ds<DH>(Qs, dOs, Kt, Vt, m, l, delta, Pc, dS, q0, k0, L, dims.scale);
    __syncthreads();
    const int nq = min(kTile, L - q0);
    for (int r = 0; r < nq; ++r) {
      float pc[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pc[i] = Pc[r * kTileLd + ty + 16 * i];
        ds[i] = dS[r * kTileLd + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float g = dOs[r * (DH + 1) + tx + 16 * j], q = Qs[r * (DH + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] = fmaf(pc[i], g, dv[i][j]);
          dk[i][j] = fmaf(ds[i], q, dk[i][j]);
        }
      }
    }
  }
  float* obase = dqkv + (size_t)b * dims.qkv.batch;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= L) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      obase[(size_t)key * ld + P + hq + d] = dk[i][j];
      obase[(size_t)key * ld + 2 * P + hq + d] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dq: grid (ceil(L / 64), H, B); one block per 64 query rows, looping over
// all key tiles in order.
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kThreads) attn_fused_dq_kernel(const float* __restrict__ qkv,
                                                                 const float* __restrict__ dout,
                                                                 const float* __restrict__ stats,
                                                                 float* __restrict__ dqkv, Dims dims) {
  extern __shared__ float smem[];
  const int L = dims.L, ld = dims.qkv.row, P = dims.qkv.part;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hq = h * dims.qkv.head;
  float* Kt = smem;
  float* Vt = Kt + DH * kTileLd;
  float* Qs = Vt + DH * kTileLd;
  float* dOs = Qs + kTile * (DH + 1);
  float* dS = dOs + kTile * (DH + 1);
  float* m = dS + kTile * kTileLd;
  float* l = m + kTile;
  float* delta = l + kTile;
  const float* base = qkv + (size_t)b * dims.qkv.batch;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  constexpr int NJ = DH / 16;

  load_rows<DH>(Qs, base, ld, hq, q0, kTile, L);
  load_rows<DH>(dOs, dout + (size_t)b * dims.o.batch, dims.o.row, h * dims.o.head, q0, kTile, L);
  load_stats(m, l, delta, stats, dims, b, h, q0);
  float dq[4][NJ] = {};
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    load_rows_t<DH>(Kt, base, ld, P + hq, k0, L);
    load_rows_t<DH>(Vt, base, ld, 2 * P + hq, k0, L);
    __syncthreads();
    tile_ds<DH>(Qs, dOs, Kt, Vt, m, l, delta, nullptr, dS, q0, k0, L, dims.scale);
    __syncthreads();
    const int nk = min(kTile, L - k0);
    for (int c = 0; c < nk; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dS[(ty + 16 * i) * kTileLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Kt[(tx + 16 * j) * kTileLd + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(ds[i], kv, dq[i][j]);
      }
    }
  }
  float* obase = dqkv + (size_t)b * dims.qkv.batch;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= L) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) obase[(size_t)qi * ld + hq + tx + 16 * j] = dq[i][j];
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the same algorithm with every product on the tensor cores,
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation (exact products
// of bf16 values summed in f32, as the TPU kernel's MXU dots), through the
// helpers of attention_mma.cuh. Shared tiles are bf16 and row-major as the
// tensors are; the operands a product needs transposed come through
// ldmatrix.trans. Blocks are 4 warps.
// ---------------------------------------------------------------------------

// Every bf16 kernel of this file forms p from a score s (the f32 sum of bf16
// products, unscaled) and its row's statistics by this one formula, in log2
// units: c = scale log2(e), mc the row's max of s c and linv 1 / its sum of
// exp2(s c - mc). One FMA, one exp2f and one multiply per score, no division.
__device__ __forceinline__ float bwd_prob(float s, float c, float mc, float linv) {
  return exp2f(__fmaf_rn(s, c, -mc)) * linv;
}

// The bf16 forward, two kernels on one set of steps. Warp w of a block owns
// 16 query rows at a time (this thread rows r0 + g and + 8, with its quad),
// their q held as A fragments in registers. Two sweeps over the keys,
// because the TPU kernel rounds the normalised p to bf16 before p v: each
// row's max and sum must be known before the first product. Sweep 1
// (fwd_stats_chunk) takes k alone, 64 keys at a time: the scores, their max,
// one rescale of the row's sum, then the sum of exp2(s c - mc) (a reordering
// of the same f32 sum). Sweep 2 (fwd_pv_group) takes k and v, 16 keys at a
// time: s = q k^T, p by bwd_prob, rounded to bf16 straight into the A
// operand of o += p v. No score leaves the registers. The ragged edges are
// cut to 16 keys and 16 rows: the last chunk runs only the 16-key groups
// that hold a key below L and masks only the group that straddles L (its
// zero rows past L would give exp2(-mc), which overflows for mc < -128); a
// 16-row slice wholly at or past L is never computed. Rows and keys past L
// are zero-filled by cp.async.
//
// Registers set how many blocks an SM holds, so both kernels ask for 5
// (Dh = 32, <= 96 registers) and 4 (Dh = 64, <= 128): left free, ptxas has
// taken 106 at Dh = 32, one block fewer per SM and 12 % slower at the T = 1
// decoder (chip_smoke, H100). What bounds them then is instruction issue and
// latency, not bytes: three L^2 Dh products on mma.sync where two are
// needed, and two exp2f per score.

// Sweep 1 over one chunk of up to 64 keys from key k0 (row 0 of K): folds
// the chunk into this thread's rows' max m (of s c) and its share l of their
// sums of exp2(s c - m).
template <int DH>
__device__ __forceinline__ void fwd_stats_chunk(float (&m)[2], float (&l)[2], const uint32_t (&qa)[DH / 16][4],
                                                const bf16* K, int k0, int L, float c) {
  constexpr int G = kTile / 16;
  const int t = threadIdx.x & 3;
  const int groups = min(G, (L - k0 + 15) / 16);  // 16-key groups with a key below L
  float s[G][2][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kk = 0; kk < G; ++kk) {
    if (kk >= groups) continue;
    mma_scores_reg<DH, 2>(s[kk], qa, K, 16 * kk);
    const int key0 = k0 + 16 * kk + 2 * t;
    const bool ragged = k0 + 16 * kk + 16 > L;  // the group that straddles L
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ragged && key0 + 8 * j + (e & 1) >= L) s[kk][j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[kk][j][e]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * c);
    l[i] *= exp2f(m[i] - m_new);
    m[i] = m_new;
  }
#pragma unroll
  for (int kk = 0; kk < G; ++kk) {
    if (kk >= groups) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(__fmaf_rn(s[kk][j][e], c, -m[e >> 1]));
  }
}

// 1 / each row's sum, from the quad's shares.
__device__ __forceinline__ void fwd_linv(float (&linv)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    linv[i] = 1.f / l[i];
  }
}

// Sweep 2 over one group of 16 keys from key k0 (row 0 of K and V):
// o += round(p) v.
template <int DH>
__device__ __forceinline__ void fwd_pv_group(float (&o)[DH / 8][4], const uint32_t (&qa)[DH / 16][4], const bf16* K,
                                             const bf16* V, int k0, int L, float c, const float (&m)[2],
                                             const float (&linv)[2]) {
  const int t = threadIdx.x & 3;
  float s[2][4];
  mma_scores_reg<DH, 2>(s, qa, K, 0);
  const bool ragged = k0 + 16 > L;  // the group that straddles L
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      s[j][e] = ragged && k0 + 8 * j + 2 * t + (e & 1) >= L ? 0.f : bwd_prob(s[j][e], c, m[i], linv[i]);
    }
  uint32_t a[4];
  c_to_a(a, s[0], s[1]);
#pragma unroll
  for (int jd = 0; jd < DH / 8; jd += 2) {
    uint32_t bv[2][2];
    frag_b_t_x2(bv, V, DH + 8, 0, 8 * jd);
    mma_bf16(o[jd], a, bv[0]);
    mma_bf16(o[jd + 1], a, bv[1]);
  }
}

// This thread's rows r0 + g and + 8 of o, those below L, rounded to bf16.
template <int DH>
__device__ __forceinline__ void fwd_store(bf16* out, const float (&o)[DH / 8][4], const Dims& dims, int b, int h,
                                          int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = r0 + g + 8 * i;
      if (qi < dims.L)
        *reinterpret_cast<uint32_t*>(out + (size_t)b * dims.o.batch + (qi * dims.o.row + h * dims.o.head) + 8 * jd +
                                     2 * t) = pack_bf16(o[jd][2 * i], o[jd][2 * i + 1]);
    }
}

// Forward, bf16, L <= kResidentLen (the T = 1 decoder's 197, the T = 3
// encoder's 148): the TPU kernel's own cut, k and v of the (b, h) resident
// in shared memory. grid (ceil(L / 128), H, B): a block owns 8 slices of 16
// query rows and copies the whole of k and v once (cp.async, zero rows up to
// a multiple of 16), with one barrier; then each warp takes its 2 slices one
// after the other, reading its q fragments from global memory, with no
// further barrier. Shared: k and v, [L rounded up to 16][DH + 8] bf16 each:
// 33,280 bytes at L = 197, Dh = 32 (5 blocks an SM: 166,400), 46,080 at
// L = 148, Dh = 64 (4: 184,320), at most 73,728 (L = 256, Dh = 64: 3 blocks
// an SM). Against the tiled kernel below at L <= 256, no tile barriers and
// k read from L2 once instead of twice: 17 % faster at the T = 1 decoder
// (chip_smoke --attention, H100).
constexpr int kResidentLen = 256;
constexpr int kResidentSlices = 8;  // 16-row query slices per block
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, DH == 32 ? 5 : 4)
    attn_fused_fwd_mma_resident_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, Dims dims) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 8, NK = DH / 16;
  const int L = dims.L, ld = dims.qkv.row, P = dims.qkv.part, Lp = (L + 15) & ~15;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hq = h * dims.qkv.head;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + Lp * LD;
  const bf16* base = qkv + (size_t)b * dims.qkv.batch;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float c = dims.scale * kLog2e;
  cp_async_rows<DH>(Ks, LD, base, ld, P + hq, 0, Lp, L);
  cp_async_rows<DH>(Vs, LD, base, ld, 2 * P + hq, 0, Lp, L);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int first = blockIdx.x * kResidentSlices, last = min(first + kResidentSlices, Lp / 16);
  for (int slice = first + warp; slice < last; slice += kMmaThreads / 32) {
    const int r0 = 16 * slice;
    uint32_t qa[NK][4];  // frag_a's layout, rows past L as zeros
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = r0 + g + 8 * (x & 1), col = 16 * ks + 2 * t + 8 * (x >> 1);
        qa[ks][x] = row < L ? *reinterpret_cast<const uint32_t*>(base + (size_t)row * ld + hq + col) : 0u;
      }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, linv[2];
    for (int k0 = 0; k0 < L; k0 += kTile) fwd_stats_chunk<DH>(m, l, qa, Ks + k0 * LD, k0, L, c);
    fwd_linv(linv, l);
    float o[DH / 8][4] = {};
    for (int k0 = 0; k0 < L; k0 += 16) fwd_pv_group<DH>(o, qa, Ks + k0 * LD, Vs + k0 * LD, k0, L, c, m, linv);
    fwd_store<DH>(out, o, dims, b, h, r0);
  }
}

// Forward, bf16, kResidentLen < L <= 1024 (the route's long edges). grid
// (ceil(L / 64), H, B); warp w owns query rows 16 w.. of the block's 64. k
// and v stream through shared memory in 64-key tiles, each double-buffered
// through cp.async, the next tile's copy in flight behind the products (q
// and the first k tile copy together); a barrier pair per tile. A warp
// whose 16 rows all lie at or past L takes part in the copies and barriers
// and in nothing else. Shared: q and two stages of k and v, [64][DH + 8]
// bf16 each: 25,600 bytes at Dh = 32 and 46,080 at Dh = 64, independent of
// L (5 and 4 blocks an SM: 128,000 and 184,320 bytes).
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, DH == 32 ? 5 : 4)
    attn_fused_fwd_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, Dims dims) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 8, NK = DH / 16, TILE = kTile * LD;
  const int L = dims.L, ld = dims.qkv.row, P = dims.qkv.part;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hq = h * dims.qkv.head;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;      // two stages
  bf16* Vs = Ks + 2 * TILE;  // two stages
  const bf16* base = qkv + (size_t)b * dims.qkv.batch;
  const int warp = threadIdx.x >> 5;
  const int n_tiles = (L + kTile - 1) / kTile, n_steps = 2 * n_tiles;
  const float c = dims.scale * kLog2e;
  const bool active = q0 + 16 * warp < L;  // this warp owns a row below L

  // Step j < n_tiles copies key tile j (sweep 1), step n_tiles + j key and
  // value tile j (sweep 2), into stage j & 1; always one commit group.
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int k0 = (step < n_tiles ? step : step - n_tiles) * kTile, stage = step & 1;
      cp_async_rows<DH>(Ks + stage * TILE, LD, base, ld, P + hq, k0, kTile, L);
      if (step >= n_tiles) cp_async_rows<DH>(Vs + stage * TILE, LD, base, ld, 2 * P + hq, k0, kTile, L);
    }
    cp_async_commit();
  };
  cp_async_rows<DH>(Qs, LD, base, ld, hq, q0, kTile, L);
  load_step(0);

  uint32_t qa[NK][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, linv[2];
  for (int step = 0; step < n_tiles; ++step) {
    load_step(step + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      if (step == 0) {
#pragma unroll
        for (int ks = 0; ks < NK; ++ks) frag_a(qa[ks], Qs, LD, 16 * warp, 16 * ks);
      }
      fwd_stats_chunk<DH>(m, l, qa, Ks + (step & 1) * TILE, step * kTile, L, c);
    }
    __syncthreads();  // this stage is refilled by the next step's copy
  }
  fwd_linv(linv, l);

  float o[DH / 8][4] = {};
  for (int step = n_tiles; step < n_steps; ++step) {
    load_step(step + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const int stage = step & 1, k0 = (step - n_tiles) * kTile, groups = min(kTile / 16, (L - k0 + 15) / 16);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        if (kk < groups)
          fwd_pv_group<DH>(o, qa, Ks + stage * TILE + 16 * kk * LD, Vs + stage * TILE + 16 * kk * LD, k0 + 16 * kk,
                           L, c, m, linv);
    }
    __syncthreads();  // this stage is refilled by the next step's copy
  }
  if (active) fwd_store<DH>(out, o, dims, b, h, q0 + 16 * warp);
}

// Backward, bf16: two launches, FlashAttention-2's split, no atomics. Both
// form p by bwd_prob. Launch 1 computes each row's statistics (mc, 1/l) and
// writes them; launch 2 reads them. Both sum the same exact
// products in the same k-steps (q k^T in launch 1, k q^T in launch 2, one
// operand order each); nothing depends on the two giving the same bits, and
// each launch's sums run in a fixed order, so a repeat gives the same dqkv.

// Backward launch 1 of 2, bf16: dq and the rows' statistics. grid
// (ceil(L / 64), H, B); warp w owns query rows 16 w.. of the block's 64 (this
// thread rows 16 w + g and + 8, with its quad). The q and do tiles are
// copied once (cp.async) and held as A fragments in registers; while they
// copy, delta = rowsum(do o) of the block's rows is formed from 16-byte loads,
// DH / 8 lanes a row and a shuffle tree. The keys are swept twice, each tile
// double-buffered through cp.async (the next one's copy in flight behind the
// products): first k alone, for each row's max and sum (online, in log2
// units), written with delta to `stats` as (mc, 1/l, delta); then k and v,
// 16 keys at a time: s = q k^T, dp = do v^T, p, ds = round(p (dp - delta)
// scale) straight into the A operand of dq += ds k. Per-row values live in
// registers. Shared: q, do and two stages of k and v [64][DH + 8] bf16 and
// delta [64] f32: 55,552 bytes at Dh = 64.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 4)
    attn_fused_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ o_saved,
                             const bf16* __restrict__ dout, float* __restrict__ stats, bf16* __restrict__ dqkv,
                             Dims dims) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 8, NK = DH / 16, NJ = DH / 8, CH = DH / 8, TILE = kTile * LD;
  const int L = dims.L, ld = dims.qkv.row, P = dims.qkv.part;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hq = h * dims.qkv.head;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;     // two stages
  bf16* Vs = Ks + 2 * TILE;  // two stages
  float* delta_s = reinterpret_cast<float*>(Vs + 2 * TILE);
  const bf16* base = qkv + (size_t)b * dims.qkv.batch;
  const size_t ooff = (size_t)b * dims.o.batch + h * dims.o.head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (L + kTile - 1) / kTile, n_steps = 2 * n_tiles;
  const float scale = dims.scale, c = scale * kLog2e;

  // Step j < n_tiles copies key tile j (statistics), step n_tiles + j key
  // and value tile j (dq), into stage j & 1; always one commit group.
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int k0 = (step < n_tiles ? step : step - n_tiles) * kTile, stage = step & 1;
      cp_async_rows<DH>(Ks + stage * TILE, LD, base, ld, P + hq, k0, kTile, L);
      if (step >= n_tiles) cp_async_rows<DH>(Vs + stage * TILE, LD, base, ld, 2 * P + hq, k0, kTile, L);
    }
    cp_async_commit();
  };
  cp_async_rows<DH>(Qs, LD, base, ld, hq, q0, kTile, L);
  cp_async_rows<DH>(dOs, LD, dout + ooff, dims.o.row, 0, q0, kTile, L);
  load_step(0);

  for (int idx = threadIdx.x; idx < kTile * CH; idx += kMmaThreads) {
    const int r = idx / CH, w = idx % CH, row = q0 + r;
    float part = 0.f;
    if (row < L) {
      const size_t off = ooff + (size_t)row * dims.o.row + 8 * w;
      const uint4 x = *reinterpret_cast<const uint4*>(dout + off);
      const uint4 y = *reinterpret_cast<const uint4*>(o_saved + off);
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 u = __bfloat1622float2(xa[e]), v = __bfloat1622float2(ya[e]);
        part += u.x * v.x + u.y * v.y;
      }
    }
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (w == 0) delta_s[r] = part;
  }

  uint32_t qa[NK][4], da[NK][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, linv[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  float dq[NJ][4] = {};
  for (int step = 0; step < n_steps; ++step) {
    load_step(step + 1);
    cp_async_wait<1>();
    __syncthreads();
    const int stage = step & 1;
    const bf16* K = Ks + stage * TILE;
    if (step == 0) {
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        frag_a(qa[ks], Qs, LD, 16 * warp, 16 * ks);
        frag_a(da[ks], dOs, LD, 16 * warp, 16 * ks);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) delta[i] = delta_s[16 * warp + g + 8 * i];
    }
    if (step < n_tiles) {
      const int k0 = step * kTile;
      float s[8][4];
      mma_scores_reg<DH, 8>(s, qa, K, 0);
      if (k0 + kTile > L) {  // the ragged last tile: keys >= L out of the max and the sum
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) >= L) s[j][e] = -INFINITY;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * c);  // in log2 units
        l[i] *= exp2f(m[i] - m_new);
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(__fmaf_rn(s[j][e], c, -m[e >> 1]));
      if (step == n_tiles - 1) {
        const size_t n = (size_t)dims.B * dims.H * L;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
          linv[i] = 1.f / l[i];
          const int qi = q0 + 16 * warp + g + 8 * i;
          if (t == 0 && qi < L) {
            const size_t idx = ((size_t)b * dims.H + h) * L + qi;
            stats[idx] = m[i];
            stats[n + idx] = linv[i];
            stats[2 * n + idx] = delta[i];
          }
        }
      }
    } else {
      const bf16* V = Vs + stage * TILE;
      const int k0 = (step - n_tiles) * kTile;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        float s[2][4], ds[2][4];
        mma_scores_reg<DH, 2>(s, qa, K, 16 * kk);
        mma_scores_reg<DH, 2>(ds, da, V, 16 * kk);
        const bool ragged = k0 + 16 * kk + 16 > L;  // keys >= L: p = 0 (their k rows are zeros anyway)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const bool out = ragged && k0 + 16 * kk + 8 * j + 2 * t + (e & 1) >= L;
            const float p = out ? 0.f : bwd_prob(s[j][e], c, m[i], linv[i]);
            ds[j][e] = p * (ds[j][e] - delta[i]) * scale;
          }
        uint32_t a[4];
        c_to_a(a, ds[0], ds[1]);
#pragma unroll
        for (int jd = 0; jd < NJ; ++jd) {
          uint32_t bk[2];
          frag_b_t(bk, K, LD, 16 * kk, 8 * jd);
          mma_bf16(dq[jd], a, bk);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next step's copy
  }
  bf16* obase = dqkv + (size_t)b * dims.qkv.batch;
#pragma unroll
  for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + 16 * warp + g + 8 * i;
      if (qi < L)
        *reinterpret_cast<uint32_t*>(obase + (size_t)qi * ld + hq + 8 * jd + 2 * t) =
            pack_bf16(dq[jd][2 * i], dq[jd][2 * i + 1]);
    }
}

// Backward launch 2 of 2, bf16: dk and dv. grid (ceil(L / 64), H, B); warp w
// owns keys 16 w.. of the block's 64 (this thread keys 16 w + g and + 8),
// their k and v rows held as A fragments in registers. The query tiles,
// their do tiles and their rows' statistics stream through two cp.async
// stages. Per 16 queries the warp forms the transposed tiles s^T = k q^T and
// dp^T = v do^T, then p^T and ds^T by launch 1's formula, and feeds them,
// rounded to bf16, straight into the A operands of dv += pc^T do and
// dk += ds^T q: no score tile goes through shared memory. Query rows past L
// read as zeros with 1/l = 0, so their p is 0. Shared: k, v and two stages
// of q and do [64][DH + 8] bf16 and of the statistics [3][64] f32: 56,832
// bytes at Dh = 64.
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, DH == 32 ? 4 : 3)
    attn_fused_bwd_dkdv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                               const float* __restrict__ stats, bf16* __restrict__ dqkv, Dims dims) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 8, NK = DH / 16, NJ = DH / 8, TILE = kTile * LD;
  const int L = dims.L, ld = dims.qkv.row, P = dims.qkv.part;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hq = h * dims.qkv.head;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;       // two stages
  bf16* dOs = Qs + 2 * TILE;  // two stages
  float* St = reinterpret_cast<float*>(dOs + 2 * TILE);  // two stages of (mc, 1/l, delta) x 64 rows
  const bf16* base = qkv + (size_t)b * dims.qkv.batch;
  const bf16* dbase = dout + (size_t)b * dims.o.batch + h * dims.o.head;
  const size_t n = (size_t)dims.B * dims.H * L;
  const float* srow = stats + ((size_t)b * dims.H + h) * L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_tiles = (L + kTile - 1) / kTile;
  const float scale = dims.scale, c = scale * kLog2e;

  // Query tile j and its statistics into stage j & 1; always one commit group.
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      const int q0 = j * kTile, stage = j & 1;
      cp_async_rows<DH>(Qs + stage * TILE, LD, base, ld, hq, q0, kTile, L);
      cp_async_rows<DH>(dOs + stage * TILE, LD, dbase, dims.o.row, 0, q0, kTile, L);
      for (int idx = threadIdx.x; idx < 3 * kTile; idx += kMmaThreads) {
        const int part = idx / kTile, r = idx % kTile;
        const bool ok = q0 + r < L;
        cp_async4(St + (3 * stage + part) * kTile + r, ok ? srow + part * n + q0 + r : srow, ok);
      }
    }
    cp_async_commit();
  };
  cp_async_rows<DH>(Ks, LD, base, ld, P + hq, k0, kTile, L);
  cp_async_rows<DH>(Vs, LD, base, ld, 2 * P + hq, k0, kTile, L);
  load_tile(0);

  uint32_t ka[NK][4], va[NK][4];
  float dk[NJ][4] = {}, dv[NJ][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    load_tile(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) {
        frag_a(ka[ks], Ks, LD, 16 * warp, 16 * ks);
        frag_a(va[ks], Vs, LD, 16 * warp, 16 * ks);
      }
    }
    const int stage = it & 1;
    const bf16* Q = Qs + stage * TILE;
    const bf16* dO = dOs + stage * TILE;
    const float* mrow = St + 3 * stage * kTile;
    const float* lrow = mrow + kTile;
    const float* drow = lrow + kTile;
#pragma unroll
    for (int kq = 0; kq < kTile / 16; ++kq) {
      float s[2][4], ds[2][4];
      mma_scores_reg<DH, 2>(s, ka, Q, 16 * kq);
      mma_scores_reg<DH, 2>(ds, va, dO, 16 * kq);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * kq + 8 * j + 2 * t;  // this lane's queries col, col + 1
        const float2 mc = *reinterpret_cast<const float2*>(mrow + col);
        const float2 li = *reinterpret_cast<const float2*>(lrow + col);
        const float2 de = *reinterpret_cast<const float2*>(drow + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool y = e & 1;
          const float p = bwd_prob(s[j][e], c, y ? mc.y : mc.x, y ? li.y : li.x);
          s[j][e] = p;
          ds[j][e] = p * (ds[j][e] - (y ? de.y : de.x)) * scale;
        }
      }
      uint32_t ap[4], as[4];
      c_to_a(ap, s[0], s[1]);
      c_to_a(as, ds[0], ds[1]);
#pragma unroll
      for (int jd = 0; jd < NJ; jd += 2) {
        uint32_t bo[2][2], bq[2][2];
        frag_b_t_x2(bo, dO, LD, 16 * kq, 8 * jd);
        frag_b_t_x2(bq, Q, LD, 16 * kq, 8 * jd);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          mma_bf16(dv[jd + x], ap, bo[x]);
          mma_bf16(dk[jd + x], as, bq[x]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }
  bf16* obase = dqkv + (size_t)b * dims.qkv.batch;
#pragma unroll
  for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + 16 * warp + g + 8 * i;
      if (key >= L) continue;
      const size_t off = (size_t)key * ld + hq + 8 * jd + 2 * t;
      *reinterpret_cast<uint32_t*>(obase + off + P) = pack_bf16(dk[jd][2 * i], dk[jd][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(obase + off + 2 * P) = pack_bf16(dv[jd][2 * i], dv[jd][2 * i + 1]);
    }
}

template <int DH>
size_t fwd_smem(int L) {
  const int n_tiles = (L + kTile - 1) / kTile;
  const int tile = DH * kTileLd > kTile * (DH + 1) ? DH * kTileLd : kTile * (DH + 1);
  return sizeof(float) * ((size_t)kRows * (n_tiles * kTile + 1) + kRows * (DH + 1) + tile);
}

template <int DH>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * DH * kTileLd + 2 * kTile * (DH + 1) + 2 * kTile * kTileLd + 3 * kTile);
}

template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * DH * kTileLd + 2 * kTile * (DH + 1) + kTile * kTileLd + 3 * kTile);
}

// Raise the kernel's dynamic shared-memory limit to what this launch needs.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DH>
cudaError_t forward(const void* qkv, void* out, Dims dims, cudaStream_t s) {
  const dim3 grid((dims.L + kRows - 1) / kRows, dims.H, dims.B);
  const size_t smem = fwd_smem<DH>(dims.L);
  auto kernel = attn_fused_fwd_kernel<DH, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const float*>(qkv), static_cast<float*>(out), nullptr, nullptr,
                                      nullptr, dims);
  return cudaGetLastError();
}

template <int DH>
cudaError_t backward(const void* qkv, const void* o, const void* dout, void* dqkv, void* stats, Dims dims,
                     cudaStream_t s) {
  const float* q = static_cast<const float*>(qkv);
  const float* g = static_cast<const float*>(dout);
  float* st = static_cast<float*>(stats);
  float* dq = static_cast<float*>(dqkv);
  const size_t smem0 = fwd_smem<DH>(dims.L);
  auto k0 = attn_fused_fwd_kernel<DH, true>;
  cudaError_t err = allow_smem(k0, smem0);
  if (err != cudaSuccess) return err;
  k0<<<dim3((dims.L + kRows - 1) / kRows, dims.H, dims.B), kThreads, smem0, s>>>(
      q, nullptr, static_cast<const float*>(o), g, st, dims);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((dims.L + kTile - 1) / kTile, dims.H, dims.B);
  auto k1 = attn_fused_dkdv_kernel<DH>;
  if ((err = allow_smem(k1, dkdv_smem<DH>())) != cudaSuccess) return err;
  k1<<<grid, kThreads, dkdv_smem<DH>(), s>>>(q, g, st, dq, dims);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto k2 = attn_fused_dq_kernel<DH>;
  if ((err = allow_smem(k2, dq_smem<DH>())) != cudaSuccess) return err;
  k2<<<grid, kThreads, dq_smem<DH>(), s>>>(q, g, st, dq, dims);
  return cudaGetLastError();
}

template <int DH>
constexpr size_t fwd_mma_smem() {
  return sizeof(bf16) * 5 * kTile * (DH + 8);
}

template <int DH>
constexpr size_t fwd_resident_smem(int L) {
  return sizeof(bf16) * 2 * ((L + 15) & ~15) * (DH + 8);
}

template <int DH>
constexpr size_t bwd_dq_smem() {
  return sizeof(bf16) * 6 * kTile * (DH + 8) + sizeof(float) * kTile;
}

template <int DH>
constexpr size_t bwd_dkdv_smem() {
  return sizeof(bf16) * 6 * kTile * (DH + 8) + sizeof(float) * 6 * kTile;
}

// One launch: k and v resident for L <= kResidentLen, else streamed.
template <int DH>
cudaError_t forward_mma(const void* qkv, void* out, Dims dims, cudaStream_t s) {
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  cudaError_t err;
  if (dims.L <= kResidentLen) {
    auto kernel = attn_fused_fwd_mma_resident_kernel<DH>;
    if ((err = allow_smem(kernel, fwd_resident_smem<DH>(kResidentLen))) != cudaSuccess) return err;
    const int blocks = (dims.L + 16 * kResidentSlices - 1) / (16 * kResidentSlices);
    kernel<<<dim3(blocks, dims.H, dims.B), kMmaThreads, fwd_resident_smem<DH>(dims.L), s>>>(in, o, dims);
    return cudaGetLastError();
  }
  auto kernel = attn_fused_fwd_mma_kernel<DH>;
  if ((err = allow_smem(kernel, fwd_mma_smem<DH>())) != cudaSuccess) return err;
  kernel<<<dim3((dims.L + kTile - 1) / kTile, dims.H, dims.B), kMmaThreads, fwd_mma_smem<DH>(), s>>>(in, o, dims);
  return cudaGetLastError();
}

// Two launches on one stream: dq with the statistics, then dk and dv.
template <int DH>
cudaError_t backward_mma(const void* qkv, const void* o, const void* dout, void* dqkv, void* stats, Dims dims,
                         cudaStream_t s) {
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  float* st = static_cast<float*>(stats);
  bf16* dq = static_cast<bf16*>(dqkv);
  const dim3 grid((dims.L + kTile - 1) / kTile, dims.H, dims.B);
  auto k1 = attn_fused_bwd_dq_kernel<DH>;
  cudaError_t err = allow_smem(k1, bwd_dq_smem<DH>());
  if (err != cudaSuccess) return err;
  k1<<<grid, kMmaThreads, bwd_dq_smem<DH>(), s>>>(q, static_cast<const bf16*>(o), g, st, dq, dims);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto k2 = attn_fused_bwd_dkdv_kernel<DH>;
  if ((err = allow_smem(k2, bwd_dkdv_smem<DH>())) != cudaSuccess) return err;
  k2<<<grid, kMmaThreads, bwd_dkdv_smem<DH>(), s>>>(q, g, st, dq, dims);
  return cudaGetLastError();
}

// The two layouts the entry points take (see the top of the file): qkv
// then out / o / dout strides.
struct Layouts {
  Layout qkv, o;
};

Layouts dense_layout(int L, int H, int Dh) {
  const int D = H * Dh;
  return Layouts{{(long long)L * 3 * D, D, Dh, 3 * D}, {(long long)L * D, 0, Dh, D}};
}

Layouts head_major_layout(int B, int L, int H, int Dh) {
  const int head = L * Dh;
  const int part = (int)((long long)B * H * head);  // valid_shape bounds it below 2^31 / 3
  return Layouts{{(long long)H * head, part, head, Dh}, {(long long)H * head, 0, head, Dh}};
}

// Shapes the kernels take: 1 <= L <= 1024, and qkv below 2^31 elements, so
// every offset but the batch stride fits an int.
bool valid_shape(int B, int L, int H, int Dh) {
  return L >= 1 && L <= kMaxLen && B >= 1 && H >= 1 && 3LL * B * H * L * Dh < (1LL << 31);
}

int launch_forward(const void* qkv, void* out, int B, int L, int H, int Dh, float scale, int dtype, int device,
                   void* stream, Layouts y) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_shape(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  const Dims dims{B, L, H, scale, y.qkv, y.o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 32) return (int)forward<32>(qkv, out, dims, s);
  if (dtype == 0 && Dh == 64) return (int)forward<64>(qkv, out, dims, s);
  if (dtype == 1 && Dh == 32) return (int)forward_mma<32>(qkv, out, dims, s);
  if (dtype == 1 && Dh == 64) return (int)forward_mma<64>(qkv, out, dims, s);
  return (int)cudaErrorInvalidValue;
}

int launch_backward(const void* qkv, const void* o, const void* dout, void* dqkv, void* stats, int B, int L, int H,
                    int Dh, float scale, int dtype, int device, void* stream, Layouts y) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid_shape(B, L, H, Dh)) return (int)cudaErrorInvalidValue;
  const Dims dims{B, L, H, scale, y.qkv, y.o};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 32) return (int)backward<32>(qkv, o, dout, dqkv, stats, dims, s);
  if (dtype == 0 && Dh == 64) return (int)backward<64>(qkv, o, dout, dqkv, stats, dims, s);
  if (dtype == 1 && Dh == 32) return (int)backward_mma<32>(qkv, o, dout, dqkv, stats, dims, s);
  if (dtype == 1 && Dh == 64) return (int)backward_mma<64>(qkv, o, dout, dqkv, stats, dims, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, bound with ctypes: the dense layout (#8/#9: qkv
// (B, L, 3 H Dh), out / o / dout (B, L, H Dh)) and the head-major one
// (#6/#7: qkv (3, B, H, L, Dh), out / o / dout (B, H, L, Dh)), every tensor
// contiguous and 16-byte aligned, dtype 0 = f32, 1 = bf16; Dh 32 or 64;
// 1 <= L <= 1024; qkv below 2^31 elements. `scale` is 1/sqrt(Dh) as an f32.
// The backward writes dqkv (the layout of qkv) and uses `stats`, an f32
// scratch of 3 B H L values.
// Each launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for a shape or
// type it does not take. The caller validates and allocates.
extern "C" int s2_fused_attention_dense_fwd(const void* qkv, void* out, int B, int L, int H, int Dh, float scale,
                                            int dtype, int device, void* stream) {
  return launch_forward(qkv, out, B, L, H, Dh, scale, dtype, device, stream, dense_layout(L, H, Dh));
}

extern "C" int s2_fused_attention_dense_bwd(const void* qkv, const void* o, const void* dout, void* dqkv,
                                            void* stats, int B, int L, int H, int Dh, float scale, int dtype,
                                            int device, void* stream) {
  return launch_backward(qkv, o, dout, dqkv, stats, B, L, H, Dh, scale, dtype, device, stream,
                         dense_layout(L, H, Dh));
}

extern "C" int s2_fused_attention_qkv_fwd(const void* qkv, void* out, int B, int L, int H, int Dh, float scale,
                                          int dtype, int device, void* stream) {
  return launch_forward(qkv, out, B, L, H, Dh, scale, dtype, device, stream, head_major_layout(B, L, H, Dh));
}

extern "C" int s2_fused_attention_qkv_bwd(const void* qkv, const void* o, const void* dout, void* dqkv,
                                          void* stats, int B, int L, int H, int Dh, float scale, int dtype,
                                          int device, void* stream) {
  return launch_backward(qkv, o, dout, dqkv, stats, B, L, H, Dh, scale, dtype, device, stream,
                         head_major_layout(B, L, H, Dh));
}
