// Streaming (flash) attention forward for Hopper (sm_90a): online softmax
// over key tiles.
//
// q, k, v (B, L, H, Dh), bf16 or f32, read through their strides (the last
// axis contiguous): the q, k and v that the Prithvi attention hands over are
// views of one (B, L, 3D) Dense output, read in place with no fold, pad or
// copy. Per (b, h) and query row, as the TPU kernel computes it:
//   over key tiles:  s = scale (q k^T) in f32, keys >= L masked out
//                    m' = max(m, rowmax s), p = exp(s - m'), a = exp(m - m')
//                    l = l a + rowsum p,  acc = acc a + p v      all f32
//   o = round_T(acc / max(l, 1e-30))
// written to a contiguous (B, L, H, Dh) output.
//
// Replaces the TPU kernel s2tpu/ops/flash_attention.py::_flash_kernel
// (launched from _flash_forward), which runs one program per (b*h, q-block)
// over a copy of q, k, v folded to (B*H, L_pad, Dh) and padded to the block
// size. Here one block owns (b, h, 64 query rows) and streams 64-key tiles
// of K and V through shared memory; the ragged key tile is masked and the
// ragged query tile is not written. The backward pass has no kernel, as on
// the TPU: it differentiates the plain attention.
//
// bf16 (the training path), on the tensor cores: 4 warps, each owning 16
// query rows whose q fragments stay in registers for the whole key loop.
// K and V tiles are double-buffered in shared memory through cp.async, the
// next tile's copy in flight while the current one computes. s = q k^T is
// mma.sync m16n8k16 with bf16 operands and f32 sums (the products of bf16
// values are exact in f32, so this is the f32 kernel's score up to the order
// of the sum); scale and log2(e) are applied to the f32 score, and the
// online softmax runs in registers with exp2f, each row's max and sum kept
// by the 4 lanes of a quad. p v keeps p in f32 as the TPU kernel does:
// p = p_hi + p_lo with p_hi = bf16(p), p_lo = bf16(p - p_hi), two mma per
// k-step into one f32 accumulator, which carries p to ~16 significant bits
// (an error <= 2^-16 of sum p|v| before the output's bf16 rounding; rounding
// p to bf16 once would be 2^-9, a different function). Shared memory: q and
// two stages of k and v, [64][Dh + 8] bf16 each: 25,600 bytes at Dh = 32.
// Bound: two B H L^2 Dh products at the bf16 tensor-core rate tie with the
// bytes (q, k, v in, o out): 11.5 us each at the T = 3 Prithvi decoder
// (B = 16, L = 589, H = 16, Dh = 32); the p_lo product adds a third.
//
// f32 (held against the CPU in f32; TF32 would round the operands): exact
// f32 products on the CUDA cores, 16 x 16 threads, every product's operands
// in shared memory, 4 x 4 scores and 4 x Dh/16 outputs per thread in
// registers. Bound: operations at 67 TFLOP/s, 170 us at the T = 3 decoder.
// Shared memory per block: q [64][Dh+1], k^T [Dh][65], v [64][Dh+1],
// p [64][65] and three 64-row statistics: 66,560 + 768 bytes at Dh = 64.

#include "attention_mma.cuh"

namespace {

constexpr int kThreads = 256;  // f32: 16 x 16 threads; 4 per query row in the softmax update
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kTileLd = kTile + 1;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, l, h;  // in elements; the last axis is contiguous
};

// f32: q' = q * scale before the product, as _flash_kernel does.
template <int DH>
__global__ void __launch_bounds__(kThreads) flash_attn_fwd_kernel(const float* __restrict__ q,
                                                                  const float* __restrict__ k,
                                                                  const float* __restrict__ v,
                                                                  float* __restrict__ out, Strides sq, Strides sk,
                                                                  Strides sv, int L, int H, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                     // [64][DH + 1], scaled
  float* Kt = Qs + kTile * (DH + 1);    // [DH][65]
  float* Vs = Kt + DH * kTileLd;        // [64][DH + 1]
  float* P = Vs + kTile * (DH + 1);     // [64][65]
  float* m = P + kTile * kTileLd;       // running max
  float* l = m + kTile;                 // running sum
  float* alpha = l + kTile;             // this tile's rescale
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  constexpr int NJ = DH / 16;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  for (int idx = tid; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, row = q0 + r;
    Qs[r * (DH + 1) + d] = row < L ? qb[row * sq.l + d] * scale : 0.f;
  }
  for (int r = tid; r < kTile; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float acc[4][NJ] = {};

  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();
    for (int idx = tid; idx < kTile * DH; idx += kThreads) {
      const int c = idx / DH, d = idx % DH, key = k0 + c;
      const bool ok = key < L;
      Kt[d * kTileLd + c] = ok ? kb[key * sk.l + d] : 0.f;
      Vs[c * (DH + 1) + d] = ok ? vb[key * sv.l + d] : 0.f;
    }
    __syncthreads();

    // s for rows ty + 16 i, keys tx + 16 j.
    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Kt[d * kTileLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(a[i], kv, s[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        P[(ty + 16 * i) * kTileLd + c] = k0 + c < L ? s[i][j] : kNegInf;
      }
    __syncthreads();

    // Online-softmax update: 4 neighbouring threads per row, 16 keys each.
    {
      const int r = tid / 4, part = tid % 4;
      float* row = P + r * kTileLd + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m[r], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v for rows ty + 16 i, d = tx + 16 j.
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = alpha[ty + 16 * i];
    float pv[4][NJ] = {};
    const int nk = min(kTile, L - k0);
    for (int c = 0; c < nk; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kTileLd + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * (DH + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i][j] = fmaf(p[i], vv, pv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = acc[i][j] * a[i] + pv[i][j];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= L) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[(((long long)b * L + row) * H + h) * DH + tx + 16 * j] = acc[i][j] / denom;
  }
}

// bf16: the tensor-core kernel described at the top. grid (ceil(L / 64), H,
// B), 4 warps; warp w owns query rows 16 w.. of the block's 64, and this
// thread rows 16 w + g (i = 0) and + 8 (i = 1) with the 3 other lanes of its
// quad. q, k, v rows must start 16-byte aligned (the wrapper checks).
template <int DH>
__global__ void __launch_bounds__(kMmaThreads, 4)
    flash_attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                              bf16* __restrict__ out, Strides sq, Strides sk, Strides sv, int L, int H,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LD = DH + 8, NK = DH / 16, NJ = DH / 8, TILE = kTile * LD;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE;      // two stages
  bf16* Vs = Ks + 2 * TILE;  // two stages
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (L + kTile - 1) / kTile;
  const float c = scale * kLog2e;  // s * c is the score in log2 units

  cp_async_rows<DH>(Qs, LD, qb, (int)sq.l, 0, q0, kTile, L);
  cp_async_rows<DH>(Ks, LD, kb, (int)sk.l, 0, 0, kTile, L);
  cp_async_rows<DH>(Vs, LD, vb, (int)sv.l, 0, 0, kTile, L);
  cp_async_commit();

  uint32_t qa[NK][4];
  float o[NJ][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sum
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile, stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile into the other stage, freed by the last iteration's barrier
      cp_async_rows<DH>(Ks + (stage ^ 1) * TILE, LD, kb, (int)sk.l, 0, k0 + kTile, kTile, L);
      cp_async_rows<DH>(Vs + (stage ^ 1) * TILE, LD, vb, (int)sv.l, 0, k0 + kTile, kTile, L);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < NK; ++ks) frag_a(qa[ks], Qs, LD, 16 * warp, 16 * ks);
    }
    const bf16* K = Ks + stage * TILE;
    const bf16* V = Vs + stage * TILE;

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
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i] * c);  // in log2 units; finite: every tile holds a key < L
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd][e] *= alpha[e >> 1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(__fmaf_rn(s[j][e], c, -m[e >> 1]));
        l[e >> 1] += s[j][e];
      }
    // o += p v with p = p_hi + p_lo, both bf16, over the tile's 4 k-steps of 16 keys.
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t hi[4], lo[4];
      c_to_a_split(hi, lo, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int jd = 0; jd < NJ; jd += 2) {
        uint32_t bv[2][2];
        frag_b_t_x2(bv, V, LD, 16 * ks, 8 * jd);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          mma_bf16(o[jd + x], hi, bv[x]);
          mma_bf16(o[jd + x], lo, bv[x]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * i;
    if (row >= L) continue;
    bf16* dst = out + (((long long)b * L + row) * H + h) * DH + 2 * t;
#pragma unroll
    for (int jd = 0; jd < NJ; ++jd)
      *reinterpret_cast<uint32_t*>(dst + 8 * jd) = pack_bf16(o[jd][2 * i] * inv, o[jd][2 * i + 1] * inv);
  }
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kTile * (DH + 1) + DH * kTileLd + kTile * kTileLd + 3 * kTile);
}

template <int DH>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * 5 * kTile * (DH + 8);
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk, Strides sv,
                       int B, int L, int H, float scale, cudaStream_t s) {
  auto kernel = flash_attn_fwd_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<DH>());
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem_bytes<DH>(), s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                   static_cast<const float*>(v), static_cast<float*>(out), sq, sk,
                                                   sv, L, H, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk, Strides sv,
                        int B, int L, int H, float scale, cudaStream_t s) {
  auto kernel = flash_attn_fwd_mma_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)mma_smem_bytes<DH>());
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  kernel<<<grid, kMmaThreads, mma_smem_bytes<DH>(), s>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                                          static_cast<const bf16*>(v), static_cast<bf16*>(out), sq,
                                                          sk, sv, L, H, scale);
  return cudaGetLastError();
}

// bf16 rows are copied 16 bytes at a time: each tensor's start and its
// batch, token and head strides must keep every row 16-byte aligned. The
// row copies take the token stride as an int.
bool rows_aligned(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 && st.l % 8 == 0 && st.h % 8 == 0 &&
         st.l < (1LL << 31);
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v (B, L, H, Dh) with element
// strides (b, l, h) each and a contiguous last axis; out (B, L, H, Dh)
// contiguous; dtype 0 = f32, 1 = bf16 (16-byte aligned rows); Dh 32 or 64.
// `scale` is 1/sqrt(Dh) as an f32. Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success);
// cudaErrorInvalidValue for a shape, type or alignment it does not take.
// The caller validates and allocates.
extern "C" int s2_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, long long qb,
                                      long long ql, long long qh, long long kb, long long kl, long long kh,
                                      long long vb, long long vl, long long vh, int B, int L, int H, int Dh,
                                      float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 32) return (int)launch_f32<32>(q, k, v, out, sq, sk, sv, B, L, H, scale, s);
  if (dtype == 0 && Dh == 64) return (int)launch_f32<64>(q, k, v, out, sq, sk, sv, B, L, H, scale, s);
  if (dtype != 1 || !rows_aligned(q, sq) || !rows_aligned(k, sk) || !rows_aligned(v, sv))
    return (int)cudaErrorInvalidValue;
  if (Dh == 32) return (int)launch_bf16<32>(q, k, v, out, sq, sk, sv, B, L, H, scale, s);
  if (Dh == 64) return (int)launch_bf16<64>(q, k, v, out, sq, sk, sv, B, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}
