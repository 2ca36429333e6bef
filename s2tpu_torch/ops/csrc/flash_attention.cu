// Streaming (flash) attention forward for Hopper (sm_90a): online softmax
// over key tiles, all arithmetic in f32.
//
// q, k, v (B, L, H, Dh) of type T (bf16 or f32), read through their strides
// (the last axis contiguous): the q, k and v that the Prithvi attention
// hands over are views of one (B, L, 3D) Dense output, read in place with
// no fold, pad or copy. Per (b, h) and query row:
//   q' = f32(q) * scale                          scale = 1/sqrt(Dh), before the product
//   over key tiles:  s = q' f32(k)^T, keys >= L -> -1e30
//                    m' = max(m, rowmax s), p = exp(s - m'), a = exp(m - m')
//                    l = l a + rowsum p,  acc = acc a + p f32(v)
//   o = round_T(acc / max(l, 1e-30))
// written to a contiguous (B, L, H, Dh) output.
//
// Replaces the TPU kernel s2tpu/ops/flash_attention.py::_flash_kernel
// (launched from _flash_forward), which runs one program per (b*h, q-block)
// over a copy of q, k, v folded to (B*H, L_pad, Dh) and padded to the block
// size. Here one block owns (b, h, 64 query rows) and streams 64-key tiles
// of K and V through shared memory; the ragged key tile is masked with
// -1e30 and the ragged query tile is not written. The backward pass has no
// kernel, as on the TPU: it differentiates the plain attention.
//
// Bound: operations. The TPU kernel upcasts everything to f32, so the
// products are f32 and the card's rate for them is its 67 TFLOP/s outside
// the tensor cores (the tensor cores take f32 only as TF32, which would
// round the operands). At the T = 3 Prithvi decoder (B = 16, L = 589,
// H = 16, Dh = 32) that is 11.4 GFLOP in 170 us against 11.5 us of bytes.
// The design keeps every product's operands in shared memory, 4 x 4 scores
// and 4 x Dh/16 outputs per thread in registers, and reads q, k, v once per
// query tile from device memory.
//
// Shared memory per block: q [64][Dh+1], k^T [Dh][65], v [64][Dh+1],
// p [64][65] and three 64-row statistics: 66,560 + 768 bytes at Dh = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads; 4 per query row in the softmax update
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kTileLd = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

struct Strides {
  long long b, l, h;  // in elements; the last axis is contiguous
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                         const T* __restrict__ v, T* __restrict__ out,
                                                         Strides sq, Strides sk, Strides sv, int L, int H,
                                                         float scale) {
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  for (int idx = tid; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH, row = q0 + r;
    Qs[r * (DH + 1) + d] = row < L ? to_f32(qb[row * sq.l + d]) * scale : 0.f;
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
      Kt[d * kTileLd + c] = ok ? to_f32(kb[key * sk.l + d]) : 0.f;
      Vs[c * (DH + 1) + d] = ok ? to_f32(vb[key * sv.l + d]) : 0.f;
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
    for (int j = 0; j < NJ; ++j)
      out[(((long long)b * L + row) * H + h) * DH + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kTile * (DH + 1) + DH * kTileLd + kTile * kTileLd + 3 * kTile);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, Strides sq, Strides sk, Strides sv,
                   int B, int L, int H, float scale, cudaStream_t s) {
  auto kernel = flash_attn_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<DH>());
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem_bytes<DH>(), s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                   static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, L,
                                                   H, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. q, k, v (B, L, H, Dh) with element
// strides (b, l, h) each and a contiguous last axis; out (B, L, H, Dh)
// contiguous; dtype 0 = f32, 1 = bf16; Dh 32 or 64. `scale` is 1/sqrt(Dh)
// as an f32. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for a shape or
// type it does not take. The caller validates and allocates.
extern "C" int s2_flash_attention_fwd(const void* q, const void* k, const void* v, void* out, long long qb,
                                      long long ql, long long qh, long long kb, long long kl, long long kh,
                                      long long vb, long long vl, long long vh, int B, int L, int H, int Dh,
                                      float scale, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (L < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Strides sq{qb, ql, qh}, sk{kb, kl, kh}, sv{vb, vl, vh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 32) return (int)launch<float, 32>(q, k, v, out, sq, sk, sv, B, L, H, scale, s);
  if (dtype == 0 && Dh == 64) return (int)launch<float, 64>(q, k, v, out, sq, sk, sv, B, L, H, scale, s);
  if (dtype == 1 && Dh == 32) return (int)launch<__nv_bfloat16, 32>(q, k, v, out, sq, sk, sv, B, L, H, scale, s);
  if (dtype == 1 && Dh == 64) return (int)launch<__nv_bfloat16, 64>(q, k, v, out, sq, sk, sv, B, L, H, scale, s);
  return (int)cudaErrorInvalidValue;
}
